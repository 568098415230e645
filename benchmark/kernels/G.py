"""Kernel G, ``csrc/attention.cu`` via ``ops/attention.py``: Primus's
attention backward, its two passes (``attention_bwd_dq_kernel``, then
``attention_bwd_dkdv_kernel``). FLOPs: ``harness/primus_train.py``, the
five useful products, 10 B H T^2 hd a backward (the passes do 14)."""
SYMBOL = "attention_bwd_"
BOUND = "bf16"
