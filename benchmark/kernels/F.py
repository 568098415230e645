"""Kernel F, ``csrc/attention.cu`` via ``ops/attention.py``: Primus's
attention forward, fused (QK^T, online softmax, PV). FLOPs:
``harness/primus_train.py`` ``attention_flops``, 4 B H T^2 hd a launch."""
SYMBOL = "attention_fwd_kernel"
BOUND = "bf16"
