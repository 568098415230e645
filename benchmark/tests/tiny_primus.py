"""primus_m.train at a size a CPU test run holds (the teacher cell's tiny
store, benchmark/tests/tiny.py, a Primus a few channels wide)."""
import copy

from benchmark.tests.tiny import _load, train_files


def register_tiny_primus(monkeypatch):
    """A Primus trainer at :func:`primus_files`' widths, found by name as
    ``TinyPrimusTrainer`` for the test's duration."""
    from fast_nnunet_tpu_torch.training import primus_trainers as pt

    class TinyPrimusTrainer(pt.nnUNet_Primus_M_Trainer):
        embed_dim, depth, num_heads = 48, 2, 2

    monkeypatch.setattr(pt, "TinyPrimusTrainer", TinyPrimusTrainer,
                        raising=False)


def primus_files():
    """primus_m.train at a CPU size: Primus at embed 48, depth 2, 2 heads of
    24, 8^3 tokens on a 32 x 16 x 16 patch (8 tokens), trained on the
    teacher cell's tiny store (given inline); the trainer is
    :func:`register_tiny_primus`'s."""
    cfg = copy.deepcopy(_load("configs", "primus_m.json"))
    cfg["trainer"] = "TinyPrimusTrainer"
    cfg["store_config"] = train_files()["config"]
    cfg["network"].update(embed_dim=48, depth=2, num_heads=2, head_dim=24,
                          mlp_hidden=128)
    cfg["num_classes"] = 5
    cfg["training"]["patch_size"] = [32, 16, 16]
    traffic = copy.deepcopy(_load("traffic", "primus_train.json"))
    traffic.update(fold="all", trace_iters=2)
    traffic["host_threads"]["loader"] = 2
    return {"cell": {"name": "tiny", "chips": 1}, "config": cfg,
            "traffic": traffic,
            # CPU readings at this size (seeds 31-33): the program's loss
            # gap 2.9e-4-4.1e-4, median-leaf first moment 2.5e-4-4.2e-4,
            # change 3.2e-4-3.7e-4; the float8 control's 2.9e-3, 5.4e-3,
            # 1.3e-2; half batch 6.8e-3, 3.7e-2, 1.7e-2
            "limits": {"loss": {"limit": 1e-3}, "first_grad": {"limit": 2e-3},
                       "change": {"limit": 3e-3}},
            "end_to_end": [{"name": "iter_s", "unit": "s/iter"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": []}
