"""Learning-rate schedules as functions of the step index — the port of
fast_nnunet_tpu/training/schedules.py. The optimizers here evaluate them at
optax's count, the number of updates made before the current one."""
import math


def poly_lr(initial_lr: float, max_steps: int, exponent: float = 0.9):
    def schedule(step):
        frac = min(step, max_steps) / max_steps
        return initial_lr * (1 - frac) ** exponent
    return schedule


def linear_warmup_poly(initial_lr: float, max_steps: int, warmup_steps: int,
                       exponent: float = 0.9):
    """Linear warmup from ~0 to initial_lr, then poly decay over the rest."""
    def schedule(step):
        if step < warmup_steps:
            return initial_lr * (step + 1) / max(warmup_steps, 1)
        frac = min(max((step - warmup_steps)
                       / max(max_steps - warmup_steps, 1), 0.0), 1.0)
        return initial_lr * (1.0 - frac) ** exponent
    return schedule


def linear_warmup_cosine(initial_lr: float, max_steps: int,
                         warmup_steps: int):
    def schedule(step):
        if step < warmup_steps:
            return initial_lr * (step + 1) / max(warmup_steps, 1)
        frac = min(max((step - warmup_steps)
                       / max(max_steps - warmup_steps, 1), 0.0), 1.0)
        return initial_lr * 0.5 * (1.0 + math.cos(math.pi * frac))
    return schedule
