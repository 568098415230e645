"""torch.cuda.max_memory_allocated() over the training window, GiB."""


def read(run):
    return run["train_peak_bytes"] / 2 ** 30
