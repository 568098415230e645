"""What bounds kernel C (fast_nnunet_tpu_torch/csrc/s2d_accumulate.cu) on the
card: the kernel library is built again with one part of kernel C switched
off at a time (its FNN_ABLATE_* macros) and each build is timed beside the
full kernel at the s2d main path's shapes and tile layout (accumulator
(48, 256, 112, 488), features (8, 128, 48, 48, 80) bf16, the 8 live tiles of
a full batch of the 512 x 512 x 500 CT: 4 y-starts 23 rows apart times
z-starts 0 and 23), on seeded synthetic inputs. The switched-off builds
compute wrong values; only their times mean something. Needs an NVIDIA GPU
and nvcc; from the repository root:

    python tools/ablate_s2d_accumulate.py

Prints the card, then one JSON line {"acc": dtype, variant: ms, ...} per
accumulator dtype. Variants:

- ``full``: the kernel as it ships;
- ``no_memory``: features and gaussian replaced by register values, no
  accumulator pieces copied in or out (the math and the step machinery);
- ``no_math``: the head dot and the accumulator update skipped (data
  movement and the step machinery);
- ``no_epilogue``: the accumulator update replaced by one plain add;
- ``machinery``: no memory traffic and no math (steps, barriers, staging);
- ``unfused``: the full kernel with the head weights passed as f32, so it
  takes its unfused instance (separate multiply and add).
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from fast_nnunet_tpu_torch.ops import _build  # noqa: E402
from fast_nnunet_tpu_torch.ops import s2d_accumulate as kc  # noqa: E402

VARIANTS = {
    "full": (),
    "no_memory": ("FNN_ABLATE_MEMORY=1",),
    "no_math": ("FNN_ABLATE_MATH=1",),
    "no_epilogue": ("FNN_ABLATE_EPILOGUE=1",),
    "machinery": ("FNN_ABLATE_MEMORY=1", "FNN_ABLATE_MATH=1"),
}


def _time_ms(fn, n=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    acc0 = torch.randn(48, 256, 112, 488, device=dev, generator=gen) * 3
    feats = torch.randn(8, 128, 48, 48, 80, device=dev,
                        generator=gen).bfloat16()
    g = torch.rand(48, 48, 80, 8, device=dev, generator=gen) * 10
    w = (torch.randn(8, 16, 61, device=dev, generator=gen) * 0.3).bfloat16()
    b = (torch.randn(488, device=dev, generator=gen) * 0.1).bfloat16().float()
    coords = np.array([[y, z] for y in (92, 115, 138, 162) for z in (0, 23)],
                      np.int32)
    valid = np.ones(8, np.float32)
    times = {"bfloat16": {}, "float32": {}}
    runs = [(name, _build.library(defines), w)
            for name, defines in VARIANTS.items()]
    runs.append(("unfused", _build.library(), w.float()))
    for name, lib, weights in runs:
        for mode in times:
            acc = acc0.to(getattr(torch, mode))
            times[mode][name] = _time_ms(lambda: kc.launch_kernel(
                lib, acc, feats, g, weights, b, coords, valid, 5))
            del acc
    for mode, row in times.items():
        print(json.dumps({"acc": mode, **row}))


if __name__ == "__main__":
    main()
