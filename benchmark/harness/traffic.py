"""The one generator of traffic: it reads a mix's parameters from its data
file (benchmark/traffic/<mix>.json) and draws the work from the seed.

Serving mixes are a cycle of CT studies. The sizes are a fixed set in a
fixed order, the same for every seed (the seed changes the anatomy's
noise and the weights, never the amount of work or where a window's last
partial cycle falls): z extents and in-plane spacings at the midpoints of
``cycle`` equal strata of their ranges, paired by a fixed stride, slice
thicknesses taken in turn from their list, served largest and smallest z
extent in turn, so that any run of consecutive studies holds a balanced
mix."""
import numpy as np


def rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 64)] + list(salt))


def serve_studies(mix: dict):
    """[(shape (nx, ny, nz), spacing (z, y, x) mm)] in serving order."""
    n = int(mix["cycle"])
    zlo, zhi = mix["z_extent_mm"]
    slo, shi = mix["spacing_mm"]
    thick = mix["slice_mm"]
    stride = int(mix.get("pairing_stride", 5))
    studies = []
    for i in range(n):
        z_mm = zlo + (i + 0.5) / n * (zhi - zlo)
        sp = slo + (((stride * i) % n) + 0.5) / n * (shi - slo)
        th = float(thick[i % len(thick)])
        nz = int(round(z_mm / th))
        nxy = int(mix["in_plane"])
        studies.append(((nxy, nxy, nz), (th, sp, sp)))
    order = [i // 2 if i % 2 == 0 else n - 1 - i // 2 for i in range(n)]
    return [studies[i] for i in order]


def phantom_seed(seed: int, i: int) -> int:
    return int(rng(seed, 2, i).integers(0, 2 ** 62))
