"""Realistic-ish synthetic CT phantom for end-to-end benchmarking (a copy of
fast_nnunet_tpu/utils/synthetic_ct.py; the port imports nothing of the JAX
package).

The reference's headline numbers are end-to-end on real abdominal/chest CTs
(ref docs/Engine.md:31-33); uniform noise volumes cannot exercise air-tile
skipping or HU windowing, so the e2e bench (bench.py --e2e) uses this
HU-distributed phantom: air background (-1000 HU), an elliptical body of soft
tissue (~40 HU), two lung fields (~-800 HU), a spine + rib cage of bone
(300..1500 HU) and a few organ blobs. Everything vectorized numpy; ~1 s for
512x512x450.
"""
from typing import Sequence, Tuple

import numpy as np


def make_synthetic_ct(shape: Sequence[int] = (512, 512, 450),
                      spacing: Sequence[float] = (0.8, 0.8, 1.0),
                      seed: int = 0) -> Tuple[np.ndarray, Tuple[float, ...]]:
    """Returns (volume int16 HU in (x, y, z) index order, spacing)."""
    rng = np.random.RandomState(seed)
    nx, ny, nz = shape
    x = np.linspace(-1, 1, nx, dtype=np.float32)[:, None, None]
    y = np.linspace(-1, 1, ny, dtype=np.float32)[None, :, None]
    z = np.linspace(0, 1, nz, dtype=np.float32)[None, None, :]

    vol = np.full(shape, -1000.0, np.float32)

    # body: ellipse whose radii taper toward head/feet
    rx = 0.72 - 0.15 * np.abs(z - 0.5) * 2
    ry = 0.55 - 0.12 * np.abs(z - 0.5) * 2
    body = (x / rx) ** 2 + (y / ry) ** 2 <= 1.0
    vol[body] = 40.0

    # lungs in the upper 40% of z
    lung_z = (z > 0.55)
    for sx in (-0.3, 0.3):
        lung = (((x - sx) / 0.25) ** 2 + (y / 0.3) ** 2
                + ((z - 0.78) / 0.25) ** 2 <= 1.0) & body & lung_z
        vol[lung] = -800.0

    # spine: posterior bone cylinder + vertebral texture
    spine = ((x / 0.08) ** 2 + ((y - 0.35) / 0.09) ** 2 <= 1.0) & body
    vol[spine] = 700.0 + 400.0 * np.broadcast_to(
        np.sin(z * 60.0), shape)[spine]

    # ribs: thin bone shell bands in the lung region
    shell = (np.abs((x / (rx * 0.92)) ** 2 + (y / (ry * 0.92)) ** 2 - 1.0)
             < 0.08) & body & (z > 0.45)
    band = np.broadcast_to((np.sin(z * 90.0) > 0.3), shape)
    ribs = shell & band
    vol[ribs] = 600.0

    # organ blobs (liver-ish, kidneys-ish)
    for cx, cy, cz, r, hu in ((-0.25, -0.05, 0.45, 0.3, 60.0),
                              (0.22, 0.1, 0.35, 0.12, 35.0),
                              (-0.22, 0.12, 0.35, 0.12, 35.0)):
        blob = (((x - cx) / r) ** 2 + ((y - cy) / (r * 0.8)) ** 2
                + ((z - cz) / (r * 0.7)) ** 2 <= 1.0) & body
        vol[blob] = hu

    # noise everywhere inside the body (CT quantum mottle)
    noise = rng.randn(*shape).astype(np.float32) * 12.0
    vol[body] += noise[body]

    return np.clip(vol, -1024, 3071).astype(np.int16), tuple(spacing)
