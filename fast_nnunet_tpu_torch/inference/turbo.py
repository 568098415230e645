"""TurboPipeline — end-to-end serving on the card (read -> preprocess ->
s2d sweep -> revert -> write): the port of
fast_nnunet_tpu/inference/turbo.py.

Device-preprocess route (the default), per call, on the device:

1. the raw volume is uploaded once, from a pinned staging buffer;
2. the plans transpose, the per-channel normalization (CT clip + z-score,
   z-score, rescale-to-01, rgb/255, none), a trilinear resize to the target
   spacing (half-pixel centres, edge samples clamped — the same map as
   ``jax.image.resize(..., "trilinear", antialias=False)``), the cast to the
   compute dtype and the pad to the sweep layout (with ``_fill_f64``);
3. the air flags of every chunk's tile batches in one pass (an exact
   x-extent 8^3 block-max test, the streamed JAX route's semantics), fetched
   with one copy, so whole-air batches are skipped without a sync per batch;
4. the s2d rolling sweep (inference/engine.py; kernels A, B and C);
5. the nearest revert to the original grid (the index map of
   ``jax.image.resize(method="nearest")``) and the inverse transpose,
   then one D2H copy of the uint8 mask — or, with ``host_revert``, the
   target-grid mask packed 6 bits per voxel on the device, one copy into
   pinned memory, and the revert on the host (csrc/host_ops.cpp).

Host route (``host_preprocess=True``, int16 CT channels; the JAX package's
default serving route), on the host library csrc/host_ops.cpp
(utils/hostops.py):

- streamed (the default; ``FNN_TURBO_STREAM=0`` turns it off): the sweep
  runs over a rolling device slab of p0 rows. Each x-strip of the target
  grid is clipped, z-scored and resampled in C++ right before its upload,
  cropped in-plane to the non-air bounding box, written into a ring of
  pinned buffers and copied on a side stream two chunks ahead, while the
  card computes earlier chunks; the slab reinserts it into the bf16-exact
  fill. Each chunk's finished rows are packed 6 bits per voxel and copied
  out as the chunk ends; the host unpacks them and reverts to the original
  grid. Air flags come from the strips the host already holds (no fetch
  per chunk).
- fused, where the geometry does not stream (one x start, an odd roll) or
  the stream is off: the non-fill bounding slab of the whole preprocessed
  grid is uploaded, reinserted into fill on the device, swept like the
  device route and reverted on the host.

Both routes run the same per-chunk body (engine.S2DChunks): the same
tiles in the same batches, so their masks are bit-equal.

Package cache: the pipeline takes its engine's ``aot_cache`` (``FNN_AOT_CACHE``
when the engine was given none), as JAX's pipeline does. On either route the
s2d network's forward then runs through an AOTInductor package
(inference/aot.py), loaded by a fresh process without compiling. JAX
compiles the whole turbo program (or each streamed chunk's program); the
port packages only the network, since the rest of a route is eager PyTorch
(preprocess, kernels C and B, the revert) and no graph.
"""
import argparse
import configparser
import os
import re
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..imageio.nifti import NiftiIOWithReorient
from ..utils import hostops
from .engine import RowFetcher, S2DChunks, StripUploader


#: in-plane extents of the host route's crop round up to this
CROP_BUCKET = 32


def _parse_tuple(s: str) -> Tuple[float, ...]:
    return tuple(float(x) for x in re.split(r"[x,()\s]+", str(s).strip()) if x)


#: device-path normalization schemes (class name -> short scheme tag)
_SCHEME_TAGS = {
    "CTNormalization": "ct",
    "ZScoreNormalization": "zscore",
    "NoNormalization": "nonorm",
    "RescaleTo01Normalization": "rescale01",
    "RGBTo01Normalization": "rgb01",
}


class TurboConfig:
    """bone_turbo-style deployment point (the engine INI's schema), a copy
    of fast_nnunet_tpu.inference.turbo.TurboConfig.

    The INI patch order is image axis order; the engine's chunk axis (axis
    0) carries the smallest patch extent, so the patch and spacing are
    transposed with the largest extent last. Multi-channel inputs carry a
    per-channel ``channels`` list of scheme dicts
    (``{"scheme": "ct", "mean", "std", "lower_bound", "upper_bound"}`` or
    ``{"scheme": "zscore" | "rescale01" | "rgb01" | "nonorm"}``)."""

    def __init__(self, patch_size: Sequence[int],
                 target_spacing: Sequence[float],
                 mean: float = 0.0, std: float = 1.0,
                 lower_bound: float = -1024.0, upper_bound: float = 3071.0,
                 num_classes: int = 2,
                 step_size: float = 0.5, use_gaussian: bool = True,
                 channels: Optional[Sequence[dict]] = None):
        self.patch_size_image = tuple(int(p) for p in patch_size)
        self.transpose_forward = sorted(
            range(len(patch_size)), key=lambda a: self.patch_size_image[a])
        self.transpose_backward = list(np.argsort(self.transpose_forward))
        self.patch_size = tuple(self.patch_size_image[a]
                                for a in self.transpose_forward)
        self.target_spacing_image = tuple(float(s) for s in target_spacing)
        self.target_spacing = tuple(self.target_spacing_image[a]
                                    for a in self.transpose_forward)
        self.mean = float(mean)
        self.std = float(std)
        self.lower_bound = float(lower_bound)
        self.upper_bound = float(upper_bound)
        self.num_classes = int(num_classes)
        self.step_size = float(step_size)
        self.use_gaussian = bool(use_gaussian)
        if channels is None:
            channels = [{"scheme": "ct", "mean": self.mean, "std": self.std,
                         "lower_bound": self.lower_bound,
                         "upper_bound": self.upper_bound}]
        self.channels = [dict(c) for c in channels]
        for c in self.channels:
            if c.get("scheme") not in ("ct", "zscore", "rescale01", "rgb01",
                                       "nonorm"):
                raise ValueError(f"unknown normalization scheme in {c}")

    @property
    def num_input_channels(self) -> int:
        return len(self.channels)

    @classmethod
    def from_ini(cls, path: str) -> "TurboConfig":
        cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
        if not cp.read(path):
            raise FileNotFoundError(path)
        pre = cp["preprocessing"]
        return cls(
            patch_size=[int(x) for x in _parse_tuple(cp["input"]["patch_size"])],
            target_spacing=_parse_tuple(cp["input"]["target_spacing"]),
            mean=float(pre["mean"]),
            std=float(pre.get("std", pre.get("std_dev", "1.0"))),
            lower_bound=float(pre["lower_bound"]),
            upper_bound=float(pre["upper_bound"]),
            num_classes=int(cp["model"]["num_class"]),
            step_size=float(cp["inference"].get("step_size", 0.5)),
            use_gaussian=cp["inference"].getboolean("use_gaussian", True))


def _fill_f64(spec) -> float:
    """Sweep-pad value in normalized units (python-float arithmetic): the
    HU clip floor for CT (air), 0 for the statistic-based schemes."""
    if spec["scheme"] == "ct":
        return (spec["lower_bound"] - spec["mean"]) / max(spec["std"], 1e-8)
    return 0.0


def _f32_to_bf16_bits(f: np.float32) -> int:
    """Round-to-nearest-even float32 -> bfloat16 bit pattern (finite input)."""
    bits = int(np.asarray(f, np.float32).view(np.uint32))
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) & 0xFFFF


def _fill_bf16_bits(spec) -> int:
    """The CT fill value's exact bfloat16 bit pattern: f32 arithmetic
    (lb - mean) * (1 / max(std, eps)), rounded to nearest-even bf16 — the
    host preprocess's fill (engine/src/host_ops.cpp), computed without
    ml_dtypes."""
    inv = np.float32(1.0) / np.maximum(np.float32(spec["std"]),
                                       np.float32(1e-8))
    f = (np.float32(spec["lower_bound"]) - np.float32(spec["mean"])) * inv
    return _f32_to_bf16_bits(np.float32(f))


def _bf16_value(bits: int) -> float:
    """The float a bfloat16 bit pattern stands for."""
    return float(np.array([int(bits) << 16], np.uint32).view(np.float32)[0])


def _nonfill_bbox(arr: np.ndarray, fill_bits, bucket: int):
    """Raw per-axis [lo, hi) extents of the voxels where ANY channel of arr
    (C, d, h, w) bf16 bits differs from its fill bit pattern. Returns
    all-zero lo and a minimal bucket-sized hi when nothing differs."""
    bits = arr.view(np.uint16)
    diff = np.zeros(arr.shape[1:], bool)
    for c in range(arr.shape[0]):
        diff |= bits[c] != np.uint16(fill_bits[c])
    if not diff.any():
        return ([0] * (arr.ndim - 1),
                [min(bucket, s) for s in arr.shape[1:]])
    lo, hi = [], []
    for ax in range(diff.ndim):
        other = tuple(a for a in range(diff.ndim) if a != ax)
        nz = np.flatnonzero(diff.any(axis=other))
        lo.append(int(nz[0]))
        hi.append(int(nz[-1]) + 1)
    return lo, hi


def _bucket_extent(l: int, h: int, s: int, bucket: int):
    """Floor lo to the bucket FIRST, then size the slab from the floored
    lo — sizing from the raw lo can leave [lf+size, h) uncovered."""
    lf = l // bucket * bucket
    size = min(-(-(h - lf) // bucket) * bucket, s - lf)
    return lf, lf + size


def _source_range_to_target(n_in: int, n_out: int, slo: int, shi: int):
    """Conservative map of a SOURCE-axis non-air range [slo, shi) to the
    TARGET-axis range of trilinear-output voxels that can differ from the
    fill: target j reads source samples lo[j] and hi[j] (half-pixel rule,
    f32 arithmetic like csrc/host_ops.cpp linear_table); j can be non-fill
    only when [lo[j], hi[j]] meets [slo, shi). Every excluded voxel
    interpolates equal clip-floor neighbours, so it lands on the fill bit
    pattern exactly — the box is a superset of the grid-scan one and the
    crop's reinsertion stays bit-exact."""
    i = np.arange(n_out, dtype=np.float32)
    x = (i + np.float32(0.5)) * (np.float32(n_in) / np.float32(n_out)) \
        - np.float32(0.5)
    lo = np.floor(x).astype(np.int64)
    hi = np.clip(lo + 1, 0, n_in - 1)
    lo = np.clip(lo, 0, n_in - 1)
    nz = np.flatnonzero((hi >= slo) & (lo <= shi - 1))
    if nz.size == 0:  # degenerate geometry; never drop voxels
        return 0, n_out
    return int(nz[0]), int(nz[-1]) + 1


def _crop_to_fill_bbox(arr: np.ndarray, fill_bits, bucket: int):
    """arr: (C, d, h, w) bf16 bits. Returns (crop_box, slab): slab is the
    contiguous sub-volume outside of which EVERY channel equals its fill
    bit pattern (padding it with the fill reconstructs arr exactly), its
    extents rounded up to ``bucket`` multiples; (None, arr) when the box
    covers everything. A wrong fill pattern fails safe: nothing matches,
    the box spans the array, and the crop is a no-op."""
    lo, hi = _nonfill_bbox(arr, fill_bits, bucket)
    box_lo, box_hi = [], []
    for l, h, s in zip(lo, hi, arr.shape[1:]):
        bl, bh = _bucket_extent(l, h, s, bucket)
        box_lo.append(bl)
        box_hi.append(bh)
    if not all(bl <= l and bh >= h
               for bl, bh, l, h in zip(box_lo, box_hi, lo, hi)):
        raise AssertionError(f"crop slab {box_lo}-{box_hi} misses non-fill "
                             f"voxels {lo}-{hi}")
    if all(h - l >= s for l, h, s in zip(box_lo, box_hi, arr.shape[1:])):
        return None, arr
    slab = np.ascontiguousarray(
        arr[:, box_lo[0]:box_hi[0], box_lo[1]:box_hi[1],
            box_lo[2]:box_hi[2]])
    return (tuple(box_lo), tuple(box_hi)), slab


def pack_mask6(s: torch.Tensor) -> torch.Tensor:
    """uint8 labels < 64 -> (ceil(n / 4), 3) uint8, 4 voxels in 3 bytes
    (the JAX pipeline's device pack, zero-padded to a multiple of 4)."""
    flat = s.reshape(-1)
    n = flat.numel()
    if n % 4:
        flat = torch.cat([flat, flat.new_zeros((-n) % 4)])
    q = flat.view(-1, 4)
    b0 = q[:, 0] | (q[:, 1] << 6)
    b1 = (q[:, 1] >> 2) | (q[:, 2] << 4)
    b2 = (q[:, 2] >> 4) | (q[:, 3] << 2)
    return torch.stack([b0, b1, b2], dim=-1)


def _unpack_mask6(packed: np.ndarray, shape) -> np.ndarray:
    """Inverse of :func:`pack_mask6` on the host."""
    b0, b1, b2 = packed[:, 0], packed[:, 1], packed[:, 2]
    v = np.empty((packed.shape[0], 4), np.uint8)
    v[:, 0] = b0 & 63
    v[:, 1] = (b0 >> 6) | ((b1 & 15) << 2)
    v[:, 2] = (b1 >> 4) | ((b2 & 3) << 4)
    v[:, 3] = b2 >> 2
    n = int(np.prod(shape))
    return v.reshape(-1)[:n].reshape(shape)


def _row_blocks(bits: np.ndarray, tf, off_y: int, off_z: int, by: int,
                bz: int) -> np.ndarray:
    """bits: one channel of a strip as bf16 bit patterns, image axis order,
    placed at (off_y, off_z) of an engine-order plane of (8 by, 8 bz).
    Returns (rows, by, bz) f32: per engine row, the maxima of its 8 x 8
    blocks, -inf where a block holds no voxel of the strip. The maxima are
    taken on order-preserving 16-bit keys in the strip's own layout (no
    float conversion or transpose of the strip), then mapped back."""
    def cuts(off, n):
        j0, j1 = off // 8, (off + n - 1) // 8 + 1
        return j0, j1, [max(8 * j - off, 0) for j in range(j0, j1)]
    ay, az = tf[1], tf[2]
    y0, y1, cy = cuts(off_y, bits.shape[ay])
    z0, z1, cz = cuts(off_z, bits.shape[az])
    # negative bf16: all bits flipped; non-negative: the sign bit set
    key = bits ^ ((bits >> 15) * np.uint16(0x7FFF) | np.uint16(0x8000))
    m = np.maximum.reduceat(np.maximum.reduceat(key, cy, axis=ay), cz,
                            axis=az)
    m = np.transpose(m, tf)
    m = np.where(m & 0x8000, m ^ np.uint16(0x8000), ~m)
    out = np.full((m.shape[0], by, bz), -np.inf, np.float32)
    out[:, y0:y1, z0:z1] = (m.astype(np.uint32) << 16).view(np.float32)
    return out


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """jax.image.resize(method="nearest")'s per-axis source index:
    floor((i + 0.5) * in / out) in float32."""
    return np.floor((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                    * np.float32(n_in) / np.float32(n_out)).astype(np.int64)


def _nearest_revert_host(seg: np.ndarray, out_shape) -> np.ndarray:
    """Nearest-neighbor resize on the host, voxel-for-voxel equal to
    jax.image.resize(method="nearest")."""
    idx = [_nearest_index(m, n) for m, n in zip(seg.shape, out_shape)]
    return seg[np.ix_(*idx)]


def resize_nearest(x: torch.Tensor, out_shape: Sequence[int]) -> torch.Tensor:
    """Device nearest resize of the trailing len(out_shape) axes with the
    index map of :func:`_nearest_revert_host`."""
    lead = x.dim() - len(out_shape)
    for ax, n in enumerate(out_shape):
        m = x.shape[lead + ax]
        if m != n:
            idx = torch.as_tensor(_nearest_index(m, n), device=x.device)
            x = x.index_select(lead + ax, idx)
    return x


def resize_trilinear(x: torch.Tensor, out_shape: Sequence[int]) -> torch.Tensor:
    """(C, D, H, W) float -> (C, *out_shape): linear interpolation with
    half-pixel centres, edge samples clamped, no antialiasing — the sample
    map of jax.image.resize(..., "trilinear", antialias=False)."""
    return F.interpolate(x[None], size=tuple(int(s) for s in out_shape),
                         mode="trilinear", align_corners=False)[0]


def _normalize(xc: torch.Tensor, spec: dict) -> torch.Tensor:
    """One channel, float32 (mirrors the JAX device program)."""
    s = spec["scheme"]
    if s == "ct":
        xc = torch.clamp(xc, spec["lower_bound"], spec["upper_bound"])
        return (xc - spec["mean"]) / max(spec["std"], 1e-8)
    if s == "zscore":
        return (xc - xc.mean()) / torch.clamp(xc.std(correction=0), min=1e-8)
    if s == "rescale01":
        xc = xc - xc.min()
        return xc / torch.clamp(xc.max(), min=1e-8)
    if s == "rgb01":
        return xc / 255.0
    return xc  # nonorm


def air_flags(x: torch.Tensor, starts_x: Sequence[int], patch: Sequence[int],
              coords_b: np.ndarray, fill: float, threshold: float
              ) -> np.ndarray:
    """Per (chunk, batch, slot) "tile holds body" flags for the whole sweep,
    computed on the device in one pass and fetched with one copy.

    x: channel 0 of the padded sweep volume (X, Yp, Zp), compute dtype.
    A tile of chunk k is body when the maximum over its chunk's exact x
    extent [x0, x0 + p0) and the 8^3 blocks its in-plane window touches
    exceeds ``threshold`` (compared in x's dtype); partial blocks are padded
    with the air ``fill`` so they never hide body voxels. Returns
    (n_chunks, nb, B) float32 0/1."""
    p0, py, pz = (int(p) for p in patch)
    X, Yp, Zp = x.shape
    fill_t = torch.tensor(fill, dtype=x.dtype).item()
    thr_t = torch.tensor(threshold, dtype=x.dtype).item()
    by, bz = -(-Yp // 8) * 8, -(-Zp // 8) * 8
    xf = F.pad(x.float(), (0, bz - Zp, 0, by - Yp), value=fill_t)
    rowmax = xf.reshape(X, by // 8, 8, bz // 8, 8).amax(dim=(2, 4))
    blocks = torch.stack([rowmax[x0:x0 + p0].amax(0) for x0 in starts_x])
    if p0 % 8:
        blocks = torch.clamp(blocks, min=fill_t)  # the fill-padded x block
    wy, wz = py // 8 + 1, pz // 8 + 1
    boxmax = F.max_pool2d(
        F.pad(blocks[:, None], (0, wz - 1, 0, wy - 1), value=float("-inf")),
        (wy, wz), stride=1)[:, 0]
    flat = coords_b.reshape(-1, 3)
    yi = torch.as_tensor(flat[:, 1] // 8, device=x.device, dtype=torch.long)
    zi = torch.as_tensor(flat[:, 2] // 8, device=x.device, dtype=torch.long)
    flags = (boxmax[:, yi, zi] > thr_t).cpu().numpy()
    return flags.reshape(len(starts_x), *coords_b.shape[:2]).astype(np.float32)


class TurboPipeline:
    def __init__(self, engine, config: TurboConfig, air_skip: bool = False,
                 air_margin_hu: float = 200.0, host_revert: bool = False,
                 host_preprocess="auto"):
        """engine: a SlidingWindowEngine (inference/engine.py) wrapping an
        S2DPlainConvUNet whose patch/classes match ``config``.
        air_skip: drop tile batches whose voxels are all below
        lower_bound + air_margin_hu (HU; CT channel 0 only).
        host_revert: fetch the target-grid mask (packed 6 bits per voxel
        with <= 64 classes) and revert it to the original grid on the host
        (voxel-identical to the device revert).
        host_preprocess: True takes the host route for int16 input (see the
        module docstring; it implies the host revert): CT channels only
        (ValueError otherwise), and the host library is built here (a
        failed build raises RuntimeError). Float input takes the device
        route for that call. "auto" is the device route, unlike JAX's
        "auto" (the host route whenever the hand-built
        engine/build/libfnn_hostops.so exists): that route hides a slow TPU
        link, and the port builds its host library on first use, so JAX's
        rule would move every caller onto a single-threaded C++ preprocess
        without a measurement that it pays on the card."""
        self.engine = engine
        self.config = config
        self.host_revert = bool(host_revert)
        if host_preprocess == "auto":
            host_preprocess = False
        elif host_preprocess:
            if not all(c["scheme"] == "ct" for c in config.channels):
                raise ValueError("host_preprocess supports CT channels only")
            hostops.library()
        self.host_preprocess = bool(host_preprocess)
        #: the host revert fetches 6-bit labels when they fit
        self.pack_mask = config.num_classes <= 64
        ch0 = config.channels[0]
        if air_skip and ch0["scheme"] != "ct":
            print("[turbo] air skipping needs a CT (HU-calibrated) channel 0; "
                  f"disabled for scheme {ch0['scheme']!r}")
            air_skip = False
        self.air_skip = bool(air_skip)
        if ch0["scheme"] == "ct":
            self.air_threshold = (min(ch0["lower_bound"] + air_margin_hu,
                                      ch0["upper_bound"])
                                  - ch0["mean"]) / ch0["std"]
        else:
            self.air_threshold = float("-inf")
        self._staging = {}
        #: the route the last predict_volume took ("device", "host" or
        #: "streamed"); the host route's host work shows as the engine
        #: timer's host-only phases "host_preprocess", "host_air" (flags)
        #: and "host_revert"
        self.route = None

    @property
    def device(self) -> torch.device:
        return self.engine.device

    # ------------------------------------------------------------- helpers
    def _upload(self, volume: np.ndarray) -> torch.Tensor:
        """Raw volume -> device, once, through a reused pinned buffer. The
        buffer is refilled only after the previous copy out of it is done."""
        host = torch.from_numpy(np.ascontiguousarray(volume))
        if self.device.type == "cpu":
            return host
        key = (tuple(host.shape), host.dtype)
        buf, done = self._staging.get(key, (None, None))
        if buf is None:
            buf = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            done = torch.cuda.Event()
            done.record()
            self._staging = {key: (buf, done)}
        done.synchronize()
        buf.copy_(host)
        dev = buf.to(self.device, non_blocking=True)
        done.record()
        return dev

    def _geometry(self, volume: np.ndarray, spacing: Sequence[float]):
        """(in_shape, new_shape) in engine order: the raw grid and the
        target-spacing grid (at least the patch)."""
        cfg, eng = self.config, self.engine
        tf = list(cfg.transpose_forward)
        in_shape = tuple(int(volume.shape[1 + a]) for a in tf)
        spacing_t = [float(spacing[a]) for a in tf]
        new_shape = tuple(int(round(s * sp / tsp)) for s, sp, tsp in zip(
            in_shape, spacing_t, cfg.target_spacing))
        new_shape = tuple(max(n, p) for n, p in zip(new_shape, eng.patch_size))
        return in_shape, new_shape

    def _air_valid(self, x0: torch.Tensor, steps) -> Optional[np.ndarray]:
        """Per-chunk batch validity from channel 0 of the padded device
        volume (air skipping), or None without it."""
        if not self.air_skip:
            return None
        eng = self.engine
        starts_x, coords_b, valid_b = eng.sweep_tiles(steps)
        flags = air_flags(x0, starts_x, eng.patch_size, coords_b,
                          _fill_f64(self.config.channels[0]),
                          self.air_threshold)
        return flags * valid_b[None]

    # ---------------------------------------------------------- prediction
    def preprocess(self, volume: np.ndarray, spacing: Sequence[float]):
        """Raw (C, D, H, W) image-order volume -> the padded sweep volume on
        the device, in one upload: transpose, normalize, trilinear resize,
        cast, pad, and (with air skipping) the per-chunk batch validity.
        Returns (vol (C, *vol_shape), new_shape, in_shape, valid_chunks),
        shapes in engine order; valid_chunks is None without air skipping."""
        cfg, eng = self.config, self.engine
        tf = list(cfg.transpose_forward)
        in_shape, new_shape = self._geometry(volume, spacing)
        vol_shape, steps = eng.s2d_sweep_plan(new_shape)
        dt = eng.compute_dtype
        with torch.no_grad():
            with eng.phase("upload"):
                raw = self._upload(volume)
            with eng.phase("preprocess"):
                raw_t = raw.permute(0, *(a + 1 for a in tf))
                chans = [_normalize(raw_t[c].float(), spec)
                         for c, spec in enumerate(cfg.channels)]
                xs = resize_trilinear(torch.stack(chans), new_shape).to(dt)
                del chans
                vol = torch.empty((len(cfg.channels), *vol_shape), dtype=dt,
                                  device=self.device)
                for c, spec in enumerate(cfg.channels):
                    vol[c].fill_(_fill_f64(spec))
                vol[(slice(None),) + tuple(slice(0, n) for n in new_shape)] = xs
                del xs
                valid_chunks = self._air_valid(vol[0], steps)
        return vol, new_shape, in_shape, valid_chunks

    def predict_volume(self, params_list, volume: np.ndarray,
                       spacing: Sequence[float]) -> np.ndarray:
        """(D, H, W) — or (C, D, H, W) — raw volume in image axis order +
        its spacing -> uint8 segmentation on the ORIGINAL grid.
        ``params_list`` is the s2d parameter tree, or a list of them (a
        fold ensemble), loaded into the network(s) unless they are the ones
        already loaded. The engine's timer sees one host-only phase,
        "predict_volume", around the CT's other phases."""
        cfg = self.config
        if volume.ndim == len(cfg.patch_size):
            volume = volume[None]
        if volume.shape[0] != cfg.num_input_channels:
            raise ValueError(
                f"{volume.shape[0]} input channels but TurboConfig declares "
                f"{cfg.num_input_channels} normalization schemes")
        with self.engine.phase("predict_volume", events=False):
            return self._predict(params_list, volume, spacing)

    def _predict(self, params_list, volume: np.ndarray,
                 spacing: Sequence[float]) -> np.ndarray:
        cfg, eng = self.config, self.engine
        eng.load_params(params_list)
        if self.host_preprocess and volume.dtype == np.int16:
            return self._predict_host(volume, spacing)
        self.route = "device"
        vol, new_shape, in_shape, valid_chunks = self.preprocess(volume,
                                                                 spacing)
        seg = eng.run_s2d_sweep(vol, new_shape, valid_chunks)
        del vol
        s = seg[tuple(slice(0, n) for n in new_shape)]
        if self.host_revert:
            return self._revert_on_host(s, in_shape)
        with torch.no_grad():
            with eng.phase("revert"):
                out = resize_nearest(s, in_shape).permute(
                    *cfg.transpose_backward).contiguous()
            with eng.phase("d2h"):
                eng.count("d2h_pageable_bytes", out.nbytes)
                mask = out.cpu().numpy()
        return mask

    # ---------------------------------------------------------- host route
    def _ct_scalars(self):
        chs = self.config.channels
        return ([c["lower_bound"] for c in chs], [c["upper_bound"] for c in chs],
                [c["mean"] for c in chs], [c["std"] for c in chs])

    def _predict_host(self, volume: np.ndarray, spacing) -> np.ndarray:
        """The host route of an int16 CT (see the module docstring)."""
        cfg = self.config
        volume = np.ascontiguousarray(volume)  # read once per strip
        in_shape, new_shape = self._geometry(volume, spacing)
        inv = cfg.transpose_backward
        new_shape_img = tuple(new_shape[inv[p]] for p in range(3))
        if os.environ.get("FNN_TURBO_STREAM", "1") == "1":
            seg = self._predict_streamed(volume, new_shape, new_shape_img)
            if seg is not None:
                return self._finish_host(seg, in_shape)
        with self.engine.phase("host_preprocess", events=False):
            grid = hostops.preprocess_ct_i16(volume, new_shape_img,
                                             *self._ct_scalars())
        self.route = "host"
        # what the CT clip floor made exactly the fill (air) need not cross
        # the link: upload the non-fill slab, reinsert on device
        crop_box, grid = _crop_to_fill_bbox(
            grid, [_fill_bf16_bits(c) for c in cfg.channels],
            bucket=CROP_BUCKET)
        seg = self._sweep_host_grid(grid, crop_box, new_shape)
        return self._revert_on_host(
            seg[tuple(slice(0, n) for n in new_shape)], in_shape)

    def _sweep_host_grid(self, grid: np.ndarray, crop_box,
                         new_shape) -> torch.Tensor:
        """Upload a host-preprocessed image-order bf16 grid (or its crop
        slab at crop_box), build the padded sweep volume from it — the slab
        inside the bf16-exact fill, ``_fill_f64`` in the pad ring — and run
        the s2d sweep. Returns the device mask at vol_shape."""
        cfg, eng = self.config, self.engine
        tf = cfg.transpose_forward
        vol_shape, steps = eng.s2d_sweep_plan(new_shape)
        dt = eng.compute_dtype
        with torch.no_grad():
            with eng.phase("upload"):
                raw = self._upload(grid.view(np.int16))
            with eng.phase("preprocess"):
                xs = raw.view(torch.bfloat16).permute(
                    0, *(a + 1 for a in tf)).to(dt)
                vol = torch.empty((len(cfg.channels), *vol_shape), dtype=dt,
                                  device=self.device)
                off = [0, 0, 0]
                for c, spec in enumerate(cfg.channels):
                    vol[c].fill_(_fill_f64(spec))
                    if crop_box is not None:
                        vol[c, :new_shape[0], :new_shape[1],
                            :new_shape[2]].fill_(
                            _bf16_value(_fill_bf16_bits(spec)))
                if crop_box is not None:
                    off = [int(crop_box[0][p]) for p in tf]
                vol[(slice(None),) + tuple(
                    slice(o, o + n) for o, n in zip(off, xs.shape[1:]))] = xs
                del xs
                valid_chunks = self._air_valid(vol[0], steps)
        return eng.run_s2d_sweep(vol, new_shape, valid_chunks)

    def _revert_on_host(self, s: torch.Tensor, in_shape) -> np.ndarray:
        """Target-grid device mask (engine order) -> packed on the device,
        one copy into pinned memory, unpacked and reverted on the host."""
        eng = self.engine
        with torch.no_grad():
            with eng.phase("pack"):
                packed = pack_mask6(s) if self.pack_mask else s.contiguous()
            fetch = RowFetcher(self.device)
            with eng.phase("d2h"):
                eng.count("d2h_pinned_bytes", packed.nbytes)
                fetch.put(packed)
            host = fetch.results()[0]
        with eng.phase("host_revert", events=False):
            seg = _unpack_mask6(host, tuple(s.shape)) if self.pack_mask \
                else host
        return self._finish_host(seg, in_shape)

    def _finish_host(self, seg: np.ndarray, in_shape) -> np.ndarray:
        """Engine-order target-grid mask -> original grid, image order."""
        with self.engine.phase("host_revert", events=False):
            if seg.shape != tuple(in_shape):
                seg = hostops.nearest_revert_u8(seg, in_shape)
        return np.transpose(seg, self.config.transpose_backward)

    def _predict_streamed(self, raw: np.ndarray, new_shape, img_shape
                          ) -> Optional[np.ndarray]:
        """The streamed host route over a rolling device slab (module
        docstring). raw: the (C, D, H, W) int16 volume, each strip
        preprocessed from it right before its upload. Returns the engine-order
        target-grid mask, or None where the geometry does not stream (one x
        start, an odd roll, mirroring, an odd patch, a strip box the host
        library rejects): the caller then takes the fused host route."""
        cfg, eng = self.config, self.engine
        p0 = eng.patch_size[0]
        if eng.mirror_axes or p0 % 2:
            return None
        vol_shape, steps = eng.s2d_sweep_plan(new_shape)
        starts_x = [int(x) for x in steps[0]]
        n_starts = len(starts_x)
        if n_starts < 2 or any((starts_x[k + 1] - starts_x[k]) % 2
                               for k in range(n_starts - 1)):
            return None
        tf = cfg.transpose_forward
        t0 = tf[0]
        C = cfg.num_input_channels
        lbs, ubs, means, stds = self._ct_scalars()
        fill_bits = [_fill_bf16_bits(c) for c in cfg.channels]

        # the in-plane crop box, applied to every strip (x is never cropped)
        slo, shi = hostops.nonair_bbox_i16(raw, lbs)
        if shi[0] <= slo[0]:  # all air, as _nonfill_bbox
            lo = [0] * 3
            hi = [min(CROP_BUCKET, n) for n in img_shape]
        else:
            pairs = [_source_range_to_target(
                raw.shape[1 + ax], img_shape[ax], slo[ax], shi[ax])
                for ax in range(3)]
            lo, hi = [p[0] for p in pairs], [p[1] for p in pairs]
        box = [(0, img_shape[ax]) if ax == t0 else
               _bucket_extent(lo[ax], hi[ax], img_shape[ax], CROP_BUCKET)
               for ax in range(3)]
        nx, ny, nz = new_shape
        bounds = [(0, p0)] + [(starts_x[k - 1] + p0, starts_x[k] + p0)
                              for k in range(1, n_starts)]

        def box6(a, b):
            out = []
            for ax in range(3):
                out += [a, min(b, img_shape[ax])] if ax == t0 else box[ax]
            return out

        if not all(hostops.box_ok(img_shape, box6(a, b)) for a, b in bounds):
            return None

        self.route = "streamed"
        dt = eng.compute_dtype
        plane = vol_shape[1:]
        oy, oz = box[tf[1]][0], box[tf[2]][0]
        fill_t = torch.tensor(_fill_f64(cfg.channels[0]), dtype=dt).item()
        air = self.air_skip
        if air:
            # per-row 8 x 8 block maxima of channel 0 (the air test of
            # turbo.air_flags), kept on the host from the strips it writes;
            # rows past nx and the plane outside the box hold fill values
            by, bz = -(-plane[0] // 8), -(-plane[1] // 8)
            floor_plane = np.full((8 * by, 8 * bz), fill_t, np.float32)
            floor_plane[:ny, :nz] = _bf16_value(fill_bits[0])
            ey, ez = box[tf[1]][1] - oy, box[tf[2]][1] - oz
            floor_plane[oy:oy + ey, oz:oz + ez] = -np.inf
            floor = floor_plane.reshape(by, 8, bz, 8).max((1, 3))
            rowmax = np.full((vol_shape[0], by, bz), fill_t, np.float32)
            thr_t = torch.tensor(self.air_threshold, dtype=dt).item()
            _, coords_b, valid_b = eng.sweep_tiles(steps)
            flat = coords_b.reshape(-1, 3)
            yi, zi = flat[:, 1] // 8, flat[:, 2] // 8
            wy, wz = eng.patch_size[1] // 8 + 1, eng.patch_size[2] // 8 + 1

        def chunk_valid(k):
            if not air:
                return None
            x0 = starts_x[k]
            blocks = rowmax[x0:x0 + p0].max(0)
            if p0 % 8:
                blocks = np.maximum(blocks, fill_t)  # the fill-padded x block
            padded = np.full((by + wy - 1, bz + wz - 1), -np.inf, np.float32)
            padded[:by, :bz] = blocks
            boxmax = np.lib.stride_tricks.sliding_window_view(
                padded, (wy, wz)).max((2, 3))
            flags = (boxmax[yi, zi] > thr_t).astype(np.float32)
            return flags.reshape(valid_b.shape) * valid_b

        def put(k):
            a, b = bounds[k]
            b6 = box6(a, b)
            shape = [b6[2 * ax + 1] - b6[2 * ax] for ax in range(3)]

            def fill(host):
                out = host.numpy().view(np.uint16)
                with eng.phase("host_preprocess", events=False):
                    hostops.preprocess_ct_i16_box(
                        raw, img_shape, b6, lbs, ubs, means, stds, out=out)
                if air:
                    with eng.phase("host_air", events=False):
                        rowmax[a:a + shape[t0]] = np.maximum(
                            _row_blocks(out[0], tf, oy, oz, by, bz), floor)
            return up.put((C, *shape), torch.int16, fill), shape[t0]

        def prep_into(dst, handle):
            """Strip -> slab rows dst (C, rows, Yp, Zp): transpose, the
            bf16-exact fill inside new_shape, _fill_f64 in the pad ring."""
            (h, rd) = handle
            strip = up.take(h)
            with eng.phase("preprocess"):
                xs = strip.view(torch.bfloat16).permute(
                    0, *(ax + 1 for ax in tf)).to(dt)
                for c, spec in enumerate(cfg.channels):
                    dst[c].fill_(_fill_f64(spec))
                    dst[c, :rd, :ny, :nz].fill_(_bf16_value(fill_bits[c]))
                dst[:, :rd, oy:oy + xs.shape[2], oz:oz + xs.shape[3]] = xs

        up = StripUploader(self.device, eng.phase)
        fetch = RowFetcher(self.device)
        pieces = []
        with torch.no_grad():
            handles = [put(0), put(1)]
            sweep = S2DChunks(eng, vol_shape, steps)
            slab = torch.empty((C, p0, *plane), dtype=dt, device=self.device)
            spare = torch.empty_like(slab)
            prep_into(slab, handles[0])
            for k in range(n_starts):
                if k + 2 < n_starts:
                    handles.append(put(k + 2))
                sweep.accumulate(slab, 0, chunk_valid(k))
                n2 = 2 * sweep.owned_rows(k)
                rows = torch.empty((n2, *plane), dtype=torch.uint8,
                                   device=self.device)
                sweep.finish(k, rows)
                with eng.phase("pack"):
                    r = rows[:, :ny, :nz]
                    packed = pack_mask6(r) if self.pack_mask \
                        else r.contiguous()
                with eng.phase("d2h"):
                    eng.count("d2h_pinned_bytes", packed.nbytes)
                    fetch.put(packed)
                pieces.append(n2)
                if k < n_starts - 1:
                    spare[:, :p0 - n2].copy_(slab[:, n2:])
                    prep_into(spare[:, p0 - n2:], handles[k + 1])
                    handles[k + 1] = None
                    slab, spare = spare, slab
        with eng.phase("host_revert", events=False):
            segs = [_unpack_mask6(p, (n2, ny, nz)) if self.pack_mask else p
                    for n2, p in zip(pieces, fetch.results())]
            return np.concatenate(segs, 0)[:nx]

    @classmethod
    def from_model_folder(cls, model_folder: str, fold=0,
                          checkpoint_name: str = "checkpoint_final.fnnx",
                          air_skip: bool = True, tile_batch: int = 8,
                          compute_dtype=None, device=None,
                          aot_cache: Optional[str] = None,
                          **pipeline_kwargs):
        """Build (pipeline, params) from a trained model folder: reads the
        ``.fnnx`` checkpoint (numpy-only unpickler), re-parameterizes the
        PlainConvUNet into the s2d form and derives the TurboConfig from
        plans.json. ``params`` is the s2d parameter tree, as in the JAX
        package; ``predict_volume`` loads it into the network.
        ``aot_cache``: the engine's package cache (None: FNN_AOT_CACHE)."""
        from ..core.labels import determine_num_input_channels
        from ..core.plans import PlansManager
        from ..models.s2d import make_s2d_engine_net
        from ..models.students import build_student_arch_kwargs
        from ..training.checkpoint import load_checkpoint
        from ..utils.io import join, load_json
        from .engine import SlidingWindowEngine

        device = resolve_device(device)
        compute_dtype = compute_dtype or torch.bfloat16
        dataset_json = load_json(join(model_folder, "dataset.json"))
        pm = PlansManager(join(model_folder, "plans.json"))
        ckpt = load_checkpoint(join(model_folder, f"fold_{fold}",
                                    checkpoint_name))
        init_args = ckpt.get("init_args") or {}
        cfg = pm.get_configuration(init_args.get("configuration",
                                                 "3d_fullres"))
        lm = pm.get_label_manager(dataset_json)
        num_in = determine_num_input_channels(pm, cfg, dataset_json)
        num_out = lm.num_segmentation_heads
        arch = cfg.configuration["architecture"]
        kwargs = arch["arch_kwargs"]
        if "Distillation" in ckpt.get("trainer_name", ""):
            kwargs = build_student_arch_kwargs(
                kwargs, init_args.get("feature_reduction_factor", 2),
                init_args.get("block_reduction_strategy", "reduce"))
        s2d = None
        if arch["network_class_name"].split(".")[-1] == "PlainConvUNet":
            s2d = make_s2d_engine_net(kwargs, num_out, num_in,
                                      compute_dtype=compute_dtype)
        if s2d is None:
            raise ValueError(
                "turbo pipeline needs the standard PlainConvUNet outer "
                "octave (3^3 stride-1 then 3^3 stride-2); use the regular "
                "predictor for this architecture")
        params = s2d.convert_params(ckpt["network_weights"])
        s2d.to(device)

        schemes = cfg.normalization_schemes
        if num_in != len(schemes):
            raise ValueError(
                f"turbo serves plain multi-channel input ({len(schemes)} "
                f"image channels) but the model wants {num_in} input "
                f"channels (cascade prev-stage one-hot?)")
        channels = []
        for c, scheme in enumerate(schemes):
            tag = _SCHEME_TAGS.get(scheme, "zscore")
            spec = {"scheme": tag}
            if tag == "ct":
                ip = pm.foreground_intensity_properties_per_channel[str(c)]
                spec.update(mean=ip["mean"], std=ip["std"],
                            lower_bound=ip["percentile_00_5"],
                            upper_bound=ip["percentile_99_5"])
            channels.append(spec)
        patch = tuple(cfg.patch_size)
        config = TurboConfig(patch_size=patch, target_spacing=cfg.spacing,
                             num_classes=num_out, channels=channels)
        if channels[0]["scheme"] == "ct":
            ip0 = channels[0]
            config.mean, config.std = ip0["mean"], ip0["std"]
            config.lower_bound = ip0["lower_bound"]
            config.upper_bound = ip0["upper_bound"]
        # plans patch/spacing are already in the engine's (transposed) order
        config.transpose_forward = list(range(len(patch)))
        config.transpose_backward = list(range(len(patch)))
        config.patch_size = patch
        config.target_spacing = tuple(float(s) for s in cfg.spacing)

        engine = SlidingWindowEngine(
            s2d, config.patch_size, num_out, tile_step_size=0.5,
            use_gaussian=True, compute_dtype=compute_dtype,
            sweep_acc_dtype=compute_dtype, shape_bucket=32,
            tile_batch=tile_batch, device=device, aot_cache=aot_cache)
        return cls(engine, config, air_skip=air_skip, **pipeline_kwargs), params

    def predict_file(self, params_list, input_file, output_file: str) -> dict:
        """read -> predict -> write; returns a timing breakdown.
        input_file: one path, or a list of per-channel paths."""
        t0 = time.perf_counter()
        rw = NiftiIOWithReorient()
        files = [input_file] if isinstance(input_file, str) \
            else list(input_file)
        data, props = rw.read_images(files, dtype=None)
        t_read = time.perf_counter()
        seg = self.predict_volume(params_list, data, props["spacing"])
        t_pred = time.perf_counter()
        rw.write_seg(seg, output_file, props)
        t_write = time.perf_counter()
        return {"seconds_total": round(t_write - t0, 3),
                "seconds_read": round(t_read - t0, 3),
                "seconds_predict": round(t_pred - t_read, 3),
                "seconds_write": round(t_write - t_pred, 3),
                "labels_present": sorted(int(x) for x in np.unique(seg))}


def turbo_predict_entry():
    """``fast_nnunet_turbo_torch`` — end-to-end CT serving on the card from
    a trained model folder."""
    ap = argparse.ArgumentParser(
        description="TurboPipeline (PyTorch/CUDA): read -> on-device "
                    "preprocess + s2d sweep -> write")
    ap.add_argument("-i", required=True, help="input NIfTI (or a folder)")
    ap.add_argument("-o", required=True, help="output NIfTI (or a folder)")
    ap.add_argument("-m", required=True, help="trained model folder "
                    "(contains plans.json + fold_X/)")
    ap.add_argument("-f", default=0, help="fold")
    ap.add_argument("-chk", default="checkpoint_final.fnnx")
    ap.add_argument("--no_air_skip", action="store_true",
                    help="disable empty-tile (air) skipping")
    ap.add_argument("--tile_batch", type=int, default=8)
    ap.add_argument("--host_revert", action="store_true",
                    help="fetch the target-grid mask (6-bit packed) and "
                         "revert it on the host (also FNN_HOST_REVERT=1)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain kernel versions)")
    args = ap.parse_args()

    pipe, params = TurboPipeline.from_model_folder(
        args.m, args.f, args.chk, air_skip=not args.no_air_skip,
        tile_batch=args.tile_batch, device=args.device,
        host_revert=args.host_revert or os.environ.get(
            "FNN_HOST_REVERT", "0") == "1")
    if os.path.isdir(args.i):
        from ..utils.io import subfiles
        os.makedirs(args.o, exist_ok=True)
        names = subfiles(args.i, suffix=".nii.gz", join_path=False)
        n_ch = pipe.config.num_input_channels
        if n_ch > 1:
            cases = {}
            for name in names:
                cases.setdefault(re.sub(r"_\d{4}\.nii\.gz$", "", name),
                                 []).append(name)
            for case, files in sorted(cases.items()):
                if len(files) != n_ch:
                    raise ValueError(f"{case}: {len(files)} channel files, "
                                     f"model wants {n_ch}")
                stats = pipe.predict_file(
                    params, [os.path.join(args.i, f) for f in sorted(files)],
                    os.path.join(args.o, case + ".nii.gz"))
                print(case, stats)
        else:
            for name in names:
                stats = pipe.predict_file(params, os.path.join(args.i, name),
                                          os.path.join(args.o, name))
                print(name, stats)
    else:
        print(pipe.predict_file(params, args.i, args.o))


if __name__ == "__main__":
    turbo_predict_entry()
