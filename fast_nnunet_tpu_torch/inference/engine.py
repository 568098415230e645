"""Sliding-window engine: the space-to-depth (s2d) subset of
fast_nnunet_tpu/inference/engine.py ``SlidingWindowEngine`` that the turbo
serving path runs.

The JAX engine traces the whole rolling sweep into one program (a
``lax.scan`` over x-chunks); here it is an eager Python loop over chunks and
tile batches with the same numerics:

- tile starts: the evenly-spread grid rounded down to even
  (:meth:`SlidingWindowEngine._even_floor_steps`), batched by
  ``tile_batch`` with padded slots repeating the last coord at validity 0;
- per batch: gather the tiles, run the s2d network to its pre-head features,
  and fold them into the half-res offset-major accumulator
  (p0/2, Y/2, Z/2, 8K) with kernel C (ops/s2d_accumulate.py);
- per chunk: finalize the rows no later tile touches with kernel B
  (ops/finalize.py), depth-to-space them into the uint8 mask, and retire
  them in place by advancing the cyclic row origin (no accumulator shift).

16-bit accumulators get the reference's x10 gaussian scaling. Fold
ensembles, mirror TTA, the plain (full-res) sweep and ``predict_logits``
are not ported yet.
"""
import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.s2d import params_from_jax
from ..ops.finalize import grouped_argmax
from ..ops.s2d_accumulate import s2d_accumulate, seg_head_blocks
from ..ops.sliding_window import (compute_gaussian,
                                  compute_steps_for_sliding_window,
                                  tile_coords_from_steps)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class PhaseTimer:
    """Device-timeline phase times from CUDA events: ``phase(name)``
    brackets work with an event pair; ``totals()`` synchronizes once and
    returns milliseconds summed per name."""

    def __init__(self):
        self._events = []

    @contextlib.contextmanager
    def phase(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._events.append((name, start, end))

    def totals(self) -> dict:
        torch.cuda.synchronize()
        out: dict = {}
        for name, s, e in self._events:
            out[name] = out.get(name, 0.0) + s.elapsed_time(e)
        return out


class SlidingWindowEngine:
    """s2d sliding-window sweep over a device-resident volume.

    network: an ``S2DPlainConvUNet`` (models/s2d.py) already on ``device``.
    compute_dtype: the network's dtype; sweep_acc_dtype: the accumulator's
    (bfloat16 on the serving path, float32 for the Pallas-contract mode)."""

    def __init__(self, network, patch_size: Sequence[int], num_classes: int,
                 tile_step_size: float = 0.5, use_gaussian: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 sweep_acc_dtype: torch.dtype = torch.float32,
                 shape_bucket: int = 32, tile_batch: int = 8, device=None):
        self.network = network
        self.patch_size = tuple(int(p) for p in patch_size)
        if any(p % 2 for p in self.patch_size):
            raise ValueError(f"s2d sweep needs even patch dims, got "
                             f"{self.patch_size}")
        self.num_classes = int(num_classes)
        self.tile_step_size = float(tile_step_size)
        self.use_gaussian = bool(use_gaussian)
        self.compute_dtype = compute_dtype
        self.sweep_acc_dtype = sweep_acc_dtype
        self.shape_bucket = int(shape_bucket)
        self.tile_batch = max(1, int(tile_batch))
        self.device = resolve_device(device)
        if self.use_gaussian:
            g = compute_gaussian(self.patch_size).astype(np.float32)
        else:
            g = np.ones(self.patch_size, dtype=np.float32)
        self._gaussian_base = g
        self._g_s2d = {}
        self._loaded_params = None
        #: optional PhaseTimer; the sweep brackets forward/accumulate/finalize
        self.timer: Optional[PhaseTimer] = None

    def phase(self, name: str):
        """Bracket work with the timer's event pair (no-op without one)."""
        return self.timer.phase(name) if self.timer is not None \
            else contextlib.nullcontext()

    # ------------------------------------------------------------- geometry
    def _gaussian_for(self, dtype: torch.dtype) -> np.ndarray:
        g = self._gaussian_base
        if torch.finfo(dtype).bits <= 16:
            g = g * 10.0  # headroom for low-precision accumulation
        return g

    def gaussian_s2d(self, dtype: torch.dtype) -> torch.Tensor:
        """(p0/2, py/2, pz/2, 8) f32 s2d gaussian on the device, cached."""
        if dtype not in self._g_s2d:
            p0h, pyh, pzh = (p // 2 for p in self.patch_size)
            g = self._gaussian_for(dtype).reshape(p0h, 2, pyh, 2, pzh, 2)
            g = g.transpose(0, 2, 4, 1, 3, 5).reshape(p0h, pyh, pzh, 8)
            self._g_s2d[dtype] = torch.as_tensor(
                np.ascontiguousarray(g, np.float32), device=self.device)
        return self._g_s2d[dtype]

    def _even_floor_steps(self, tight: Tuple[int, ...]) -> List[List[int]]:
        """Evenly-spread steps with every start rounded DOWN to even (s2d
        block alignment); the last start stays tight - p."""
        steps = compute_steps_for_sliding_window(tight, self.patch_size,
                                                 self.tile_step_size)
        return [sorted(set(int(x) - (int(x) % 2) for x in s)) for s in steps]

    def _batched_coords(self, coords: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Pad to a multiple of the batch with copies of the last coord at
        validity 0; returns (coords (nb, B, dim), valid (nb, B))."""
        n_real = len(coords)
        B = min(self.tile_batch, max(1, n_real))
        n_tiles = _round_up(n_real, B)
        if n_tiles > n_real:
            coords = np.concatenate(
                [coords, np.repeat(coords[-1:], n_tiles - n_real, axis=0)])
        valid = np.zeros(n_tiles, dtype=np.float32)
        valid[:n_real] = 1.0
        return (coords.reshape(n_tiles // B, B, -1).astype(np.int32),
                valid.reshape(n_tiles // B, B))

    def s2d_sweep_plan(self, spatial: Sequence[int]
                       ) -> Tuple[Tuple[int, ...], List[List[int]]]:
        """(vol_shape, steps) for a (C, *spatial) volume: vol_shape is the
        padded layout a producer must emit, steps the even-floored starts."""
        p0 = self.patch_size[0]
        x_tight = _round_up(max(int(spatial[0]), p0), 2)
        tight_rest = tuple(_round_up(max(int(s), p), 2)
                           for s, p in zip(spatial[1:], self.patch_size[1:]))
        steps = self._even_floor_steps((x_tight, *tight_rest))
        plane_padded = tuple(_round_up(_round_up(t, self.shape_bucket), 2)
                             for t in tight_rest)
        for s, pl_, p in zip(steps[1:], plane_padded, self.patch_size[1:]):
            if s[-1] + p > pl_:
                raise AssertionError(
                    f"tail start {s[-1]} + patch {p} exceeds padded plane {pl_}")
        return (x_tight, *plane_padded), steps

    def sweep_tiles(self, steps) -> Tuple[List[int], np.ndarray, np.ndarray]:
        """(starts_x, coords_b (nb, B, 3) with x = 0, valid_b (nb, B))."""
        coords_yz = tile_coords_from_steps(steps[1:])
        coords_full = np.concatenate(
            [np.zeros((len(coords_yz), 1), np.int32), coords_yz], axis=1)
        coords_b, valid_b = self._batched_coords(coords_full)
        return [int(s) for s in steps[0]], coords_b, valid_b

    # ---------------------------------------------------------------- sweep
    def load_params(self, params_list) -> None:
        """Load a JAX-package s2d parameter tree (or a one-element list of
        them) into the network, unless it is the tree already loaded."""
        if isinstance(params_list, (list, tuple)):
            if len(params_list) != 1:
                raise NotImplementedError(
                    "fold ensembles are not ported yet (pass one fold)")
            params_list = params_list[0]
        if params_list is not self._loaded_params:
            params_from_jax(self.network, params_list)
            self._loaded_params = params_list

    def run_s2d_sweep(self, vol: torch.Tensor, spatial: Sequence[int],
                      valid_chunks: Optional[np.ndarray] = None
                      ) -> torch.Tensor:
        """Sweep a device-resident padded volume ``vol`` (C, *vol_shape) in
        the compute dtype with the network's current weights.
        ``valid_chunks`` (n_chunks, nb, B) overrides the shared tile
        validity per chunk (air skipping: a batch whose flags are all 0
        skips its forward). Returns the uint8 mask at vol_shape on the
        device."""
        vol_shape, steps = self.s2d_sweep_plan(spatial)
        if tuple(vol.shape[1:]) != vol_shape:
            raise ValueError(f"device volume {tuple(vol.shape)} != planned "
                             f"(C, {vol_shape})")
        starts_x, coords_b, valid_b = self.sweep_tiles(steps)
        nb, B = valid_b.shape
        p0, py, pz = self.patch_size
        p0h, pyh, pzh = p0 // 2, py // 2, pz // 2
        K = self.num_classes
        plane = vol_shape[1:]
        plane_h = (plane[0] // 2, plane[1] // 2)
        acc_dtype = self.sweep_acc_dtype
        g_s2d = self.gaussian_s2d(acc_dtype)
        w_dense, b_head = self.network.seg_head_params()
        w_blocks = seg_head_blocks(w_dense.float()).contiguous()
        b_head = b_head.float().contiguous()
        coords_h = coords_b[..., 1:] // 2                    # (nb, B, 2)

        acc = torch.zeros((p0h, *plane_h, 8 * K), dtype=acc_dtype,
                          device=vol.device)
        seg = torch.empty(vol_shape, dtype=torch.uint8, device=vol.device)
        row_base = 0
        with torch.no_grad():
            for k, x0 in enumerate(starts_x):
                valid_c = valid_b if valid_chunks is None else valid_chunks[k]
                for bi in range(nb):
                    if valid_chunks is not None and not valid_c[bi].any():
                        continue  # whole-air batch: no forward at all
                    with self.phase("forward"):
                        tiles = torch.stack([
                            vol[:, x0:x0 + p0, y:y + py, z:z + pz]
                            for _, y, z in coords_b[bi]])
                        feats = self.network(tiles, return_features=True)
                    with self.phase("accumulate"):
                        s2d_accumulate(acc, feats, g_s2d, w_blocks, b_head,
                                       coords_h[bi], valid_c[bi], row_base)
                last = k == len(starts_x) - 1
                n_rows = p0h if last else (starts_x[k + 1] - x0) // 2
                with self.phase("finalize"):
                    cls8 = grouped_argmax(acc, K, n_rows, row_base,
                                          0 if last else n_rows)
                    seg[x0:x0 + 2 * n_rows] = _revert_cls(cls8, plane)
                row_base = (row_base + n_rows) % p0h
        return seg

    def predict_segmentation_sweep_s2d(self, params_list,
                                       volume: np.ndarray) -> np.ndarray:
        """(C, *spatial) float volume (already preprocessed) -> uint8 mask,
        zero-padded to the sweep layout (the JAX method's contract)."""
        self.load_params(params_list)
        spatial = volume.shape[1:]
        vol_shape, _ = self.s2d_sweep_plan(spatial)
        vol = torch.zeros((volume.shape[0], *vol_shape),
                          dtype=self.compute_dtype, device=self.device)
        vol[(slice(None),) + tuple(slice(0, s) for s in spatial)] = \
            torch.as_tensor(np.asarray(volume, np.float32)).to(
                self.device, self.compute_dtype)
        seg = self.run_s2d_sweep(vol, spatial)
        return seg[tuple(slice(0, s) for s in spatial)].cpu().numpy()


def _revert_cls(cls8: torch.Tensor, plane: Tuple[int, int]) -> torch.Tensor:
    """(n, 8, Yh, Zh) uint8 offset planes -> full-res (2n, Y, Z)."""
    n = cls8.shape[0]
    c = cls8.reshape(n, 2, 2, 2, plane[0] // 2, plane[1] // 2)
    return c.permute(0, 1, 4, 2, 5, 3).reshape(2 * n, *plane)
