"""Sliding-window engine — the port of fast_nnunet_tpu/inference/engine.py
``SlidingWindowEngine``, for a U-Net of models/unet.py (plain or residual
encoder, InstanceNorm or BatchNorm) or a
space-to-depth ``S2DPlainConvUNet`` (models/s2d.py).

The JAX engine traces each route into one program (``lax.scan`` over tile
batches and x-chunks); here each is an eager Python loop with the same
numerics. Ported routes:

- ``predict_logits``: grid-exact gaussian-weighted logits over the padded
  volume, one fused accumulator whose channel K carries the weight sum; the
  multi-axis chunk grid when the accumulator would exceed
  ``max_accumulator_bytes``, merged on the host (a temp-file memmap above
  ``FNN_LOGITS_HOST_BYTES``).
- ``predict_segmentation_sweep``: the rolling full-res sweep along x —
  per chunk, accumulate its (y, z) tile batches, argmax the rows no later
  chunk touches into the uint8 mask, shift the accumulator. With
  ``use_fused_accumulate`` every accumulate is kernel D
  (ops/scatter_accumulate.py), on the JAX route's grid quantised to
  16-aligned strides with the tiles batched by coset, or on the reference's
  evenly spread grid where the patch is too small for 16-aligned strides;
  otherwise it is the reference grid and the plain per-tile
  read-modify-write.
- ``run_s2d_sweep``: the s2d rolling sweep of the turbo path — forward to
  the pre-head s2d features, kernel C (ops/s2d_accumulate.py) per tile
  batch, kernel B (ops/finalize.py) per chunk with a cyclic row origin.

Fold ensembles (logits averaged over folds) and mirror TTA (averaged over
all flip combinations) run in every plain-network forward; the s2d sweep
takes one fold and no mirroring. 16-bit accumulators get the reference's
x10 gaussian scaling. The coset and streamed sweeps are not ported (no
option selects them); 2D-over-slices raises ``NotImplementedError``.
"""
import contextlib
import copy
import itertools
import math
import os
import tempfile
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import s2d as s2d_model
from ..models import unet as unet_model
from ..ops.finalize import grouped_argmax
from ..ops.s2d_accumulate import s2d_accumulate, seg_head_blocks
from ..ops.scatter_accumulate import MAX_TILES, fused_scatter_accumulate
from ..ops.sliding_window import (compute_gaussian,
                                  compute_steps_for_sliding_window,
                                  tile_coords_from_steps)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _flip_combos(mirror_axes: Tuple[int, ...]) -> List[Tuple[int, ...]]:
    """All subsets of the mirror axes (identity first); axes are spatial
    indices 0..dim-1."""
    combos = [()]
    for ax in mirror_axes:
        combos += [c + (ax,) for c in combos]
    return combos


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
    """Sliding-window prediction over a (C, *spatial) volume.

    network: a ``PlainConvUNet`` or an ``S2DPlainConvUNet``, already on
    ``device``. compute_dtype: what tiles are cast to; acc_dtype: the
    ``predict_logits`` accumulator; sweep_acc_dtype: the sweeps'
    accumulator (None: acc_dtype). use_fused_accumulate: the JAX engine's
    ``use_pallas_accumulate`` — the plain sweep accumulates every batch with
    kernel D, on the quantised grid with disjoint same-coset batches where
    the patch allows 16-aligned strides, else on the reference grid (off by
    default, as in JAX; ``predict_logits`` keeps the plain route either
    way, as there)."""

    def __init__(self, network, patch_size: Sequence[int], num_classes: int,
                 tile_step_size: float = 0.5, use_gaussian: bool = True,
                 mirror_axes: Tuple[int, ...] = (),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 acc_dtype: torch.dtype = torch.float32,
                 sweep_acc_dtype: Optional[torch.dtype] = None,
                 shape_bucket: int = 32, tile_batch: int = 8,
                 max_accumulator_bytes: int = 4 * 1024 ** 3,
                 use_fused_accumulate: bool = False, device=None):
        self.network = network
        self.is_s2d = isinstance(network, s2d_model.S2DPlainConvUNet)
        self.patch_size = tuple(int(p) for p in patch_size)
        self.dim = len(self.patch_size)
        if self.is_s2d and any(p % 2 for p in self.patch_size):
            raise ValueError(f"s2d sweep needs even patch dims, got "
                             f"{self.patch_size}")
        self.num_classes = int(num_classes)
        self.tile_step_size = float(tile_step_size)
        self.use_gaussian = bool(use_gaussian)
        self.mirror_axes = tuple(int(a) for a in mirror_axes)
        self.compute_dtype = compute_dtype
        self.acc_dtype = acc_dtype
        self.sweep_acc_dtype = acc_dtype if sweep_acc_dtype is None \
            else sweep_acc_dtype
        self.shape_bucket = int(shape_bucket)
        self.tile_batch = max(1, int(tile_batch))
        self.max_accumulator_bytes = int(max_accumulator_bytes)
        self.use_fused_accumulate = bool(use_fused_accumulate)
        if self.use_fused_accumulate and self.tile_batch > MAX_TILES:
            raise ValueError(f"tile_batch {self.tile_batch}: kernel D takes "
                             f"up to {MAX_TILES} tiles per launch")
        self.device = resolve_device(device)
        if self.use_gaussian:
            g = compute_gaussian(self.patch_size).astype(np.float32)
        else:
            g = np.ones(self.patch_size, dtype=np.float32)
        self._gaussian_base = g
        self._g_cache = {}
        self._folds: Tuple[list, list] = ([], [])  # (trees, modules)
        #: optional PhaseTimer; the sweeps bracket forward/accumulate/finalize
        self.timer: Optional[PhaseTimer] = None

    def phase(self, name: str):
        """Bracket work with the timer's event pair (no-op without one)."""
        return self.timer.phase(name) if self.timer is not None \
            else contextlib.nullcontext()

    # ------------------------------------------------------------- geometry
    def _acc_channels(self) -> int:
        c = self.num_classes + 1
        if self.use_fused_accumulate:
            c = _round_up(c, 8)  # kernel D takes C % 8 == 0 (62 -> 64)
        return c

    def _gaussian_for(self, dtype: torch.dtype) -> np.ndarray:
        g = self._gaussian_base
        if torch.finfo(dtype).bits <= 16:
            g = g * 10.0  # headroom for low-precision accumulation
        return g

    def _cached(self, key, make):
        if key not in self._g_cache:
            self._g_cache[key] = make()
        return self._g_cache[key]

    def gaussian_tensor(self, dtype: torch.dtype) -> torch.Tensor:
        """(px, py, pz) f32 gaussian (x10 for a 16-bit accumulator) on the
        device — the weights of the plain accumulate route."""
        return self._cached(("g", dtype), lambda: torch.as_tensor(
            self._gaussian_for(dtype), device=self.device))

    def gaussian_flat(self, dtype: torch.dtype, channels: int) -> torch.Tensor:
        """(px, py, pz * C) gaussian in the accumulator dtype, broadcast over
        channels — kernel D's ``gauss_flat``."""
        def make():
            g = torch.as_tensor(self._gaussian_for(dtype), device=self.device)
            px, py, pz = self.patch_size
            return g.to(dtype)[..., None].expand(
                px, py, pz, channels).reshape(px, py, pz * channels)
        return self._cached(("flat", dtype, channels), make)

    def gaussian_s2d(self, dtype: torch.dtype) -> torch.Tensor:
        """(p0/2, py/2, pz/2, 8) f32 s2d gaussian on the device, cached."""
        def make():
            p0h, pyh, pzh = (p // 2 for p in self.patch_size)
            g = self._gaussian_for(dtype).reshape(p0h, 2, pyh, 2, pzh, 2)
            g = g.transpose(0, 2, 4, 1, 3, 5).reshape(p0h, pyh, pzh, 8)
            return torch.as_tensor(np.ascontiguousarray(g, np.float32),
                                   device=self.device)
        return self._cached(("s2d", dtype), make)

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

    def _batched_coords_coset(self, coords: np.ndarray,
                              strides: Tuple[int, ...]
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """Fused-route batching (a copy of the JAX method): on the uniform
        quantised grid, tiles whose per-axis step indices differ by
        q = ceil(patch / stride) share no voxels, so group them by their
        phase tuple (idx % q). Returns (coords (nb, B, dim), n_real (nb,)):
        batches never span phase groups; padded slots repeat the last real
        coord and lie beyond the count."""
        dims = coords.shape[1]
        B = min(self.tile_batch, max(1, len(coords)))
        qs, idxs = [], []
        for a in range(1, dims):  # axis 0 (x) is constant within a chunk
            stride = max(1, strides[a - 1])
            qs.append(-(-self.patch_size[a] // stride))
            idxs.append(coords[:, a] // stride)
        groups: dict = {}
        for t in range(len(coords)):
            key = tuple(int(idxs[a][t]) % qs[a] for a in range(len(qs)))
            groups.setdefault(key, []).append(t)
        batches, counts = [], []
        for key in sorted(groups):
            members = groups[key]
            for s in range(0, len(members), B):
                chunk = members[s:s + B]
                n = len(chunk)
                while len(chunk) < B:
                    chunk.append(chunk[-1])
                batches.append(coords[chunk])
                counts.append(n)
        return (np.stack(batches).astype(np.int32),
                np.asarray(counts, np.int32))

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

    def _sweep_grid(self, spatial: Sequence[int]):
        """The plain sweep's layout (the JAX method's grid, either kind):
        (vol_shape, starts_x, coords_b (nb, B, 3) with x = 0, valid_b —
        validity flags (nb, B), or real-item counts (nb,) on the fused
        route — and whether the fused route runs). The fused route takes
        the JAX route's quantised grid where the patch allows 16-aligned
        y/z strides. Elsewhere, where JAX falls back to its XLA accumulate,
        kernel D runs on the reference grid: it applies overlapping tiles in
        order and takes any in-bounds start, and the padding slots of
        ``_batched_coords`` lie at each batch's tail, so the count of valid
        slots is the batch's n_real."""
        fused = self.use_fused_accumulate
        quantised = fused and all(
            int(p * self.tile_step_size) >= 16 for p in self.patch_size[1:])
        p0 = self.patch_size[0]
        x_tight = max(int(spatial[0]), p0)
        tight_rest = tuple(max(int(s), p)
                           for s, p in zip(spatial[1:], self.patch_size[1:]))
        if quantised:
            # uniform 16-aligned strides on every axis (x included)
            stride = max(16, (int(p0 * self.tile_step_size) // 16) * 16)
            n = int(np.ceil((x_tight - p0) / stride)) + 1 if x_tight > p0 else 1
            starts_x = tuple(k * stride for k in range(n))
            x_extent = starts_x[-1] + p0
            steps_rest, needed = [], []
            for t, p in zip(tight_rest, self.patch_size[1:]):
                ps = max(16, (int(p * self.tile_step_size) // 16) * 16)
                n = int(np.ceil((t - p) / ps)) + 1 if t > p else 1
                steps_rest.append([k * ps for k in range(n)])
                needed.append((n - 1) * ps + p)
            tight_rest = tuple(max(t, n_) for t, n_ in zip(tight_rest, needed))
        else:
            steps = compute_steps_for_sliding_window(
                (x_tight, *tight_rest), self.patch_size, self.tile_step_size)
            starts_x = tuple(int(s) for s in steps[0])
            x_extent = x_tight
            steps_rest = steps[1:]
        coords_yz = tile_coords_from_steps(steps_rest)
        coords_full = np.concatenate(
            [np.zeros((len(coords_yz), 1), np.int32), coords_yz], axis=1)
        if quantised:
            plane_strides = tuple(
                s[1] - s[0] if len(s) > 1 else self.patch_size[a + 1]
                for a, s in enumerate(steps_rest))
            coords_b, valid_b = self._batched_coords_coset(coords_full,
                                                           plane_strides)
        else:
            coords_b, valid_b = self._batched_coords(coords_full)
            if fused:
                valid_b = valid_b.sum(1).astype(np.int32)
        plane_padded = tuple(_round_up(t, self.shape_bucket)
                             for t in tight_rest)
        return ((x_extent, *plane_padded), starts_x, coords_b, valid_b, fused)

    # --------------------------------------------------------------- weights
    def load_params(self, params_list) -> list:
        """Load one JAX-package parameter tree per fold (a tree or a list of
        them) into the network and, from the second fold on, into copies of
        it, unless those trees are the ones loaded already. Returns the fold
        modules. The s2d network takes one fold."""
        trees = list(params_list) if isinstance(params_list, (list, tuple)) \
            else [params_list]
        if not trees:
            raise ValueError("no parameters given")
        loaded, nets = self._folds
        if len(trees) == len(loaded) and \
                all(a is b for a, b in zip(trees, loaded)):
            return nets
        if self.is_s2d:
            if len(trees) != 1:
                raise NotImplementedError(
                    "fold ensembles on the s2d sweep are not ported yet "
                    "(pass one fold)")
            s2d_model.params_from_jax(self.network, trees[0])
            nets = [self.network]
        else:
            nets = [self.network] + [copy.deepcopy(self.network)
                                     for _ in trees[1:]]
            for net, tree in zip(nets, trees):
                unet_model.params_from_jax(net, tree)
                net.eval()  # a BatchNorm predicts with its running averages
        self._folds = (trees, nets)  # holds the trees: identity stays valid
        return nets

    def _tile_step_fn(self, nets: list) -> Callable:
        """forward(x (B, C, *patch)) -> f32 logits (B, K, *patch), averaged
        over mirror combinations and then over folds (the JAX method's
        order of sums)."""
        combos = _flip_combos(self.mirror_axes)
        inv_n = 1.0 / len(combos)

        def forward_one(net, x):
            acc = None
            for combo in combos:
                dims = tuple(a + 2 for a in combo)
                xin = torch.flip(x, dims) if combo else x
                out = net(xin).float()
                out = torch.flip(out, dims) if combo else out
                acc = out if acc is None else acc + out
            return acc * inv_n

        def forward(x):
            total = forward_one(nets[0], x)
            for net in nets[1:]:
                total = total + forward_one(net, x)
            return total if len(nets) == 1 else total / len(nets)

        return forward

    def _gather(self, vol: torch.Tensor, coords: np.ndarray,
                x_offset: int = 0) -> torch.Tensor:
        """(B, C, *patch) tiles of a (C, *S) device volume, in the compute
        dtype."""
        px, py, pz = self.patch_size
        return torch.stack([vol[:, x + x_offset:x + x_offset + px, y:y + py,
                                z:z + pz] for x, y, z in coords]
                           ).to(self.compute_dtype)

    def _accumulate_batch(self, a: torch.Tensor, logits: torch.Tensor,
                          coords_b: np.ndarray, valid_b, acc_dtype: torch.dtype,
                          fused: bool = False) -> torch.Tensor:
        """Add one batch's logits (B, K, *patch) f32 into the channels-last
        accumulator ``a`` (*S, C) in place; channel K sums the gaussian
        weights. Plain route (the JAX XLA branch): per tile,
        ``a[tile] += cat(logits * g * valid, g * valid)`` cast to acc_dtype;
        slots with validity 0 are skipped (their contribution is exactly
        zero). Fused route: kernel D, ``valid_b`` being the batch's
        real-item count, the weight channel a constant-1 logit and channels
        zero-padded to C."""
        K = self.num_classes
        px, py, pz = self.patch_size
        if fused:
            C = a.shape[-1]
            lg = torch.empty((logits.shape[0], px, py, pz, C), dtype=acc_dtype,
                             device=a.device)
            lg[..., :K] = logits.permute(0, 2, 3, 4, 1)
            lg[..., K] = 1
            lg[..., K + 1:] = 0
            return fused_scatter_accumulate(
                a, lg, self.gaussian_flat(acc_dtype, C), coords_b,
                int(valid_b))
        g = self.gaussian_tensor(acc_dtype)
        for b, (x, y, z) in enumerate(coords_b):
            v = float(valid_b[b])
            if v == 0.0:
                continue
            gw = (g * v)[..., None]
            contrib = torch.cat([logits[b].permute(1, 2, 3, 0) * gw, gw],
                                -1).to(acc_dtype)
            sl = (slice(x, x + px), slice(y, y + py), slice(z, z + pz))
            a[sl] = a[sl] + contrib
        return a

    # ---------------------------------------------------------------- logits
    def _prepare_sub(self, volume: np.ndarray, steps: List[List[int]]):
        """Pad a (sub)volume to the bucketed shape on the device in the
        compute dtype, and build the batched tile coords and the slice that
        undoes the padding."""
        spatial = volume.shape[1:]
        padded = tuple(_round_up(max(s, p), self.shape_bucket)
                       for s, p in zip(spatial, self.patch_size))
        coords, valid = self._batched_coords(tile_coords_from_steps(steps))
        vol = torch.zeros((volume.shape[0], *padded), dtype=self.compute_dtype,
                          device=self.device)
        sl = tuple(slice(0, s) for s in spatial)
        vol[(slice(None),) + sl] = torch.as_tensor(
            np.asarray(volume, np.float32)).to(self.device, self.compute_dtype)
        return vol, coords, valid, sl, padded

    def _acc_bytes(self, spatial) -> int:
        padded = [_round_up(max(s, p), self.shape_bucket)
                  for s, p in zip(spatial, self.patch_size)]
        # x2: the JAX runner's scan carry and output buffers coexist; kept
        # so both packages choose the same route for the same budget
        return int(math.prod(padded) * self._acc_channels()
                   * self.acc_dtype.itemsize * 2)

    def _run_logits(self, vol: torch.Tensor, coords: np.ndarray,
                    valid: np.ndarray, padded, forward) -> torch.Tensor:
        """(*padded, K+1) acc_dtype accumulator of one (sub)volume."""
        acc = torch.zeros((*padded, self.num_classes + 1),
                          dtype=self.acc_dtype, device=self.device)
        with torch.no_grad():
            for bi in range(len(coords)):
                with self.phase("forward"):
                    logits = forward(self._gather(vol, coords[bi]))
                with self.phase("accumulate"):
                    self._accumulate_batch(acc, logits, coords[bi],
                                           valid[bi], self.acc_dtype)
        return acc

    def _check_dims(self, volume: np.ndarray) -> None:
        if self.dim != 3 or volume.ndim != 4:
            raise NotImplementedError(
                "only 3D patches on (C, X, Y, Z) volumes are ported "
                "(2D-over-slices is not)")

    def predict_logits(self, params_list, volume: np.ndarray,
                       steps: Optional[List[List[int]]] = None) -> np.ndarray:
        """volume (C, *spatial) -> gaussian-weighted averaged logits
        (K, *spatial), float32, fold-ensembled and mirror-averaged. Takes the
        chunk grid when the accumulator would exceed the memory budget."""
        self._check_dims(volume)
        forward = self._tile_step_fn(self.load_params(params_list))
        spatial = volume.shape[1:]
        if self._acc_bytes(spatial) > self.max_accumulator_bytes and \
                any(s > p for s, p in zip(spatial, self.patch_size)):
            return self._predict_logits_chunked(forward, volume, steps)
        if steps is None:
            tight = tuple(max(s, p) for s, p in zip(spatial, self.patch_size))
            steps = compute_steps_for_sliding_window(tight, self.patch_size,
                                                     self.tile_step_size)
        vol, coords, valid, sl, padded = self._prepare_sub(volume, steps)
        acc = self._run_logits(vol, coords, valid, padded, forward)
        K = self.num_classes
        a = acc[sl]
        logits = a[..., :K].float() / a[..., K:K + 1].float()
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError("Non-finite values in accumulated logits — "
                               "consider acc_dtype=float32")
        return logits.permute(3, 0, 1, 2).contiguous().cpu().numpy()

    def _make_chunk_grid(self, steps: List[List[int]]) -> List[List[List[int]]]:
        """Group consecutive tile starts per axis so that any chunk's padded
        accumulator fits the budget. Returns per-axis lists of start
        groups."""
        group_len = [len(s) for s in steps]

        def groups_for(axis):
            s = steps[axis]
            gl = group_len[axis]
            return [s[i:i + gl] for i in range(0, len(s), gl)]

        def max_extent(axis):
            return max(_round_up(g[-1] + self.patch_size[axis] - g[0],
                                 self.shape_bucket) for g in groups_for(axis))

        def total_bytes():
            prod = math.prod(max_extent(a) for a in range(self.dim))
            return prod * (self.num_classes + 1) * \
                self.acc_dtype.itemsize * 2

        while total_bytes() > self.max_accumulator_bytes:
            candidates = [a for a in range(self.dim) if group_len[a] > 1]
            if not candidates:
                break
            a = max(candidates, key=max_extent)
            group_len[a] = max(1, group_len[a] // 2)
        return [groups_for(a) for a in range(self.dim)]

    def _predict_logits_chunked(self, forward, volume: np.ndarray,
                                steps: Optional[List[List[int]]] = None
                                ) -> np.ndarray:
        """Host-merged chunk grid. Above FNN_LOGITS_HOST_BYTES (default
        8 GiB) the merged logits back onto a temp-file ``np.memmap``
        (``self._logits_memmap_path``; the caller may delete it), and
        FNN_LOGITS_HOST_DTYPE=float16 halves them (converted on the device
        before the copy out)."""
        spatial = volume.shape[1:]
        if steps is None:
            tight = tuple(max(s, p) for s, p in zip(spatial, self.patch_size))
            steps = compute_steps_for_sliding_window(tight, self.patch_size,
                                                     self.tile_step_size)
        # plan for 3 concurrent chunk buffers, as the JAX engine does for
        # its 1-deep fetch pipeline, so both packages pick the same grid
        saved_budget = self.max_accumulator_bytes
        self.max_accumulator_bytes = int(saved_budget * 2 / 3)
        try:
            grid = self._make_chunk_grid(steps)
        finally:
            self.max_accumulator_bytes = saved_budget

        K = self.num_classes
        host_dtype = np.dtype(os.environ.get("FNN_LOGITS_HOST_DTYPE",
                                             "float32"))
        budget = int(os.environ.get("FNN_LOGITS_HOST_BYTES", 8 * 1024 ** 3))
        out_bytes = K * int(math.prod(spatial)) * host_dtype.itemsize
        if out_bytes > budget:
            tmp = tempfile.NamedTemporaryFile(prefix="fnn_logits_",
                                              delete=False)
            tmp.close()
            out = np.memmap(tmp.name, dtype=host_dtype, mode="w+",
                            shape=(K,) + tuple(spatial))
            self._logits_memmap_path = tmp.name
        else:
            out = np.zeros((K,) + tuple(spatial), dtype=host_dtype)
        wtot = np.zeros(spatial, dtype=np.float32)
        t_host = torch.float16 if host_dtype.itemsize == 2 else torch.float32

        for combo in itertools.product(*grid):
            starts = [g[0] for g in combo]
            exts = [max(g[-1] + p - g[0], p)
                    for g, p in zip(combo, self.patch_size)]
            sub_sl = tuple(slice(s0, s0 + e) for s0, e in zip(starts, exts))
            sub = volume[(slice(None),) + sub_sl]
            local_steps = [[x - s0 for x in g] for g, s0 in zip(combo, starts)]
            vol, coords, valid, sl, padded = self._prepare_sub(sub, local_steps)
            acc = self._run_logits(vol, coords, valid, padded, forward)
            valid_sl = tuple(slice(s0, min(s0 + e, spatial[a]))
                             for a, (s0, e) in enumerate(zip(starts, exts)))
            local = tuple(slice(0, v.stop - v.start) for v in valid_sl)
            a = acc[sl][local]
            acc_np = a[..., :K].to(t_host).cpu().numpy()
            out[(slice(None),) + valid_sl] += np.moveaxis(acc_np, -1, 0
                                                          ).astype(host_dtype)
            wtot[valid_sl] += a[..., K].float().cpu().numpy()

        # finalize in x-slabs so a memmap-backed `out` never fully
        # materializes
        slab = max(1, int(np.ceil(spatial[0] / max(1, len(grid[0])))))
        for x0 in range(0, spatial[0], slab):
            xs = slice(x0, min(x0 + slab, spatial[0]))
            block = out[:, xs] / wtot[None, xs]
            if not np.isfinite(block).all():
                raise RuntimeError("Non-finite values in accumulated logits")
            out[:, xs] = block
        return out

    # ------------------------------------------------------------ plain sweep
    def run_sweep(self, vol: torch.Tensor, plan, forward) -> torch.Tensor:
        """The rolling full-res sweep over a device volume (C, *vol_shape)
        laid out by ``plan`` (:meth:`_sweep_grid`). The accumulator holds
        patch[0] rows; each chunk accumulates its tile batches (volume reads
        at x0), argmaxes max_roll rows at x0 into the mask (rows not yet
        complete are overwritten by the next chunk), then shifts by that
        chunk's roll. The last chunk writes its whole window. Returns the
        uint8 mask at vol_shape on the device."""
        vol_shape, starts_x, coords_b, valid_b, fused = plan
        p0 = self.patch_size[0]
        K = self.num_classes
        plane = tuple(vol_shape[1:])
        acc_dtype = self.sweep_acc_dtype
        rolls = [starts_x[k + 1] - starts_x[k]
                 for k in range(len(starts_x) - 1)]
        if len(set(rolls)) > 2:
            raise AssertionError(f"evenly-spread steps produced >2 roll "
                                 f"values: {sorted(set(rolls))}")
        max_roll = max(rolls) if rolls else 0
        C_acc = self._acc_channels() if fused else K + 1
        acc = torch.zeros((p0, *plane, C_acc), dtype=acc_dtype,
                          device=vol.device)
        spare = None
        seg = torch.zeros(tuple(vol_shape), dtype=torch.uint8,
                          device=vol.device)
        with torch.no_grad():
            for k, x0 in enumerate(starts_x):
                for bi in range(len(coords_b)):
                    with self.phase("forward"):
                        logits = forward(self._gather(vol, coords_b[bi], x0))
                    with self.phase("accumulate"):
                        self._accumulate_batch(acc, logits, coords_b[bi],
                                               valid_b[bi], acc_dtype, fused)
                last = k == len(starts_x) - 1
                n_rows = p0 if last else max_roll
                with self.phase("finalize"):
                    # argmax(a / w) == argmax(a): w > 0 is shared by classes
                    seg[x0:x0 + n_rows] = acc[:n_rows, ..., :K].argmax(-1).to(
                        torch.uint8)
                    if not last:
                        r = rolls[k]
                        if spare is None:
                            spare = torch.empty_like(acc)
                        spare[:p0 - r].copy_(acc[r:])
                        spare[p0 - r:].zero_()
                        acc, spare = spare, acc
        return seg

    def predict_segmentation_sweep(self, params_list,
                                   volume: np.ndarray) -> np.ndarray:
        """Whole-volume argmax segmentation with the rolling sweep (the JAX
        method's contract). Grid-exact on the reference grid (matches
        ``predict_logits(...).argmax(0)`` for the same accumulator dtype);
        with ``use_fused_accumulate`` every accumulate is kernel D, on
        uniform 16-aligned strides where the patch allows them."""
        self._check_dims(volume)
        forward = self._tile_step_fn(self.load_params(params_list))
        spatial = volume.shape[1:]
        plan = self._sweep_grid(spatial)
        vol = torch.zeros((volume.shape[0], *plan[0]),
                          dtype=self.compute_dtype, device=self.device)
        vol[(slice(None),) + tuple(slice(0, s) for s in spatial)] = \
            torch.as_tensor(np.asarray(volume, np.float32)).to(
                self.device, self.compute_dtype)
        seg = self.run_sweep(vol, plan, forward)
        return seg[tuple(slice(0, s) for s in spatial)].cpu().numpy()

    # -------------------------------------------------------------- s2d sweep
    def run_s2d_sweep(self, vol: torch.Tensor, spatial: Sequence[int],
                      valid_chunks: Optional[np.ndarray] = None
                      ) -> torch.Tensor:
        """Sweep a device-resident padded volume ``vol`` (C, *vol_shape) in
        the compute dtype with the s2d network's current weights.
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
        # in the compute dtype: bf16 weights let kernel C fuse its head dot
        w_blocks = seg_head_blocks(w_dense).contiguous()
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

    # ------------------------------------------------------------- dispatch
    def predict_segmentation(self, params_list,
                             volume: np.ndarray) -> np.ndarray:
        """Argmax segmentation: above the accumulator budget one of the
        sweeps (s2d for an s2d network without mirroring, else the plain
        rolling sweep); otherwise the grid-exact logits path."""
        self._check_dims(volume)
        spatial = volume.shape[1:]
        if self._acc_bytes(spatial) > self.max_accumulator_bytes:
            if self.is_s2d and not self.mirror_axes:
                return self.predict_segmentation_sweep_s2d(params_list, volume)
            return self.predict_segmentation_sweep(params_list, volume)
        return self.predict_logits(params_list, volume).argmax(0)


def _revert_cls(cls8: torch.Tensor, plane: Tuple[int, int]) -> torch.Tensor:
    """(n, 8, Yh, Zh) uint8 offset planes -> full-res (2n, Y, Z)."""
    n = cls8.shape[0]
    c = cls8.reshape(n, 2, 2, 2, plane[0] // 2, plane[1] // 2)
    return c.permute(0, 1, 4, 2, 5, 3).reshape(2 * n, *plane)
