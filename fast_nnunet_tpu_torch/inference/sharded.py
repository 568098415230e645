"""Slab-parallel sliding-window inference over GPUs — the port of
fast_nnunet_tpu/inference/sharded.py.

One CT across the ranks of a process group (the JAX ``space`` mesh axis):
the x-axis tile grid is split into per-rank slabs, every rank accumulates
ONLY the tiles that start in its slab into a slab accumulator of ``owned +
halo`` rows (halo = patch[0]), sends its overhang rows to its right
neighbour (``ceil(halo / owned)`` hops, rows still past the receiver's
slab ride the next hop), adds what it receives from its left, finalizes
its owned rows on its own card, and rank 0 gathers the uint8 mask.

Grid-exact: the tiles are the single-card sweep's (the plain sweep's grid
of ``SlidingWindowEngine._sweep_grid``, the s2d sweep's even-floored grid)
in its batches; they are only *assigned* to ranks. The per-chunk bodies are
the single-card ones: the plain slab gathers and accumulates each tile
batch as ``run_sweep`` does (kernel D with ``use_fused_accumulate``), at
slab-local x origins; the s2d slab runs ``S2DChunks`` (kernel C per tile
batch on a p0/2-row view of the slab accumulator at its tile's row) and
kernel B over the owned half-res rows. s2d ownership rounds ``owned`` up to
even, so no s2d block straddles a boundary, and the accumulator is
half-resolution.

Exactness, as in JAX: rows outside the slab-boundary halo regions are
bit-identical to the single-card sweep (same contributions, same order).
On halo rows the neighbour's subtotal is added last, a reassociation that
can flip near-tie argmaxes. ``halo_exact=True`` is JAX's wavefront: rank s
folds the inbox in BEFORE its own tiles (0 + x == x), then accumulates,
then forwards its overhang, so every voxel adds in the single-card order
and the mask is identical — at the cost of running the ranks one after
another (validation runs, not serving).

Transport (parallel/collectives.py ``shift_right``, ``gather_to_first``):
NCCL moves the rows card to card; gloo moves host tensors, so a CUDA slab
under gloo (ranks sharing one card) is staged through pinned buffers.
"""
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.finalize import grouped_argmax
from ..parallel.collectives import gather_to_first, group_size, shift_right
from .engine import S2DChunks, SlidingWindowEngine, _revert_cls, _round_up


def _space_group(group):
    """``group``, or the world when a process group is up (None: this
    process alone)."""
    if group is None and dist.is_initialized():
        return dist.group.WORLD
    return group


def _slab_volume(engine: SlidingWindowEngine, volume: np.ndarray,
                 plane, x0: int, ext: int) -> torch.Tensor:
    """Rows [x0, x0 + ext) of the zero-padded sweep volume, (C, ext,
    *plane) in the compute dtype on the engine's device."""
    vol = torch.zeros((volume.shape[0], ext, *plane),
                      dtype=engine.compute_dtype, device=engine.device)
    spatial = volume.shape[1:]
    n = max(0, min(ext, spatial[0] - x0))
    if n:
        vol[:, :n, :spatial[1], :spatial[2]] = torch.as_tensor(
            np.asarray(volume[:, x0:x0 + n], np.float32)).to(
                engine.device, engine.compute_dtype)
    return vol


def _owned_rows(x_extent: int, D: int, even: bool) -> int:
    """Rows each rank owns: ceil(x / D), rounded up to even for s2d."""
    owned = int(np.ceil(x_extent / D))
    return _round_up(owned, 2) if even else owned


def _accumulate_slab(acc: torch.Tensor, owned: int, halo: int,
                     run_tiles: Callable[[], None], group,
                     halo_exact: bool) -> None:
    """The rank's tiles into ``acc`` (owned + halo rows), then the halo
    exchange along the group: afterwards rows [0, owned) hold every
    contribution of the global sweep."""
    D = group_size(group)
    if D == 1:
        run_tiles()
        return
    d = dist.get_rank(group)
    tail_shape = (acc.shape[0] - owned,) + tuple(acc.shape[1:])
    dist.barrier(group=group)  # every rank's communicator up before p2p
    if halo_exact:
        # wavefront: the inbox first (onto zeros: exact), then own tiles
        if d > 0:
            inbox = torch.empty(tail_shape, dtype=acc.dtype,
                                device=acc.device)
            shift_right(None, inbox, group)
            acc[:halo] += inbox
        run_tiles()
        if d < D - 1:
            shift_right(acc[owned:].clone(), None, group)
        return
    run_tiles()
    inbox = torch.empty(tail_shape, dtype=acc.dtype, device=acc.device) \
        if d > 0 else None
    # hop h (from 1) carries rank r's own overhang when h = 1 and what it
    # relays from rank r - h + 1 after: ranks below h - 1 hold only zeros
    # and are skipped (JAX's ring sends them; adding zeros changes no bit)
    for h in range(1, int(np.ceil(halo / owned)) + 1):
        send = h - 1 <= d < D - 1
        recv = d >= h
        tail = acc[owned:].clone() if send else None
        acc[owned:] = 0
        shift_right(tail, inbox if recv else None, group)
        if recv:
            acc[:halo] += inbox


def _gather_mask(seg_local: torch.Tensor, spatial, group
                 ) -> Optional[np.ndarray]:
    parts = gather_to_first(seg_local, group)
    if parts is None:
        return None
    seg = torch.cat([p.cpu() for p in parts], 0).numpy()
    return seg[tuple(slice(0, s) for s in spatial)]


def predict_segmentation_multigpu(engine: SlidingWindowEngine, params_list,
                                  volume: np.ndarray, group=None,
                                  halo_exact: bool = False
                                  ) -> Optional[np.ndarray]:
    """volume (C, *spatial) -> uint8 argmax segmentation, slab-parallel
    over ``group``'s ranks (default the world), each on its engine's card.
    Every rank passes the same volume and weights; rank 0 returns the mask,
    the others None. The plain sweep's grid and batches
    (``use_fused_accumulate``: every accumulate is kernel D)."""
    engine._check_dims(volume)
    group = _space_group(group)
    D = group_size(group)
    d = dist.get_rank(group) if D > 1 else 0
    forward = engine._tile_step_fn(engine.load_params(params_list))
    spatial = volume.shape[1:]
    vol_shape, starts_x, coords_b, valid_b, fused = \
        engine._sweep_grid(spatial)
    plane = tuple(vol_shape[1:])
    owned = _owned_rows(vol_shape[0], D, even=False)
    halo = engine.patch_size[0]
    x0 = d * owned
    vol = _slab_volume(engine, volume, plane, x0, owned + halo)
    c_acc = engine._acc_channels() if fused else engine.num_classes + 1
    acc_dtype = engine.sweep_acc_dtype
    acc = torch.zeros((owned + halo, *plane, c_acc), dtype=acc_dtype,
                      device=engine.device)
    mine = [gx for gx in starts_x if min(gx // owned, D - 1) == d]

    def run_tiles():
        with torch.no_grad():
            for gx in mine:
                for bi in range(len(coords_b)):
                    cb = coords_b[bi].copy()
                    cb[:, 0] = gx - x0
                    with engine.phase("forward"):
                        logits = forward(engine._gather(vol, cb))
                    with engine.phase("accumulate"):
                        engine._accumulate_batch(acc, logits, cb, valid_b[bi],
                                                 acc_dtype, fused)

    _accumulate_slab(acc, owned, halo, run_tiles, group, halo_exact)
    with engine.phase("finalize"):
        # argmax(a / w) == argmax(a): w > 0 is shared by the classes
        seg = acc[:owned, ..., :engine.num_classes].argmax(-1).to(
            torch.uint8)
    return _gather_mask(seg, spatial, group)


def predict_segmentation_multigpu_s2d(engine: SlidingWindowEngine,
                                      params_list, volume: np.ndarray,
                                      group=None, halo_exact: bool = False
                                      ) -> Optional[np.ndarray]:
    """The s2d sweep (``predict_segmentation_sweep_s2d``'s grid and
    batches) slab-parallel over ``group``'s ranks: kernel C into the
    half-res slab accumulator, kernel B over the owned rows. Rank 0
    returns the mask, the others None."""
    if not engine.is_s2d or engine.mirror_axes:
        raise ValueError("the s2d sweep needs an S2DPlainConvUNet engine "
                         "without mirror-TTA")
    engine._check_dims(volume)
    group = _space_group(group)
    D = group_size(group)
    d = dist.get_rank(group) if D > 1 else 0
    engine.load_params(params_list)
    spatial = volume.shape[1:]
    vol_shape, steps = engine.s2d_sweep_plan(spatial)
    plane = tuple(vol_shape[1:])
    owned = _owned_rows(vol_shape[0], D, even=True)
    halo = engine.patch_size[0]
    x0 = d * owned
    vol = _slab_volume(engine, volume, plane, x0, owned + halo)
    sweep = S2DChunks(engine, vol_shape, steps,
                      acc_rows=(owned + halo) // 2)
    mine = [gx for gx in sweep.starts_x if min(gx // owned, D - 1) == d]

    def run_tiles():
        with torch.no_grad():
            for gx in mine:
                sweep.accumulate(vol, gx - x0, row0=(gx - x0) // 2)

    _accumulate_slab(sweep.acc, owned // 2, halo // 2, run_tiles, group,
                     halo_exact)
    with engine.phase("finalize"):
        cls8 = grouped_argmax(sweep.acc[:owned // 2], engine.num_classes,
                              owned // 2)
        seg = _revert_cls(cls8, plane)
    return _gather_mask(seg, spatial, group)
