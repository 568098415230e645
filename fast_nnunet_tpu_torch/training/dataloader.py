"""Patch sampling with foreground oversampling and an asynchronous host
prefetch — a copy of fast_nnunet_tpu/training/dataloader.py, so one
``np.random.RandomState`` draws the same batch in both packages.

Batches stay NCDHW (the port's device layout; the JAX trainer's move to
channels-last has no counterpart). A cascade stage's sampler reads the
previous stage's prediction of each case (``prev_stage_folder``, one
``{ident}.npz`` with key ``seg`` on this configuration's grid) and stacks
it as seg channel 1, so it shares the patch's crop and the spatial
transforms. With ``pin_memory=True`` the worker
threads hand over page-locked tensors, so the trainer's host-to-device copy
runs with ``non_blocking=True``. A worker's exception is re-raised by
``next()`` in the training loop. Cases come from either store: a ``.npy``
memmap or a ``.fnnz`` ``BrickReader``, which ``crop_and_pad_nd`` slices, so
a patch decompresses only the bricks it touches.
"""
import os
import queue
import threading
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from ..ops.pad import crop_and_pad_nd
from .dataset import NpyCaseDataset
from .zstd_store import ZstdCaseDataset


class PatchSampler:
    def __init__(self, dataset: Union[NpyCaseDataset, ZstdCaseDataset],
                 batch_size: int,
                 initial_patch_size: Sequence[int], final_patch_size: Sequence[int],
                 oversample_foreground_percent: float = 0.33,
                 transform: Optional[Callable] = None,
                 probabilistic_oversampling: bool = False,
                 prev_stage_folder: Optional[str] = None):
        self.dataset = dataset
        self.identifiers = dataset.keys()
        self.batch_size = batch_size
        self.initial_patch_size = tuple(int(p) for p in initial_patch_size)
        self.final_patch_size = tuple(int(p) for p in final_patch_size)
        # 2D configs on (c, x, y, z) cases: sample pseudo-3D (1, *patch) and
        # squeeze the singleton axis before the transforms (ref
        # data_loader.py:32-41) — the slice picked for fg-forced samples then
        # automatically contains the chosen class voxel
        self._patch_was_2d = len(self.initial_patch_size) == 2
        if self._patch_was_2d:
            self.initial_patch_size = (1, *self.initial_patch_size)
            self.final_patch_size = (1, *self.final_patch_size)
        self.oversample = oversample_foreground_percent
        self.transform = transform
        self.probabilistic = probabilistic_oversampling
        self.prev_stage_folder = prev_stage_folder

    def _load_prev_stage(self, ident: str, shape) -> Optional[np.ndarray]:
        if self.prev_stage_folder is None:
            return None
        path = os.path.join(self.prev_stage_folder, ident + ".npz")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"cascade requires previous-stage prediction {path} — run the "
                "3d_lowres stage's predict_next_stage first")
        prev = np.load(path)["seg"]
        assert prev.shape == tuple(shape), \
            f"prev-stage seg shape {prev.shape} != case shape {tuple(shape)}"
        return prev

    def _must_force_fg(self, sample_idx: int, rng) -> bool:
        if self.probabilistic:
            return rng.uniform() < self.oversample
        # deterministic: the LAST round(bs*oversample) samples of the batch
        return sample_idx >= round(self.batch_size * (1 - self.oversample))

    def _get_bbox(self, shape, force_fg: bool, class_locations: Optional[dict],
                  rng) -> List[List[int]]:
        patch = self.initial_patch_size
        dim = len(shape)
        need_pad = [max(0, patch[d] - shape[d]) for d in range(dim)]
        lbs = [-(need_pad[d] // 2) for d in range(dim)]
        ubs = [shape[d] + need_pad[d] // 2 + need_pad[d] % 2 - patch[d]
               for d in range(dim)]

        if force_fg and class_locations is not None:
            eligible = [k for k, v in class_locations.items() if len(v) > 0]
            if len(eligible) > 0:
                chosen = eligible[rng.randint(len(eligible))]
                voxels = class_locations[chosen]
                center = voxels[rng.randint(len(voxels))]
                lows = [min(max(lbs[d], int(center[d]) - patch[d] // 2), ubs[d])
                        for d in range(dim)]
                return [[lo, lo + patch[d]] for d, lo in enumerate(lows)]
        lows = [rng.randint(lbs[d], ubs[d] + 1) for d in range(dim)]
        return [[lo, lo + patch[d]] for d, lo in enumerate(lows)]

    def generate_batch(self, rng: np.random.RandomState) -> dict:
        data_batch, target_batch, keys = [], None, []
        for j in range(self.batch_size):
            ident = self.identifiers[rng.randint(len(self.identifiers))]
            keys.append(ident)
            data, seg, props = self.dataset.load_case(ident)
            force_fg = self._must_force_fg(j, rng)
            bbox = self._get_bbox(data.shape[1:], force_fg,
                                  props.get("class_locations"), rng)
            patch_data = crop_and_pad_nd(data, bbox, 0)
            prev = self._load_prev_stage(ident, data.shape[1:])
            if prev is not None:
                seg = np.concatenate([np.asarray(seg),
                                      prev[None].astype(seg.dtype)])
            patch_seg = crop_and_pad_nd(seg, bbox, -1)
            if self._patch_was_2d:
                patch_data = patch_data[:, 0]
                patch_seg = patch_seg[:, 0]
            if self.transform is not None:
                patch_data, targets = self.transform(patch_data, patch_seg, rng)
            else:
                targets = [patch_seg]
            data_batch.append(patch_data)
            if target_batch is None:
                target_batch = [[] for _ in targets]
            for lvl, t in enumerate(targets):
                target_batch[lvl].append(t)
        return {
            "data": np.stack(data_batch),
            "target": [np.stack(t) for t in target_batch],
            "keys": keys,
        }


def pin_batch(batch: dict) -> dict:
    """The batch's arrays as page-locked CPU tensors (same layout)."""
    import torch
    out = dict(batch)
    out["data"] = torch.from_numpy(batch["data"]).pin_memory()
    out["target"] = [torch.from_numpy(np.ascontiguousarray(t)).pin_memory()
                     for t in batch["target"]]
    return out


class AsyncBatchIterator:
    """Thread-pool prefetcher (the NonDetMultiThreadedAugmenter role).
    Infinite; call shutdown() (or use as a context manager) when done."""

    def __init__(self, sampler: PatchSampler, num_workers: int = 4,
                 prefetch: int = 6, seed: int = 12345,
                 pin_memory: bool = False):
        self.sampler = sampler
        self.pin_memory = pin_memory
        self.queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads = []
        for w in range(max(1, num_workers)):
            t = threading.Thread(target=self._worker, args=(seed + w,), daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self, seed: int):
        rng = np.random.RandomState(seed)
        while not self._stop.is_set():
            try:
                batch = self.sampler.generate_batch(rng)
                if self.pin_memory:
                    batch = pin_batch(batch)
            except Exception as e:  # surface worker crashes to the consumer
                self.queue.put(e)
                return
            while not self._stop.is_set():
                try:
                    self.queue.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        item = self.queue.get()
        if isinstance(item, Exception):
            raise RuntimeError("dataloader worker died") from item
        return item

    def shutdown(self):
        self._stop.set()
        # drain so workers blocked on put() can exit
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.shutdown()
