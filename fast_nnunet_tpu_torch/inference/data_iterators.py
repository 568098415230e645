"""Inference data iterators — the port of
fast_nnunet_tpu/inference/data_iterators.py (host work, the port's
``DefaultPreprocessor``; ref distillation/nnunetv2/inference/
data_iterators.py:17-220): preprocessing pipelines that feed the predictor, and
the custom-iterator protocol — each yielded item is a dict
``{'data': (C,*S) float32, 'data_properties': dict, 'ofile': str|None}``
(ref inference/readme.md). Workers are threads with a bounded queue for
backpressure (numpy/scipy release the GIL; replaces the reference's spawned
processes + mp.Queue round-robin)."""
import threading
from typing import Iterator, List, Optional

import numpy as np

from ..core.plans import ConfigurationManager, PlansManager
from ..preprocessing.preprocessor import DefaultPreprocessor


def preprocessing_iterator_fromfiles(list_of_lists: List[List[str]],
                                     list_of_segs_from_prev_stage: Optional[List],
                                     output_filenames_truncated: Optional[List[str]],
                                     plans_manager: PlansManager,
                                     dataset_json: dict,
                                     configuration_manager: ConfigurationManager,
                                     num_processes: int = 3,
                                     pin_memory: bool = False,
                                     verbose: bool = False) -> Iterator[dict]:
    """Parallel file preprocessing with ordered yield."""
    n = len(list_of_lists)
    segs_prev = list_of_segs_from_prev_stage or [None] * n
    ofiles = output_filenames_truncated or [None] * n
    results: List[Optional[dict]] = [None] * n
    done = [threading.Event() for _ in range(n)]
    sem = threading.Semaphore(max(1, num_processes) + 2)  # backpressure

    def work(i):
        try:
            pp = DefaultPreprocessor(verbose=verbose)
            # the prev-stage seg rides run_case's seg path: it shares the
            # image's crop bbox, skips intensity normalization and gets
            # label-safe resampling (ref data_iterators.py:31-39)
            data, seg, props = pp.run_case(list_of_lists[i], segs_prev[i],
                                           plans_manager,
                                           configuration_manager, dataset_json)
            if segs_prev[i] is not None:
                from ..core.labels import convert_labelmap_to_one_hot
                lm = plans_manager.get_label_manager(dataset_json)
                onehot = convert_labelmap_to_one_hot(seg[0], lm.foreground_labels,
                                                     data.dtype)
                data = np.vstack([data, onehot])
            results[i] = {"data": data, "data_properties": props,
                          "ofile": ofiles[i]}
        except Exception as e:  # surfaced on consumption
            results[i] = {"error": e}
        finally:
            done[i].set()

    def launcher():
        for i in range(n):
            sem.acquire()
            threading.Thread(target=work, args=(i,), daemon=True).start()

    threading.Thread(target=launcher, daemon=True).start()
    for i in range(n):
        done[i].wait()
        item = results[i]
        results[i] = None  # free memory as we go
        sem.release()
        if "error" in item:
            raise RuntimeError(f"preprocessing failed for case {i}") \
                from item["error"]
        yield item


def preprocessing_iterator_fromnpy(list_of_images: List[np.ndarray],
                                   list_of_segs_from_prev_stage: Optional[List],
                                   list_of_image_properties: List[dict],
                                   truncated_ofnames: Optional[List[str]],
                                   plans_manager: PlansManager,
                                   dataset_json: dict,
                                   configuration_manager: ConfigurationManager,
                                   num_processes: int = 3,
                                   pin_memory: bool = False,
                                   verbose: bool = False) -> Iterator[dict]:
    """Same protocol, starting from in-memory arrays (ref :122-220)."""
    n = len(list_of_images)
    ofiles = truncated_ofnames or [None] * n
    pp = DefaultPreprocessor(verbose=verbose)
    for i in range(n):
        seg_in = None
        if list_of_segs_from_prev_stage is not None and \
                list_of_segs_from_prev_stage[i] is not None:
            # signed dtype: crop_to_nonzero labels outside-mask voxels -1
            seg_in = np.asarray(list_of_segs_from_prev_stage[i]).astype(
                np.int16, copy=False)
            if seg_in.ndim == np.asarray(list_of_images[i]).ndim - 1:
                seg_in = seg_in[None]
        # prev-stage seg rides the seg path: shared crop bbox, no intensity
        # normalization, label-safe resampling (ref data_iterators.py:154-161)
        data, seg, props = pp.run_case_npy(
            np.asarray(list_of_images[i], np.float32), seg_in,
            dict(list_of_image_properties[i]), plans_manager,
            configuration_manager, dataset_json)
        if seg_in is not None:
            from ..core.labels import convert_labelmap_to_one_hot
            lm = plans_manager.get_label_manager(dataset_json)
            onehot = convert_labelmap_to_one_hot(seg[0], lm.foreground_labels,
                                                 data.dtype)
            data = np.vstack([data, onehot])
        yield {"data": data, "data_properties": props, "ofile": ofiles[i]}


class PreprocessAdapter:
    """Wraps a list of cases into the custom-iterator protocol lazily
    (ref data_iterators.py PreprocessAdapter)."""

    def __init__(self, list_of_lists: List[List[str]],
                 list_of_segs_from_prev_stage: Optional[List],
                 preprocessor: DefaultPreprocessor,
                 output_filenames_truncated: Optional[List[str]],
                 plans_manager: PlansManager, dataset_json: dict,
                 configuration_manager: ConfigurationManager,
                 num_threads_in_multithreaded: int = 1):
        self._iter = preprocessing_iterator_fromfiles(
            list_of_lists, list_of_segs_from_prev_stage,
            output_filenames_truncated, plans_manager, dataset_json,
            configuration_manager, num_threads_in_multithreaded)

    def __iter__(self):
        return self._iter

    def __next__(self):
        return next(self._iter)
