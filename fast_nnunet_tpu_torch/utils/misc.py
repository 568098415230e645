"""Cross-validation splits, dataset naming and output-folder naming — copies
of fast_nnunet_tpu/utils/misc.py's numpy helpers. ``splits_final.json`` is
shared between the two packages, so :func:`generate_crossval_split` must
give the same folds for the same keys and seed."""
import os
from typing import List, Union

import numpy as np

from . import io as ffo


def generate_crossval_split(train_identifiers: List[str], seed: int = 12345,
                            n_splits: int = 5) -> List[dict]:
    """Seeded k-fold split with sklearn ``KFold(shuffle=True)``'s shuffling."""
    ids = np.array(sorted(train_identifiers))
    n = len(ids)
    rng = np.random.RandomState(seed)
    indices = np.arange(n)
    rng.shuffle(indices)
    fold_sizes = np.full(n_splits, n // n_splits, dtype=int)
    fold_sizes[: n % n_splits] += 1
    splits = []
    current = 0
    for fold_size in fold_sizes:
        test_idx = indices[current:current + fold_size]
        train_idx = np.setdiff1d(indices, test_idx)
        splits.append({"train": [str(ids[i]) for i in train_idx],
                       "val": [str(ids[i]) for i in test_idx]})
        current += fold_size
    return splits


def maybe_convert_to_dataset_name(dataset_name_or_id: Union[str, int]) -> str:
    """'4' / 4 -> 'Dataset004_Name', found under nnUNet_raw / preprocessed /
    results."""
    if isinstance(dataset_name_or_id, str) and \
            dataset_name_or_id.startswith("Dataset"):
        return dataset_name_or_id
    try:
        dataset_id = int(dataset_name_or_id)
    except ValueError:
        raise ValueError("dataset_name_or_id must be an int or "
                         f"'DatasetXXX_Name', got {dataset_name_or_id}")
    return convert_id_to_dataset_name(dataset_id)


def convert_id_to_dataset_name(dataset_id: int) -> str:
    startswith = "Dataset%03.0d" % dataset_id
    candidates = set()
    for env in ("nnUNet_preprocessed", "nnUNet_raw", "nnUNet_results"):
        folder = os.environ.get(env)
        if folder is not None and os.path.isdir(folder):
            candidates.update(ffo.subdirs(folder, prefix=startswith,
                                          join_path=False))
    if len(candidates) == 0:
        raise RuntimeError(f"Could not find a dataset with id {dataset_id} in "
                           "nnUNet_raw/nnUNet_preprocessed/nnUNet_results.")
    if len(candidates) > 1:
        raise RuntimeError(f"More than one dataset matches id {dataset_id}: "
                           f"{candidates}")
    return candidates.pop()


def trainer_spelling_variants(trainer_name: str) -> List[str]:
    """The name plus its reference-spelling twin (``nnUNetTrainer*`` <->
    ``NNUNetTrainer*``)."""
    names = [trainer_name]
    if trainer_name.startswith("nnUNet"):
        names.append("NNUNet" + trainer_name[len("nnUNet"):])
    elif trainer_name.startswith("NNUNet"):
        names.append("nnUNet" + trainer_name[len("NNUNet"):])
    return names


def get_output_folder(dataset_name_or_id, trainer_name: str = "NNUNetTrainer",
                      plans_identifier: str = "nnUNetPlans",
                      configuration: str = "3d_fullres",
                      fold: Union[str, int, None] = None) -> str:
    """results/<Dataset>/<Trainer__Plans__config>[/fold_X]; on read, an
    existing folder under the reference-spelled trainer name is taken."""
    from ..paths import get_results_folder
    base = ffo.join(get_results_folder(),
                    maybe_convert_to_dataset_name(dataset_name_or_id))
    tmp = None
    for tn in trainer_spelling_variants(trainer_name):
        cand = ffo.join(base, f"{tn}__{plans_identifier}__{configuration}")
        if tmp is None:
            tmp = cand
        if ffo.isdir(cand):
            tmp = cand
            break
    if fold is not None:
        tmp = ffo.join(tmp, f"fold_{fold}")
    return tmp
