"""Move plans between datasets for pretraining and finetuning — a copy of
fast_nnunet_tpu/planning/plans_transfer.py: the target dataset reuses the
source's architecture, patch and spacing so that weights transfer; the
intensity statistics and data identifiers come from the target, and so
does the image reader/writer (from the target's dataset.json), as in the
reference's move_plans_between_datasets: the JAX package keeps the
source's, so plans moved onto a dataset of another file format read it
with the wrong reader."""
import argparse
from copy import deepcopy

from ..utils.io import isfile, join, load_json, save_json
from ..utils.misc import maybe_convert_to_dataset_name


def move_plans_between_datasets(source_dataset_name_or_id,
                                target_dataset_name_or_id,
                                source_plans_identifier: str,
                                target_plans_identifier: str = None) -> dict:
    from ..paths import get_preprocessed_folder, get_raw_folder
    if target_plans_identifier is None:
        target_plans_identifier = source_plans_identifier
    source = maybe_convert_to_dataset_name(source_dataset_name_or_id)
    target = maybe_convert_to_dataset_name(target_dataset_name_or_id)

    source_plans = load_json(join(get_preprocessed_folder(), source,
                                  source_plans_identifier + ".json"))
    target_fp_file = join(get_preprocessed_folder(), target,
                          "dataset_fingerprint.json")
    assert isfile(target_fp_file), (
        f"target fingerprint missing ({target_fp_file}); run "
        "extract_fingerprints on the target dataset first")
    target_fp = load_json(target_fp_file)
    target_dataset_json = load_json(join(get_raw_folder(), target, "dataset.json"))

    plans = deepcopy(source_plans)
    plans["dataset_name"] = target
    plans["plans_name"] = target_plans_identifier
    # dataset-specific intensity statistics must come from the target
    plans["foreground_intensity_properties_per_channel"] = \
        target_fp["foreground_intensity_properties_per_channel"]
    if "image_reader_writer" in plans:
        from ..imageio.registry import \
            determine_reader_writer_from_dataset_json
        plans["image_reader_writer"] = \
            determine_reader_writer_from_dataset_json(
                target_dataset_json).__name__
    # data identifiers must be regenerated so preprocessed folders don't collide
    for cfg_name, cfg in plans["configurations"].items():
        if "data_identifier" in cfg:
            cfg["data_identifier"] = f"{target_plans_identifier}_{cfg_name}"

    out_file = join(get_preprocessed_folder(), target,
                    target_plans_identifier + ".json")
    save_json(plans, out_file, sort_keys=False)
    print(f"Transferred plans {source}/{source_plans_identifier} -> {out_file}")
    return plans


def move_plans_entry(argv=None) -> None:
    """``fast_nnunet_move_plans_torch -s SOURCE -t TARGET -sp PLANS [-tp
    PLANS]``: the reference CLI's arguments. (The JAX package's console
    script points at :func:`move_plans_between_datasets` itself, which takes
    no command line.)"""
    parser = argparse.ArgumentParser(
        description="move plans from one dataset to another")
    parser.add_argument("-s", required=True, help="source dataset name or id")
    parser.add_argument("-t", required=True, help="target dataset name or id")
    parser.add_argument("-sp", required=True,
                        help="source plans identifier (e.g. nnUNetPlans)")
    parser.add_argument("-tp", default=None,
                        help="target plans identifier (default: -sp)")
    args = parser.parse_args(argv)
    move_plans_between_datasets(args.s, args.t, args.sp, args.tp)
