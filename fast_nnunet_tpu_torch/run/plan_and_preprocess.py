"""Plan and preprocess entries — a copy of
fast_nnunet_tpu/run/plan_and_preprocess.py: ``extract_fingerprints``,
``plan_experiments`` and ``preprocess`` with the console scripts
``fast_nnunet_plan_and_preprocess_torch``,
``fast_nnunet_extract_fingerprint_torch``, ``fast_nnunet_plan_experiment_torch``
and ``fast_nnunet_preprocess_torch`` (each takes ``argv``; None: the command
line), plus ``fast_nnunet_move_plans_torch``. Host numpy work only: no
``device`` argument; the trainer that reads the result runs on the card."""
import argparse
from typing import List, Optional, Union

from ..configuration import default_num_processes
from ..planning.fingerprint import DatasetFingerprintExtractor
from ..planning.planner import ExperimentPlanner
from ..planning.resenc_planner import (ResEncUNetPlanner, nnUNetPlannerResEncL,
                                       nnUNetPlannerResEncM, nnUNetPlannerResEncXL)
from ..preprocessing.preprocessor import DefaultPreprocessor
from ..utils.misc import maybe_convert_to_dataset_name

PLANNERS = {cls.__name__: cls for cls in (
    ExperimentPlanner, ResEncUNetPlanner, nnUNetPlannerResEncM,
    nnUNetPlannerResEncL, nnUNetPlannerResEncXL)}


def extract_fingerprints(dataset_ids: List[Union[int, str]],
                         num_processes: int = default_num_processes,
                         check_dataset_integrity: bool = False,
                         overwrite_existing: bool = False) -> None:
    for d in dataset_ids:
        if check_dataset_integrity:
            from ..planning.verify import verify_dataset_integrity
            verify_dataset_integrity(maybe_convert_to_dataset_name(d))
        DatasetFingerprintExtractor(d, num_processes=num_processes).run(
            overwrite_existing=overwrite_existing)


def plan_experiments(dataset_ids: List[Union[int, str]],
                     experiment_planner_name: str = "ExperimentPlanner",
                     gpu_memory_target_in_gb: Optional[float] = None,
                     preprocessor_name: str = "DefaultPreprocessor",
                     overwrite_target_spacing: Optional[List[float]] = None,
                     overwrite_plans_name: Optional[str] = None):
    planner_cls = PLANNERS.get(experiment_planner_name)
    if planner_cls is None:
        raise KeyError(f"Unknown planner {experiment_planner_name}. "
                       f"Known: {sorted(PLANNERS)}")
    plans = None
    for d in dataset_ids:
        kwargs = dict(preprocessor_name=preprocessor_name,
                      overwrite_target_spacing=overwrite_target_spacing)
        if gpu_memory_target_in_gb is not None:
            kwargs["gpu_memory_target_in_gb"] = gpu_memory_target_in_gb
        if overwrite_plans_name is not None:
            kwargs["plans_name"] = overwrite_plans_name
        plans = planner_cls(d, **kwargs).plan_experiment()
    return plans


def preprocess(dataset_ids: List[Union[int, str]],
               plans_identifier: str = "nnUNetPlans",
               configurations: List[str] = ("2d", "3d_fullres", "3d_lowres"),
               num_processes: Union[int, List[int]] = (8, 4, 8),
               verbose: bool = False, storage: str = None) -> None:
    if isinstance(num_processes, int):
        num_processes = [num_processes] * len(configurations)
    if len(num_processes) < len(configurations):
        num_processes = list(num_processes) + \
            [num_processes[-1]] * (len(configurations) - len(num_processes))
    for d in dataset_ids:
        from ..core.plans import PlansManager
        from ..paths import get_preprocessed_folder
        from ..utils.io import join
        dataset_name = maybe_convert_to_dataset_name(d)
        plans = PlansManager(join(get_preprocessed_folder(), dataset_name,
                                  plans_identifier + ".json"))
        for cfg, np_ in zip(configurations, num_processes):
            if cfg not in plans.available_configurations:
                print(f"Configuration {cfg} not in plans of {dataset_name}, "
                      "skipping.")
                continue
            DefaultPreprocessor(verbose=verbose).run(
                d, cfg, plans_identifier, num_processes=np_, storage=storage)


def plan_and_preprocess_entry(argv=None):
    parser = argparse.ArgumentParser(description="plan & preprocess")
    parser.add_argument("-d", nargs="+", required=True, help="dataset ids")
    parser.add_argument("-fpe", default="DatasetFingerprintExtractor")
    parser.add_argument("-npfp", type=int, default=8)
    parser.add_argument("--verify_dataset_integrity", action="store_true")
    parser.add_argument("--no_pp", action="store_true",
                        help="plan only, skip preprocessing")
    parser.add_argument("--clean", action="store_true",
                        help="overwrite existing fingerprints")
    parser.add_argument("-pl", default="ExperimentPlanner")
    parser.add_argument("-gpu_memory_target", type=float, default=None)
    parser.add_argument("-preprocessor_name", default="DefaultPreprocessor")
    parser.add_argument("-overwrite_target_spacing", nargs="+", type=float,
                        default=None)
    parser.add_argument("-overwrite_plans_name", default=None)
    parser.add_argument("-c", nargs="+", default=["2d", "3d_fullres", "3d_lowres"])
    parser.add_argument("-np", nargs="+", type=int, default=None)
    parser.add_argument("-store", choices=("npy", "fnnz"), default=None,
                        help="preprocessed-case store: memmap npy (default) "
                             "or chunked-zstd fnnz (compressed, cache-tuned "
                             "bricks; also via FNNT_STORE)")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)

    extract_fingerprints(args.d, args.npfp, args.verify_dataset_integrity,
                         args.clean)
    plan_experiments(args.d, args.pl, args.gpu_memory_target,
                     args.preprocessor_name, args.overwrite_target_spacing,
                     args.overwrite_plans_name)
    if not args.no_pp:
        np_ = args.np if args.np is not None else (8, 4, 8)
        plans_identifier = args.overwrite_plans_name or {
            "ExperimentPlanner": "nnUNetPlans",
            "ResEncUNetPlanner": "nnUNetResEncUNetPlans",
            "nnUNetPlannerResEncM": "nnUNetResEncUNetMPlans",
            "nnUNetPlannerResEncL": "nnUNetResEncUNetLPlans",
            "nnUNetPlannerResEncXL": "nnUNetResEncUNetXLPlans",
        }.get(args.pl, "nnUNetPlans")
        preprocess(args.d, plans_identifier, args.c, np_, args.verbose,
                   storage=args.store)


def extract_fingerprint_entry(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-d", nargs="+", required=True)
    parser.add_argument("-np", type=int, default=8)
    parser.add_argument("--verify_dataset_integrity", action="store_true")
    parser.add_argument("--clean", action="store_true")
    args = parser.parse_args(argv)
    extract_fingerprints(args.d, args.np, args.verify_dataset_integrity, args.clean)


def plan_experiment_entry(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-d", nargs="+", required=True)
    parser.add_argument("-pl", default="ExperimentPlanner")
    parser.add_argument("-gpu_memory_target", type=float, default=None)
    parser.add_argument("-preprocessor_name", default="DefaultPreprocessor")
    parser.add_argument("-overwrite_target_spacing", nargs="+", type=float,
                        default=None)
    parser.add_argument("-overwrite_plans_name", default=None)
    args = parser.parse_args(argv)
    plan_experiments(args.d, args.pl, args.gpu_memory_target,
                     args.preprocessor_name, args.overwrite_target_spacing,
                     args.overwrite_plans_name)


def preprocess_entry(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-d", nargs="+", required=True)
    parser.add_argument("-plans_name", default="nnUNetPlans")
    parser.add_argument("-c", nargs="+", default=["2d", "3d_fullres", "3d_lowres"])
    parser.add_argument("-np", nargs="+", type=int, default=None)
    parser.add_argument("-store", choices=("npy", "fnnz"), default=None,
                        help="preprocessed-case store: memmap npy (default) or "
                             "chunked-zstd fnnz (also via FNNT_STORE)")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    preprocess(args.d, args.plans_name, args.c,
               args.np if args.np is not None else (8, 4, 8), args.verbose,
               storage=args.store)
