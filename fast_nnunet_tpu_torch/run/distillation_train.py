"""Distillation training CLIs of the port — the counterparts of
fast_nnunet_tpu/run/distillation_train.py's two entries:

    fast_nnunet_distill_torch -d DATASET [-c 3d_fullres|2d|3d_lowres|
        3d_cascade_fullres] [-f 0]
        [-t TEACHER_FOLDER] [-tf 0 1 2 3 4] [-a 0.3] [-temp 3.0] [-r 2]
        [-e EPOCHS] [-c_continue] [--disable_mirroring] [--use_da5]
        [-device cuda|cpu]
    fast_nnunet_resenc_distill_torch -d DATASET ... [-tpl
        nnUNetResEncUNetLPlans] [-spl nnUNetPlans] [-bs reduce]

with ``nnUNet_preprocessed`` and ``nnUNet_results`` set (the teacher folder
defaults to the results folder of ``NNUNetTrainer__<teacher plans>__
<config>``; its folds are detected from the fold_* folders that hold a
checkpoint). The student is built from the student plans' architecture: a
ResEnc plans identifier (``-spl nnUNetResEncUNetLPlans``) gives a
LiteResEncStudent, its block counts mapped by ``-bs``. ``--use_da5`` trains
under the DA5 augmentation. A ``2d`` student distils from the teachers'
2d networks; a ``3d_cascade_fullres`` student reads its previous stage's
predictions from ``NNUNetDistillationTrainer__<plans>__3d_lowres/
predicted_next_stage/3d_cascade_fullres`` (the trainer's own name, the
reference's convention), where a distilled 3d_lowres leaves them or a
copy of the teachers' deposits is put.
"""
import argparse
from typing import Optional, Sequence

from ..training.distill import (NNUNetDistillationTrainer,
                                NNUNetDistillationTrainerDA5)
from ..utils.io import isdir, isfile, join, load_json
from ..utils.misc import get_output_folder, maybe_convert_to_dataset_name


def run_distillation_training(
        dataset_name_or_id, configuration: str = "3d_fullres", fold: int = 0,
        teacher_folder: Optional[str] = None,
        teacher_folds: Optional[Sequence[int]] = None,
        teacher_checkpoint: str = "checkpoint_final.fnnx",
        alpha: float = 0.3, temperature: float = 3.0,
        feature_reduction_factor: int = 2,
        block_reduction_strategy: str = "reduce",
        rotate_folds: bool = False, rotate_frequency: int = 50,
        num_epochs: Optional[int] = None,
        continue_training: bool = False,
        disable_mirroring: bool = False,
        use_da5: bool = False,
        teacher_plans_identifier: str = "nnUNetPlans",
        student_plans_identifier: str = "nnUNetPlans", device=None):
    """Distil a student for one fold on ``device`` (default the card), then
    validate it. Called on the ranks of parallel/distributed.py ``spawn``
    (as ``spawn(distillation_rank, n, kwargs=...)``), it distils
    data-parallel: the JAX distillation trainer inherits its mesh, and its
    CLI has no ``-num_gpus``, so neither has this one."""
    from ..paths import get_preprocessed_folder
    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    preprocessed = join(get_preprocessed_folder(), dataset_name)
    plans = load_json(join(preprocessed, student_plans_identifier + ".json"))
    dataset_json = load_json(join(preprocessed, "dataset.json"))
    if teacher_folder is None:
        teacher_folder = get_output_folder(dataset_name, "NNUNetTrainer",
                                           teacher_plans_identifier,
                                           configuration)
    if not isdir(teacher_folder):
        raise FileNotFoundError(f"teacher model folder missing: "
                                f"{teacher_folder}")
    if teacher_folds is None:
        teacher_folds = NNUNetDistillationTrainer \
            .detect_available_teacher_folds(
                teacher_folder, (teacher_checkpoint, "checkpoint_best.fnnx"))
        print(f"Auto-detected teacher folds: {teacher_folds}")

    trainer_cls = NNUNetDistillationTrainerDA5 if use_da5 \
        else NNUNetDistillationTrainer
    trainer = trainer_cls(
        plans, configuration, fold, dataset_json, device=device,
        teacher_model_folder=teacher_folder, teacher_fold=teacher_folds,
        teacher_checkpoint_name=teacher_checkpoint,
        alpha=alpha, temperature=temperature,
        feature_reduction_factor=feature_reduction_factor,
        block_reduction_strategy=block_reduction_strategy,
        rotate_training_folds=rotate_folds,
        rotate_folds_frequency=rotate_frequency,
        student_plans_identifier=student_plans_identifier)
    if num_epochs is not None:
        trainer.num_epochs = num_epochs
    if disable_mirroring:
        make_transform = trainer._make_training_transform

        def no_mirror_transform(patch_size, rotation, mirror_axes, dummy_2d,
                                lm, ds_scales):
            trainer.inference_allowed_mirroring_axes = ()
            return make_transform(patch_size, rotation, (), dummy_2d, lm,
                                  ds_scales)

        trainer._make_training_transform = no_mirror_transform

    if continue_training:
        for name in ("checkpoint_final.fnnx", "checkpoint_latest.fnnx",
                     "checkpoint_best.fnnx"):
            p = join(trainer.output_folder, name)
            if isfile(p):
                trainer.load_student_checkpoint(p)
                break

    trainer.run_training()
    trainer.perform_actual_validation(False)
    return trainer


def distillation_rank(**kwargs) -> dict:
    """:func:`run_distillation_training` on one spawned rank; returns the
    rank's summary (run/run_training.py ``rank_summary``)."""
    from .run_training import rank_summary
    return rank_summary(run_distillation_training(**kwargs))


def _common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-d", required=True, help="dataset name or id")
    parser.add_argument("-c", default="3d_fullres", help="configuration")
    parser.add_argument("-f", type=int, default=0, help="training fold")
    parser.add_argument("-t", default=None, help="teacher model folder")
    parser.add_argument("-tf", nargs="+", type=int, default=None,
                        help="teacher folds (default: auto-detect)")
    parser.add_argument("-tcp", default="checkpoint_final.fnnx",
                        help="teacher checkpoint name")
    parser.add_argument("-a", type=float, default=0.3, help="distill alpha")
    parser.add_argument("-temp", type=float, default=3.0, help="temperature")
    parser.add_argument("-r", type=int, default=2,
                        help="feature reduction factor")
    parser.add_argument("-e", type=int, default=None, help="epochs override")
    parser.add_argument("-c_continue", action="store_true")
    parser.add_argument("--disable_mirroring", action="store_true")
    parser.add_argument("-rotate_folds", action="store_true")
    parser.add_argument("-rotate_freq", type=int, default=50)
    parser.add_argument("--use_da5", action="store_true")
    parser.add_argument("-device", default="cuda",
                        help="cuda (default) or cpu")


def _run(args, **kw):
    return run_distillation_training(
        args.d, args.c, args.f, args.t, args.tf, args.tcp, args.a, args.temp,
        args.r, rotate_folds=args.rotate_folds,
        rotate_frequency=args.rotate_freq, num_epochs=args.e,
        continue_training=args.c_continue,
        disable_mirroring=args.disable_mirroring, use_da5=args.use_da5,
        device=args.device, **kw)


def distillation_train_entry(argv=None):
    parser = argparse.ArgumentParser(
        description="3D probability-map knowledge distillation (standard "
                    "UNet) on one GPU (PyTorch port)")
    _common_args(parser)
    _run(parser.parse_args(argv))


def resenc_distillation_train_entry(argv=None):
    parser = argparse.ArgumentParser(
        description="knowledge distillation for ResEnc teachers on one GPU "
                    "(PyTorch port)")
    _common_args(parser)
    parser.add_argument("-tpl", default="nnUNetResEncUNetLPlans",
                        help="teacher plans identifier")
    parser.add_argument("-spl", default="nnUNetPlans",
                        help="student plans identifier (a ResEnc plans "
                             "identifier gives a LiteResEncStudent)")
    parser.add_argument("-bs", default="reduce",
                        choices=("reduce", "keep", "increase", "adaptive"),
                        help="block reduction strategy")
    args = parser.parse_args(argv)
    _run(args, block_reduction_strategy=args.bs,
         teacher_plans_identifier=args.tpl,
         student_plans_identifier=args.spl)


if __name__ == "__main__":
    distillation_train_entry()
