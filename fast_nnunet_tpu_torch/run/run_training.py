"""Training entry point of the port (nnUNetv2_train parity) — the
counterpart of fast_nnunet_tpu/run/run_training.py on one GPU.

    fast_nnunet_train_torch DATASET CONFIGURATION FOLD [-tr NNUNetTrainer]
        [-p nnUNetPlans] [-pretrained_weights ckpt.fnnx|ckpt.pth] [--c] [--val]
        [--val_best] [--npz] [--disable_checkpointing] [-device cuda|cpu]

with ``nnUNet_raw``, ``nnUNet_preprocessed`` and ``nnUNet_results`` set.
Trainers: ``NNUNetTrainer``, the distillation trainers and every trainer
variant of training/trainer_variants.py, in this framework's spelling or
the reference's (``nnUNetTrainer*``); ResEnc plans (``-p
nnUNetResEncUNetLPlans``) train the residual-encoder U-Net. Multi-GPU
(``-num_gpus`` > 1) and multi-host training raise ``NotImplementedError``;
so does building a Primus trainer's network. Pretrained weights come from
a ``.fnnx`` checkpoint or a reference ``.pth`` (``utils/torch_import.py``).
"""
import argparse

from ..training.trainer import NNUNetTrainer
from ..utils.io import isfile, join, load_json
from ..utils.misc import (maybe_convert_to_dataset_name,
                           trainer_spelling_variants)

def _trainer_modules():
    from ..training import distill as _d
    from ..training import trainer as _t
    from ..training import trainer_variants as _v
    return _t, _d, _v


def _ported_trainer_names():
    """The public trainer classes of the port, by name."""
    return sorted({n for mod in _trainer_modules()
                   for n, c in vars(mod).items()
                   if isinstance(c, type) and issubclass(c, NNUNetTrainer)
                   and not n.startswith("_")})


def find_trainer_class(name: str):
    """A trainer class of the port by name, in this framework's spelling or
    the reference's."""
    for cand in trainer_spelling_variants(name):
        for mod in _trainer_modules():
            if isinstance(getattr(mod, cand, None), type) and \
                    issubclass(getattr(mod, cand), NNUNetTrainer):
                return getattr(mod, cand)
    raise NotImplementedError(
        f"trainer {name!r} is not ported (ported: "
        f"{', '.join(_ported_trainer_names())})")


def get_trainer_from_args(dataset_name_or_id, configuration: str, fold,
                          trainer_name: str = "NNUNetTrainer",
                          plans_identifier: str = "nnUNetPlans",
                          device=None, **trainer_kwargs) -> NNUNetTrainer:
    from ..paths import get_preprocessed_folder
    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    preprocessed = join(get_preprocessed_folder(), dataset_name)
    plans_file = join(preprocessed, plans_identifier + ".json")
    if not isfile(plans_file):
        raise FileNotFoundError(f"Plans missing: {plans_file}. Run "
                                "plan_and_preprocess first.")
    trainer_class = find_trainer_class(trainer_name)
    return trainer_class(plans=load_json(plans_file),
                         configuration=configuration, fold=fold,
                         dataset_json=load_json(join(preprocessed,
                                                     "dataset.json")),
                         device=device, **trainer_kwargs)


def maybe_load_checkpoint(trainer: NNUNetTrainer, continue_training: bool,
                          validation_only: bool,
                          val_best: bool = False) -> None:
    """checkpoint_final -> latest -> best, the reference's precedence;
    ``val_best`` with ``validation_only`` takes checkpoint_best."""
    if not (continue_training or validation_only):
        return
    names = ("checkpoint_best.fnnx",) if val_best and validation_only else \
        ("checkpoint_final.fnnx", "checkpoint_latest.fnnx",
         "checkpoint_best.fnnx")
    expected = next((join(trainer.output_folder, n) for n in names
                     if isfile(join(trainer.output_folder, n))), None)
    if expected is None:
        if validation_only:
            raise RuntimeError("Cannot run validation: no checkpoint found "
                               f"in {trainer.output_folder}")
        print("No checkpoint found, starting fresh.")
        return
    trainer.load_checkpoint(expected)


def load_pretrained_weights(trainer: NNUNetTrainer, fname: str) -> dict:
    """Copy every tensor of a pretrained checkpoint whose (translated) name
    and shape match into the trainer's network before training; the
    segmentation heads of a reference ``.pth`` are skipped, as the
    reference's loader does. ``.fnnx`` / ``.pkl`` files are the JAX
    package's checkpoints; anything else is read as a torch ``.pth``.
    Returns the ``.pth`` import report (``{}`` for a ``.fnnx``)."""
    if not trainer.was_initialized:
        trainer.initialize()
    if fname.endswith((".fnnx", ".pkl")):
        from ..models.unet import params_from_jax_partial
        from ..training.checkpoint import load_checkpoint
        n_loaded, n_total = params_from_jax_partial(
            trainer.network, load_checkpoint(fname)["network_weights"])
        print(f"Pretrained weights: {n_loaded}/{n_total} tensors matched")
        return {}
    from ..utils.torch_import import (import_torch_weights,
                                      load_torch_network_weights)
    _, report = import_torch_weights(
        trainer.network, load_torch_network_weights(fname),
        skip_seg_layers=True)
    print(f"Pretrained torch weights: {len(report['converted'])} converted, "
          f"{len(report['skipped_seg'])} seg layers skipped, "
          f"{len(report['unmatched'])} unmatched, "
          f"{len(report['shape_mismatch'])} shape mismatches, "
          f"{len(report['missing_in_template'])} not in the network")
    return report


def run_training(dataset_name_or_id, configuration: str, fold,
                 trainer_name: str = "NNUNetTrainer",
                 plans_identifier: str = "nnUNetPlans",
                 pretrained_weights: str = None,
                 continue_training: bool = False,
                 only_run_validation: bool = False,
                 disable_checkpointing: bool = False,
                 val_best: bool = False,
                 export_validation_probabilities: bool = False,
                 device=None, num_gpus: int = 1, **trainer_kwargs):
    """Train (unless ``only_run_validation``) and validate one fold on
    ``device`` (default the card)."""
    if num_gpus != 1:
        raise NotImplementedError("multi-GPU training is not ported")
    if fold != "all":
        fold = int(fold)
    trainer = get_trainer_from_args(dataset_name_or_id, configuration, fold,
                                    trainer_name, plans_identifier,
                                    device=device, **trainer_kwargs)
    trainer.disable_checkpointing = disable_checkpointing
    if pretrained_weights is not None:
        if continue_training:
            raise RuntimeError("-pretrained_weights and --c are mutually "
                               "exclusive (same as the reference CLI)")
        load_pretrained_weights(trainer, pretrained_weights)
    maybe_load_checkpoint(trainer, continue_training, only_run_validation,
                          val_best)
    if not only_run_validation:
        trainer.run_training()
    trainer.perform_actual_validation(export_validation_probabilities)
    return trainer


def run_training_entry(argv=None):
    parser = argparse.ArgumentParser(
        description="fast-nnunet training on one GPU (PyTorch port)")
    parser.add_argument("dataset_name_or_id")
    parser.add_argument("configuration")
    parser.add_argument("fold", help="0..4 or 'all'")
    parser.add_argument("-tr", default="NNUNetTrainer")
    parser.add_argument("-p", default="nnUNetPlans")
    parser.add_argument("-pretrained_weights", default=None,
                        help=".fnnx checkpoint to transfer weights from "
                             "before training")
    parser.add_argument("--c", action="store_true", dest="continue_training")
    parser.add_argument("--val", action="store_true", dest="validation_only")
    parser.add_argument("--npz", action="store_true",
                        help="export validation probabilities")
    parser.add_argument("--val_best", action="store_true",
                        help="with --val: validate checkpoint_best")
    parser.add_argument("--disable_checkpointing", action="store_true",
                        help="do not write any checkpoints (benchmarking)")
    parser.add_argument("-device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("-num_gpus", type=int, default=1,
                        help="only 1 is ported")
    parser.add_argument("-num_hosts", type=int, default=1,
                        help="only 1 is ported")
    args = parser.parse_args(argv)
    if args.num_hosts != 1:
        raise NotImplementedError("multi-host training is not ported")
    run_training(args.dataset_name_or_id, args.configuration, args.fold,
                 trainer_name=args.tr, plans_identifier=args.p,
                 pretrained_weights=args.pretrained_weights,
                 continue_training=args.continue_training,
                 only_run_validation=args.validation_only,
                 disable_checkpointing=args.disable_checkpointing,
                 val_best=args.val_best,
                 export_validation_probabilities=args.npz,
                 device=args.device, num_gpus=args.num_gpus)


if __name__ == "__main__":
    run_training_entry()
