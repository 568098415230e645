"""``fast_nnunet_predict_torch`` — nnUNetv2_predict on the port (the
counterpart of fast_nnunet_tpu/run/predict.py): a folder of
``{case}_{channel:04d}{ending}`` images in, one segmentation per case out.

The model is a trained model folder (``-m``), or is found under
``$nnUNet_results/<Dataset>/<trainer>__<plans>__<configuration>`` from
``-d/-tr/-p/-c``. Every configuration predicts: ``-c 2d`` predicts 3D
volumes slice by slice, and the cascade's second stage
(``-c 3d_cascade_fullres``) takes the first stage's output folder as
``-prev_stage_predictions``. Runs on the card unless ``-device cpu`` is
given.
"""
import argparse
import os

from ..inference.predictor import NNUNetPredictor
from ..utils.io import join, subdirs


def _model_folder(args) -> str:
    if args.m is not None:
        return args.m
    if args.d is None or args.c is None:
        raise SystemExit("give -m MODEL_FOLDER, or -d DATASET and -c "
                         "CONFIGURATION")
    results = os.environ.get("nnUNet_results")
    if results is None:
        raise SystemExit("nnUNet_results is not set")
    name = args.d
    if not name.startswith("Dataset"):
        hits = subdirs(results, prefix="Dataset%03d" % int(name))
        if len(hits) != 1:
            raise SystemExit(f"dataset {name}: {len(hits)} matches in "
                             f"{results}")
        name = hits[0]
    return join(results, name, f"{args.tr}__{args.p}__{args.c}")


def predict_entry_point(argv=None) -> None:
    ap = argparse.ArgumentParser(description="fast-nnunet inference on the "
                                 "PyTorch/CUDA port")
    ap.add_argument("-i", required=True, help="input folder")
    ap.add_argument("-o", required=True, help="output folder")
    ap.add_argument("-m", default=None, help="trained model folder "
                    "(plans.json, dataset.json, fold_X/)")
    ap.add_argument("-d", default=None, help="dataset name or id")
    ap.add_argument("-p", default="nnUNetPlans")
    ap.add_argument("-tr", default="NNUNetTrainer")
    ap.add_argument("-c", default=None, help="configuration")
    ap.add_argument("-f", nargs="+", default=None,
                    help="folds (default: all found)")
    ap.add_argument("-step_size", type=float, default=0.5)
    ap.add_argument("--disable_tta", action="store_true")
    ap.add_argument("--save_probabilities", action="store_true")
    ap.add_argument("--continue_prediction", action="store_true")
    ap.add_argument("-chk", default="checkpoint_final.fnnx")
    ap.add_argument("-prev_stage_predictions", default=None,
                    help="cascade: folder of the previous stage's "
                         "segmentations, one {case}{ending} per case")
    ap.add_argument("-npp", type=int, default=3)
    ap.add_argument("-nps", type=int, default=3)
    ap.add_argument("-num_parts", type=int, default=1)
    ap.add_argument("-part_id", type=int, default=0)
    ap.add_argument("-device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    predictor = NNUNetPredictor(tile_step_size=args.step_size,
                                use_mirroring=not args.disable_tta,
                                device=args.device, verbose=args.verbose)
    predictor.initialize_from_trained_model_folder(
        _model_folder(args), use_folds=args.f, checkpoint_name=args.chk)
    predictor.predict_from_files(
        args.i, args.o, save_probabilities=args.save_probabilities,
        overwrite=not args.continue_prediction,
        num_processes_preprocessing=args.npp,
        num_processes_segmentation_export=args.nps,
        folder_with_segs_from_prev_stage=args.prev_stage_predictions,
        part_id=args.part_id, num_parts=args.num_parts)


if __name__ == "__main__":
    predict_entry_point()
