"""Evaluation and postprocessing entries — a copy of
fast_nnunet_tpu/run/evaluate.py: ``fast_nnunet_evaluate_folder_torch``,
``fast_nnunet_evaluate_simple_torch``, ``fast_nnunet_plot_overlay_pngs_torch``,
``fast_nnunet_apply_postprocessing_torch`` and
``fast_nnunet_determine_postprocessing_torch``. Each takes ``argv`` (None:
the command line). Host work only: nothing here touches the card."""
import argparse

from ..core.plans import PlansManager
from ..evaluation.metrics import compute_metrics_on_folder
from ..utils.io import join, load_json


def evaluate_folder_entry(argv=None):
    parser = argparse.ArgumentParser(description="evaluate predictions vs GT")
    parser.add_argument("gt_folder")
    parser.add_argument("pred_folder")
    parser.add_argument("-djfile", required=True, help="dataset.json")
    parser.add_argument("-pfile", required=True, help="plans.json")
    parser.add_argument("-o", default=None, help="output summary.json "
                        "(default: pred_folder/summary.json)")
    parser.add_argument("-np", type=int, default=8)
    parser.add_argument("--chill", action="store_true",
                        help="don't fail on missing predictions")
    args = parser.parse_args(argv)

    dataset_json = load_json(args.djfile)
    plans_manager = PlansManager(args.pfile)
    lm = plans_manager.get_label_manager(dataset_json)
    rw = plans_manager.image_reader_writer_class()()
    out = args.o or join(args.pred_folder, "summary.json")
    result = compute_metrics_on_folder(
        args.gt_folder, args.pred_folder, out, rw, dataset_json["file_ending"],
        lm.foreground_regions if lm.has_regions else lm.foreground_labels,
        lm.ignore_label, args.np, chill=args.chill)
    print(f"mean fg Dice: {result['foreground_mean']['Dice']:.4f} -> {out}")


def evaluate_simple_entry(argv=None):
    """Evaluate with an explicit label list — no plans/dataset.json needed
    (ref evaluate_predictions.py evaluate_simple_entry_point:233-250)."""
    parser = argparse.ArgumentParser(description="evaluate predictions vs GT "
                                                 "given an explicit label list")
    parser.add_argument("gt_folder")
    parser.add_argument("pred_folder")
    parser.add_argument("-l", type=int, nargs="+", required=True,
                        help="list of (foreground) labels")
    parser.add_argument("-il", type=int, default=None, help="ignore label")
    parser.add_argument("-o", default=None, help="output summary.json "
                        "(default: pred_folder/summary.json)")
    parser.add_argument("-np", type=int, default=8)
    parser.add_argument("--chill", action="store_true",
                        help="don't fail on missing predictions")
    args = parser.parse_args(argv)

    from ..imageio.registry import determine_reader_writer_from_file_ending
    from ..utils.io import subfiles
    files = subfiles(args.gt_folder)
    endings = [e for e in (".nii.gz", ".nii", ".nrrd", ".mha", ".png", ".tif")
               if any(f.endswith(e) for f in files)]
    file_ending = endings[0] if endings else ".nii.gz"
    rw = determine_reader_writer_from_file_ending(file_ending)()
    out = args.o or join(args.pred_folder, "summary.json")
    result = compute_metrics_on_folder(
        args.gt_folder, args.pred_folder, out, rw, file_ending,
        tuple(args.l), args.il, args.np, chill=args.chill)
    print(f"mean fg Dice: {result['foreground_mean']['Dice']:.4f} -> {out}")


def plot_overlay_entry(argv=None):
    """Overlay pngs of the most-foreground slice per case (ref
    utilities/overlay_plots.py entry_point_generate_overlay:247-279)."""
    from ..utils.overlay_plots import generate_overlays_for_folder
    parser = argparse.ArgumentParser(
        description="plot png overlays of the slice with the most foreground")
    parser.add_argument("-i", required=True, help="images folder")
    parser.add_argument("-s", required=True, help="segmentations folder")
    parser.add_argument("-o", required=True, help="output folder")
    parser.add_argument("-overlay_intensity", type=float, default=0.6)
    parser.add_argument("--file_ending", default=".nii.gz")
    args = parser.parse_args(argv)
    from ..imageio.registry import determine_reader_writer_from_file_ending
    rw = determine_reader_writer_from_file_ending(args.file_ending)()
    generate_overlays_for_folder(args.i, args.s, args.o, rw,
                                 file_ending=args.file_ending,
                                 overlay_intensity=args.overlay_intensity)
    print(f"overlays -> {args.o}")


def apply_postprocessing_entry(argv=None):
    parser = argparse.ArgumentParser(description="apply a saved postprocessing "
                                                 "pipeline to a folder")
    parser.add_argument("-i", required=True)
    parser.add_argument("-o", required=True)
    parser.add_argument("-pp_json", required=True, help="postprocessing.json")
    parser.add_argument("-djfile", required=True)
    parser.add_argument("-pfile", required=True)
    parser.add_argument("-np", type=int, default=8)
    args = parser.parse_args(argv)

    from ..postprocessing.connected_components import apply_postprocessing_to_folder
    pp = load_json(args.pp_json)
    dataset_json = load_json(args.djfile)
    plans_manager = PlansManager(args.pfile)
    apply_postprocessing_to_folder(args.i, args.o, pp["pp_fns"],
                                   pp["pp_fn_kwargs"], plans_manager,
                                   dataset_json, args.np)
    print(f"postprocessed {args.i} -> {args.o}")


def determine_postprocessing_entry(argv=None):
    parser = argparse.ArgumentParser(description="search postprocessing steps that "
                                                 "do not hurt Dice")
    parser.add_argument("-i", required=True, help="predictions folder")
    parser.add_argument("-ref", required=True, help="ground truth folder")
    parser.add_argument("-djfile", required=True)
    parser.add_argument("-pfile", required=True)
    parser.add_argument("-np", type=int, default=8)
    args = parser.parse_args(argv)

    from ..postprocessing.connected_components import determine_postprocessing
    dataset_json = load_json(args.djfile)
    plans_manager = PlansManager(args.pfile)
    fns, kwargs, metrics = determine_postprocessing(
        args.i, args.ref, plans_manager, dataset_json, args.np)
    print(f"accepted steps: {fns} -> {join(args.i, 'postprocessing.json')}; "
          f"mean fg Dice after pp: {metrics['foreground_mean']['Dice']:.4f}")
