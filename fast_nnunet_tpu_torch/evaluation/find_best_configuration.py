"""Find the best configuration — a copy of
fast_nnunet_tpu/evaluation/find_best_configuration.py: accumulate the
cross-validation results of every trainer x plans x configuration, evaluate
each and every pair's ensemble, pick the best, determine its postprocessing
and write the inference instructions (``inference_information.json``,
``inference_report.md`` and ``.html``). The commands name the port's console
scripts; a cascade configuration still gets its command chain as text,
although the port's predictor does not take ``-prev_stage_predictions`` yet
(ROADMAP.md §1 item 5)."""
import argparse
import itertools
import os
import shutil
from typing import List

from ..core.plans import PlansManager
from ..ensembling.ensemble import ensemble_crossvalidations
from ..postprocessing.connected_components import determine_postprocessing
from ..utils.io import (isdir, join, load_json, maybe_mkdir_p, save_json,
                        subfiles)
from ..utils.misc import get_output_folder, maybe_convert_to_dataset_name
from .metrics import compute_metrics_on_folder

#: the port's console scripts that the inference instructions name
PREDICT = "fast_nnunet_predict_torch"
ENSEMBLE = "fast_nnunet_ensemble_torch"
APPLY_POSTPROCESSING = "fast_nnunet_apply_postprocessing_torch"

default_trained_models = tuple({"plans": "nnUNetPlans", "configuration": c,
                                "trainer": "NNUNetTrainer"}
                               for c in ("2d", "3d_fullres", "3d_lowres",
                                         "3d_cascade_fullres"))


def filter_available_models(models, dataset_name_or_id, strict: bool = False):
    """Cascade-prerequisite checks (ref find_best_configuration.py:27-50):
    configurations absent from the plans (3d_lowres / 3d_cascade_fullres do
    not exist for small datasets) are skipped with a message; a configuration
    that IS planned but has no trained output folder is an error when
    `strict`, otherwise skipped."""
    from ..paths import get_preprocessed_folder
    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    valid = []
    for model in models:
        plans_file = join(get_preprocessed_folder(), dataset_name,
                          model["plans"] + ".json")
        plans_manager = PlansManager(plans_file)
        if model["configuration"] not in plans_manager.available_configurations:
            print(f"Configuration {model['configuration']} not found in plans "
                  f"{model['plans']} ({plans_file}); skipping.")
            continue
        folder = get_output_folder(dataset_name, model["trainer"],
                                   model["plans"], model["configuration"])
        if not isdir(folder):
            if strict:
                raise RuntimeError(
                    f"Trained model {model} has no output folder (expected "
                    f"{folder}). Train this configuration first — and use "
                    f"--npz so its validation predictions can be ensembled.")
            print(f"Skipping untrained {model} (no folder {folder}).")
            continue
        valid.append(model)
    return valid


def generate_inference_command(dataset_name, configuration: str,
                               plans: str = "nnUNetPlans",
                               trainer: str = "NNUNetTrainer",
                               folds=(0, 1, 2, 3, 4),
                               output_folder: str = "OUTPUT_FOLDER",
                               save_probabilities: bool = False) -> str:
    """Predict command(s) for one configuration; a cascade stage is
    recursively prefixed with its previous stage writing
    OUTPUT_FOLDER_PREV_STAGE (ref find_best_configuration.py:53-80)."""
    folder = get_output_folder(dataset_name, trainer, plans, configuration)
    prev = None
    try:
        # read previous_stage from the raw plans dict (walking inherits_from)
        # — no ConfigurationManager needed just for the cascade chain
        cfgs = PlansManager(join(folder, "plans.json")).plans["configurations"]
        name = configuration
        while name in cfgs:
            if "previous_stage" in cfgs[name]:
                prev = cfgs[name]["previous_stage"]
                break
            name = cfgs[name].get("inherits_from")
            if name is None:
                break
    except (FileNotFoundError, KeyError):
        pass
    lines = []
    prev_arg = ""
    if prev:
        lines.append(generate_inference_command(
            dataset_name, prev, plans, trainer, folds,
            output_folder="OUTPUT_FOLDER_PREV_STAGE"))
        prev_arg = " -prev_stage_predictions OUTPUT_FOLDER_PREV_STAGE"
    fold_str = " ".join(str(f) for f in folds)
    cmd = (f"{PREDICT} -d {dataset_name} -i INPUT_FOLDER "
           f"-o {output_folder} -f {fold_str} -tr {trainer} "
           f"-c {configuration} -p {plans}{prev_arg}")
    if save_probabilities:
        cmd += " --save_probabilities"
    lines.append(cmd)
    return "\n".join(lines)


def accumulate_cv_results(trained_model_folder: str, merged_output_folder: str,
                          folds: List[int], num_processes: int = 8,
                          overwrite: bool = True) -> None:
    """Copy every fold's validation predictions into one folder (each case is
    validated in exactly one fold) and evaluate it as a whole."""
    if overwrite and isdir(merged_output_folder):
        shutil.rmtree(merged_output_folder)
    maybe_mkdir_p(merged_output_folder)

    dataset_json = load_json(join(trained_model_folder, "dataset.json"))
    plans_manager = PlansManager(join(trained_model_folder, "plans.json"))
    rw = plans_manager.image_reader_writer_class()()
    fe = dataset_json["file_ending"]

    for f in folds:
        val_folder = join(trained_model_folder, f"fold_{f}", "validation")
        assert isdir(val_folder), f"fold {f} has no validation folder; " \
                                  "run training with final validation"
        for file in subfiles(val_folder, suffix=fe, join_path=False):
            shutil.copy(join(val_folder, file), join(merged_output_folder, file))

    from ..paths import get_raw_folder
    gt_folder = join(get_raw_folder(), plans_manager.dataset_name, "labelsTr")
    label_manager = plans_manager.get_label_manager(dataset_json)
    compute_metrics_on_folder(
        gt_folder, merged_output_folder, join(merged_output_folder, "summary.json"),
        rw, fe,
        label_manager.foreground_regions if label_manager.has_regions
        else label_manager.foreground_labels,
        label_manager.ignore_label, num_processes)


def find_best_configuration(dataset_name_or_id,
                            allowed_trained_models=default_trained_models,
                            allow_ensembling: bool = True,
                            num_processes: int = 8,
                            overwrite: bool = True,
                            folds: List[int] = (0, 1, 2, 3, 4),
                            strict: bool = False) -> dict:
    from ..paths import get_raw_folder, get_results_folder
    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    all_results = {}

    allowed_trained_models = filter_available_models(
        allowed_trained_models, dataset_name_or_id, strict=strict)
    for model in allowed_trained_models:
        folder = get_output_folder(dataset_name, model["trainer"], model["plans"],
                                   model["configuration"])
        identifier = os.path.basename(folder)
        merged = join(get_results_folder(), dataset_name, "crossval_results_folds_"
                      + "_".join(str(f) for f in folds), identifier)
        accumulate_cv_results(folder, merged, folds, num_processes, overwrite)
        summary = load_json(join(merged, "summary.json"))
        all_results[identifier] = {
            "source": "single", "folder": merged, "model": model,
            "mean_fg_dice": summary["foreground_mean"]["Dice"]}

    if allow_ensembling and len(all_results) > 1:
        singles = list(all_results.items())
        for (id_a, a), (id_b, b) in itertools.combinations(singles, 2):
            folder_a = get_output_folder(dataset_name, a["model"]["trainer"],
                                         a["model"]["plans"],
                                         a["model"]["configuration"])
            folder_b = get_output_folder(dataset_name, b["model"]["trainer"],
                                         b["model"]["plans"],
                                         b["model"]["configuration"])
            ens_id = f"ensemble___{id_a}___{id_b}"
            ens_folder = join(get_results_folder(), dataset_name,
                              "ensembles", ens_id)
            try:
                ensemble_crossvalidations([folder_a, folder_b], ens_folder,
                                          list(folds), num_processes)
            except (RuntimeError, AssertionError) as e:
                print(f"Skipping {ens_id}: {e}")
                continue
            dataset_json = load_json(join(folder_a, "dataset.json"))
            plans_manager = PlansManager(join(folder_a, "plans.json"))
            rw = plans_manager.image_reader_writer_class()()
            lm = plans_manager.get_label_manager(dataset_json)
            gt_folder = join(get_raw_folder(), dataset_name, "labelsTr")
            summary = compute_metrics_on_folder(
                gt_folder, ens_folder, join(ens_folder, "summary.json"), rw,
                dataset_json["file_ending"],
                lm.foreground_regions if lm.has_regions else lm.foreground_labels,
                lm.ignore_label, num_processes)
            all_results[ens_id] = {
                "source": "ensemble", "folder": ens_folder,
                "models": (a["model"], b["model"]),
                "mean_fg_dice": summary["foreground_mean"]["Dice"]}

    assert all_results, "no trained models found to choose from"
    best = max(all_results, key=lambda k: all_results[k]["mean_fg_dice"])
    best_entry = all_results[best]
    print(f"Best configuration: {best} "
          f"(mean fg Dice {best_entry['mean_fg_dice']:.4f})")

    # postprocessing on the best result
    some_model = best_entry.get("model") or best_entry["models"][0]
    ref_folder_for_plans = get_output_folder(
        dataset_name, some_model["trainer"], some_model["plans"],
        some_model["configuration"])
    dataset_json = load_json(join(ref_folder_for_plans, "dataset.json"))
    plans_manager = PlansManager(join(ref_folder_for_plans, "plans.json"))
    gt_folder = join(get_raw_folder(), dataset_name, "labelsTr")
    pp_fns, pp_kwargs, pp_metrics = determine_postprocessing(
        best_entry["folder"], gt_folder, plans_manager, dataset_json,
        num_processes)

    result = {
        "folds": list(folds),
        "dataset_name_or_id": str(dataset_name_or_id),
        "considered_manually": {k: v["mean_fg_dice"] for k, v in all_results.items()},
        "best_model_or_ensemble": {
            "identifier": best,
            "source": best_entry["source"],
            "mean_fg_dice": best_entry["mean_fg_dice"],
            "selected_model_or_models": best_entry.get("model")
            or list(best_entry["models"]),
            "postprocessing_fns": pp_fns,
            "postprocessing_kwargs": pp_kwargs,
            "mean_fg_dice_after_pp": pp_metrics["foreground_mean"]["Dice"],
        },
    }
    from ..paths import get_results_folder as grf
    save_json(result, join(grf(), dataset_name, "inference_information.json"),
              sort_keys=False)

    print("\n*** Inference instructions ***")
    models = best_entry.get("model")
    models = [models] if models else list(best_entry["models"])
    commands = []
    for m in models:
        # cascade members expand to their full prev-stage chain
        commands.append(generate_inference_command(
            dataset_name, m["configuration"], m["plans"], m["trainer"], folds,
            save_probabilities=len(models) > 1))
        print(commands[-1])
    if len(models) > 1:
        commands.append(f"{ENSEMBLE} -i OUT1 OUT2 -o FINAL")
        print(f"  # then: {ENSEMBLE} -i OUT1 OUT2 -o FINAL")
    if pp_fns:
        print(f"  # then apply postprocessing.json with "
              f"{APPLY_POSTPROCESSING}")
    write_markdown_report(result, commands,
                          join(grf(), dataset_name, "inference_report.md"))
    write_html_report(result, commands,
                      join(grf(), dataset_name, "inference_report.html"))
    return result


def write_markdown_report(result: dict, commands, path: str) -> None:
    """Human-readable companion of inference_information.json (the reference
    only prints to stdout; the JSON + this report persist the decision)."""
    best = result["best_model_or_ensemble"]
    lines = [
        f"# Best configuration — {result['dataset_name_or_id']}",
        "",
        f"Folds considered: {', '.join(str(f) for f in result['folds'])}",
        "",
        "## Candidates (mean foreground Dice, 5-fold cross-validation)",
        "",
        "| configuration | mean fg Dice | |",
        "|---|---|---|",
    ]
    for k, v in sorted(result["considered_manually"].items(),
                       key=lambda kv: -kv[1]):
        marker = "**best**" if k == best["identifier"] else ""
        lines.append(f"| {k} | {v:.4f} | {marker} |")
    lines += [
        "",
        "## Selected",
        "",
        f"- identifier: `{best['identifier']}` ({best['source']})",
        f"- mean fg Dice: {best['mean_fg_dice']:.4f}",
        f"- postprocessing: {best['postprocessing_fns'] or 'none'}",
        f"- mean fg Dice after postprocessing: "
        f"{best['mean_fg_dice_after_pp']:.4f}",
        "",
        "## How to run inference",
        "",
        "```bash",
        *commands,
        "```",
        "",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def write_html_report(result: dict, commands, path: str) -> None:
    """Standalone HTML companion of the markdown report (openable without a
    markdown viewer; candidate Dice rendered as proportional bars)."""
    import html as _html
    best = result["best_model_or_ensemble"]
    cands = sorted(result["considered_manually"].items(),
                   key=lambda kv: -kv[1])
    vmax = max((v for _, v in cands), default=1.0) or 1.0
    rows = []
    for k, v in cands:
        star = " &#9733;" if k == best["identifier"] else ""
        w = int(100 * v / vmax)
        rows.append(
            f"<tr><td><code>{_html.escape(k)}</code>{star}</td>"
            f"<td style='text-align:right'>{v:.4f}</td>"
            f"<td><div style='background:#4a7bd0;height:0.8em;"
            f"width:{w}%'></div></td></tr>")
    cmds = "\n".join(_html.escape(c) for c in commands)
    doc = f"""<!doctype html><html><head><meta charset="utf-8">
<title>Best configuration — {_html.escape(str(result['dataset_name_or_id']))}</title>
<style>body{{font:14px/1.5 system-ui,sans-serif;max-width:60em;margin:2em auto;
padding:0 1em;color:#222}}table{{border-collapse:collapse;width:100%}}
td,th{{padding:0.3em 0.6em;border-bottom:1px solid #ddd}}
pre{{background:#f6f6f6;padding:1em;overflow-x:auto}}
code{{background:#f0f0f0;padding:0 0.2em}}</style></head><body>
<h1>Best configuration — {_html.escape(str(result['dataset_name_or_id']))}</h1>
<p>Folds considered: {', '.join(str(f) for f in result['folds'])}</p>
<h2>Candidates (mean foreground Dice, cross-validation)</h2>
<table><tr><th>configuration</th><th>mean fg Dice</th><th></th></tr>
{''.join(rows)}</table>
<h2>Selected</h2>
<ul>
<li>identifier: <code>{_html.escape(best['identifier'])}</code>
 ({_html.escape(best['source'])})</li>
<li>mean fg Dice: {best['mean_fg_dice']:.4f}</li>
<li>postprocessing: {_html.escape(str(best['postprocessing_fns'] or 'none'))}</li>
<li>mean fg Dice after postprocessing: {best['mean_fg_dice_after_pp']:.4f}</li>
</ul>
<h2>How to run inference</h2>
<pre>{cmds}</pre>
</body></html>"""
    with open(path, "w") as f:
        f.write(doc)


def find_best_configuration_entry(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_name_or_id")
    parser.add_argument("-p", nargs="+", default=["nnUNetPlans"])
    parser.add_argument("-c", nargs="+",
                        default=["2d", "3d_fullres", "3d_lowres",
                                 "3d_cascade_fullres"])
    parser.add_argument("-tr", nargs="+", default=["NNUNetTrainer"])
    parser.add_argument("-np", type=int, default=8)
    parser.add_argument("-f", nargs="+", type=int, default=[0, 1, 2, 3, 4])
    parser.add_argument("--disable_ensembling", action="store_true")
    parser.add_argument("--strict", action="store_true",
                        help="error (instead of skip) when a planned "
                             "configuration has not been trained")
    args = parser.parse_args(argv)
    models = [{"plans": p, "configuration": c, "trainer": t}
              for p in args.p for c in args.c for t in args.tr]
    find_best_configuration(args.dataset_name_or_id, models,
                            not args.disable_ensembling, args.np,
                            folds=args.f, strict=args.strict)
