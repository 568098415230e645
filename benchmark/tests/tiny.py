"""Cells at a size a CPU test run holds: the configurations' and mixes'
layout with small widths, patches and studies."""
import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def arch(features):
    n = len(features)
    return {"n_stages": n, "features_per_stage": list(features),
            "kernel_sizes": [[3, 3, 3]] * n,
            "strides": [[1, 1, 1]] + [[2, 2, 2]] * (n - 1),
            "n_conv_per_stage": [2] * n,
            "n_conv_per_stage_decoder": [2] * (n - 1), "conv_bias": True,
            "norm_op_kwargs": {"eps": 1e-5, "affine": True},
            "nonlin_kwargs": {"inplace": True}}


def planned_arch(features):
    """:func:`arch` with the planner's anisotropic start (as
    teacher_3d_fullres): a 1 x 3 x 3 first stage, then stride 1 x 2 x 2."""
    a = arch(features)
    a["kernel_sizes"][0] = [1, 3, 3]
    if len(features) > 1:
        a["strides"][1] = [1, 2, 2]
    return a


def serve_files(mix="serve"):
    cfg = copy.deepcopy(_load("configs", "bone_turbo.json"))
    cfg["network"] = arch([4, 8, 16])
    cfg["num_classes"] = 5
    sv = cfg["serving"]
    sv["patch_size"] = [32, 16, 16]
    sv["target_spacing"] = [4.0, 3.0, 3.0]
    sv["tile_batch"] = 4
    traffic = copy.deepcopy(_load("traffic", mix + ".json"))
    traffic.update(cycle=3, in_plane=40, spacing_mm=[1.6, 2.0],
                   z_extent_mm=[120, 160], slice_mm=[2.0, 2.5], check_cts=2,
                   trace_cts=1)
    return {"cell": {"name": "tiny", "chips": 1}, "config": cfg,
            "traffic": traffic,
            # CPU readings at this size: the program's widest gap
            # 0.035-0.090, the float8 control's 0.30-0.65
            "limits": {"gap": {"limit": 0.2},
                       "exact_mismatch": {"limit": 0}},
            "end_to_end": [{"name": "ct_s", "unit": "s/CT"},
                           {"name": "ct_p90_s", "unit": "s"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": []}


def train_files(mix="train"):
    cfg = copy.deepcopy(_load("configs", "teacher_3d_fullres.json"))
    cfg["network"] = planned_arch([4, 8, 16])
    cfg["num_classes"] = 5
    cfg["num_training_cases"] = 2
    cfg["case_shape"] = [40, 48, 48]
    cfg["training"]["patch_size"] = [32, 16, 16]
    traffic = copy.deepcopy(_load("traffic", mix + ".json"))
    traffic.update(fold="all", trace_iters=2)
    # CPU readings at this size (train and distill, seeds 20-27 and 31):
    # the program's loss gap up to 5.5e-4, median-leaf first gradient
    # 0.0102, change 0.0108; the float8 control's (seeds 20-23) at least
    # 1.27e-3, 0.014, 0.0093
    limits = {"loss": {"limit": 1e-3}, "first_grad": {"limit": 0.013},
              "change": {"limit": 0.014}}
    files = {"cell": {"name": "tiny", "chips": 1}, "config": cfg,
             "traffic": traffic, "limits": limits,
             "end_to_end": [{"name": "iter_s", "unit": "s/iter"},
                            {"name": "setup_s", "unit": "s"}],
             "per_layer": []}
    if mix == "distill":
        student = copy.deepcopy(_load("configs", "bone_turbo.json"))
        cfg["network"] = planned_arch([16, 16, 32])
        student["network"] = arch([8, 8, 16])
        student["distillation"]["student_plans_network"] = arch([16, 16, 32])
        student["num_classes"] = 5
        files["config"] = student
        files["teacher"] = cfg
    return files
