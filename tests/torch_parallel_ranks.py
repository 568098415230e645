"""What the spawned ranks of tests/test_torch_parallel.py and
tests/test_torch_sharded.py run (parallel/distributed.py ``spawn`` pickles
these functions by reference). The module imports no JAX: a rank imports
the port only, and the parent process holds the results against the JAX
package. Inputs and weights come from the parent, made with numpy from a
seed."""
import numpy as np
import torch

K = 3
SHARD_ARCH = {"n_stages": 2, "features_per_stage": [4, 8],
              "kernel_sizes": [[3, 3, 3]] * 2,
              "strides": [[1, 1, 1], [2, 2, 2]],
              "n_conv_per_stage": [1, 1], "n_conv_per_stage_decoder": [1],
              "nonlin": "torch.nn.LeakyReLU"}
S2D_ARCH = dict(SHARD_ARCH, n_conv_per_stage=[2, 2],
                n_conv_per_stage_decoder=[2])
SHARD_PATCH = (8, 8, 8)


# ------------------------------------------------------------------ sharded
def sharded_engine(kind: str, tile_batch: int, tree: dict,
                   device="cpu"):
    """(engine, weights) of the sharded tests: "plain" (the reference grid,
    torch accumulate), "fused" (kernel D) or "s2d" (kernels C and B), all
    float32."""
    from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
    from fast_nnunet_tpu_torch.models.factory import get_network_from_plans
    from fast_nnunet_tpu_torch.models.s2d import make_s2d_engine_net
    if kind == "s2d":
        net = make_s2d_engine_net(S2D_ARCH, K, 1,
                                  compute_dtype=torch.float32).to(device)
        return SlidingWindowEngine(
            net, SHARD_PATCH, K, shape_bucket=4, compute_dtype=torch.float32,
            sweep_acc_dtype=torch.float32, tile_batch=tile_batch,
            device=device), net.convert_params(tree)
    net = get_network_from_plans("PlainConvUNet", SHARD_ARCH, (), 1, K,
                                 compute_dtype=torch.float32).to(device)
    return SlidingWindowEngine(
        net, SHARD_PATCH, K, shape_bucket=4, compute_dtype=torch.float32,
        tile_batch=tile_batch, use_fused_accumulate=kind == "fused",
        device=device), tree


def sharded_masks(jobs, device="cpu"):
    """Each job (name, kind, tile_batch, tree, volume, halo_exact) through
    the slab-parallel sweep of its kind; rank 0 returns {name: mask}."""
    from fast_nnunet_tpu_torch.inference import sharded
    torch.set_num_threads(2)  # the suite runs several xdist workers
    out = {}
    for name, kind, tile_batch, tree, vol, exact in jobs:
        eng, params = sharded_engine(kind, tile_batch, tree, device)
        fn = sharded.predict_segmentation_multigpu_s2d if kind == "s2d" \
            else sharded.predict_segmentation_multigpu
        out[name] = fn(eng, params, vol, halo_exact=exact)
    return out


def mesh_space_masks(tree, vol):
    """A 2 x 2 (data, space) mesh of 4 ranks: each data row sweeps the
    volume over its two space ranks; each row's first rank returns its
    mask, with its (data, space) position."""
    from fast_nnunet_tpu_torch.inference import sharded
    from fast_nnunet_tpu_torch.parallel import make_mesh, rank
    mesh = make_mesh(n_data=2, n_space=2)
    group = mesh.group("space")
    eng, params = sharded_engine("plain", 4, tree)
    seg = sharded.predict_segmentation_multigpu(eng, params, vol, group=group)
    d, s = (int(v[0]) for v in np.nonzero(mesh.ranks == rank()))
    return {"position": (d, s), "mask": seg,
            "groups": mesh.axis_ranks("space")}


# ------------------------------------------------------------------ training
def _port_net(case: dict, tree: dict):
    from fast_nnunet_tpu_torch.models import factory as pfactory
    from fast_nnunet_tpu_torch.models.unet import params_from_jax
    kw = dict(compute_dtype=torch.float32, trainable=True)
    if not case.get("bn"):
        kw.update(norm_onepass=True, remat=case.get("remat", False))
    net = pfactory.get_network_from_plans("PlainConvUNet", case["arch"], (),
                                          1, case["k"], **kw)
    return params_from_jax(net, tree)


def _local(batch, r: int, n: int):
    """Rank r's slice of a global (x, labels) batch, NCDHW tensors."""
    x, labels = batch
    b = x.shape[0] // n
    sl = slice(r * b, (r + 1) * b)
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x[sl], -1, 1)))
    return xt, tuple(torch.from_numpy(t[sl].astype(np.int64))
                     for t in labels)


def train_cases(cases: dict) -> dict:
    """Each case's port steps on this rank's slices of its global batches
    (``group`` the world): the returned losses, the step's skip count and
    the final weights in the JAX tree layout."""
    from fast_nnunet_tpu_torch.models.blocks import sync_batch_stats
    from fast_nnunet_tpu_torch.models.unet import params_to_jax
    from fast_nnunet_tpu_torch.parallel import distributed as pdist
    from fast_nnunet_tpu_torch.training import distill as pdistill
    from fast_nnunet_tpu_torch.training import optimizers as popt
    from fast_nnunet_tpu_torch.training import schedules as psched
    from fast_nnunet_tpu_torch.training import train_step as pstep
    torch.set_num_threads(2)
    group = pdist.data_group()
    r, n = pdist.rank(), pdist.world_size()
    out = {}
    for name, case in cases.items():
        net = sync_batch_stats(_port_net(case, case["tree"]), group)
        opt = popt.nnunet_sgd(net.parameters(), psched.poly_lr(1e-2, 10))
        if case.get("teachers"):
            teachers = [_port_net(dict(case, arch=case["teacher_arch"]), t)
                        for t in case["teachers"]]
            step = pdistill.make_distill_train_step(
                net, teachers, opt, alpha=0.3, temperature=3.0,
                n_ds_levels=case["n_ds"], batch_dice=case["batch_dice"],
                group=group)
        else:
            step = pstep.make_train_step(
                net, opt, n_ds_levels=case["n_ds"],
                batch_dice=case["batch_dice"],
                skip_nonfinite=case.get("skip_nonfinite", False),
                group=group)
        losses = []
        for batch in case["batches"]:
            got = step(*_local(batch, r, n))
            losses.append([float(v) for v in got] if isinstance(got, tuple)
                          else float(got))
        out[name] = {"losses": losses, "params": params_to_jax(net),
                     "skipped": getattr(step, "skipped", 0)}
    return out


def sweep_pair(kind: str, tile_batch: int, tree: dict, vol, exact: bool):
    """On this rank's card: the single-card sweep of ``kind`` and the
    slab-parallel one over the world, with the kernel launches of the
    latter (float32, TF32 off)."""
    from fast_nnunet_tpu_torch.inference import sharded
    from fast_nnunet_tpu_torch.ops import finalize, s2d_accumulate, stats
    from fast_nnunet_tpu_torch.ops import scatter_accumulate
    torch.backends.cudnn.allow_tf32 = False
    eng, params = sharded_engine(kind, tile_batch, tree, device="cuda")
    fns = (stats.spatial_sum_sumsq, s2d_accumulate.s2d_accumulate,
           finalize.grouped_argmax,
           scatter_accumulate.fused_scatter_accumulate)
    if kind == "s2d":
        eng.network.set_stats_min_voxels(1)
        single = eng.predict_segmentation_sweep_s2d(params, vol)
        fn = sharded.predict_segmentation_multigpu_s2d
    else:
        single = eng.predict_segmentation_sweep(params, vol)
        fn = sharded.predict_segmentation_multigpu
    n0 = [f.launches for f in fns]
    multi = fn(eng, params, vol, halo_exact=exact)
    return single, multi, [f.launches - n for f, n in zip(fns, n0)]
