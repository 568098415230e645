#!/usr/bin/env python3
"""Host route against device route, in the JAX package and in the port, at
the serving path's bf16 compute, on the CPU: how far the two routes'
masks agree on one input and one set of weights, in each package.

The network is the bone_turbo r = 2 student (chip_smoke.py's phase 2) cut
in depth to ``--stages`` stages (widths kept), with seeded random weights
(``random_plain_params``), 61 classes, the INI's patch, spacing, intensity
window, tile step and air skipping, bf16 compute and a bf16 sweep
accumulator; the input is the synthetic CT phantom at ``--size``. The
device route runs with ``host_revert=True``, as JAX's own pin
(tests/test_hostops.py) does; both packages' host routes run the port's
host library (``csrc/host_ops.cpp``, built with the host compiler).

    python tools/route_agreement.py [--size 192 192 160] [--stages 4]
        [--seed 0] [--tile_batch 2]

Prints one JSON line: each package's host-vs-device agreement, the
cross-package agreements of each route, the grid shape and seconds. Needs
JAX (CPU) and the port; no card.
"""
import argparse
import configparser
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, nargs=3, default=(192, 192, 160))
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tile_batch", type=int, default=2)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    import chip_smoke
    from fast_nnunet_tpu.inference.engine import \
        SlidingWindowEngine as JaxEngine
    from fast_nnunet_tpu.inference.turbo import TurboConfig as JaxConfig
    from fast_nnunet_tpu.inference.turbo import TurboPipeline as JaxPipeline
    from fast_nnunet_tpu.models.factory import get_network_from_plans
    from fast_nnunet_tpu.models.s2d import make_s2d_engine_net as jax_s2d
    from fast_nnunet_tpu.utils import hostops as jh
    from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
    from fast_nnunet_tpu_torch.inference.turbo import (TurboConfig,
                                                       TurboPipeline)
    from fast_nnunet_tpu_torch.models.s2d import (make_s2d_engine_net,
                                                  params_from_jax,
                                                  random_plain_params)
    from fast_nnunet_tpu_torch.models.students import \
        build_student_arch_kwargs
    from fast_nnunet_tpu_torch.ops import _build
    from fast_nnunet_tpu_torch.utils.synthetic_ct import make_synthetic_ct

    jh._CANDIDATES = (_build.host_library()._name,)
    jh._LIB, jh._TRIED = None, False
    assert jh.available(), "the JAX package cannot load the host library"

    n = args.stages
    full = build_student_arch_kwargs(chip_smoke.TEACHER_ARCH, 2)
    arch = dict(full, n_stages=n,
                features_per_stage=full["features_per_stage"][:n],
                kernel_sizes=full["kernel_sizes"][:n],
                strides=full["strides"][:n],
                n_conv_per_stage=full["n_conv_per_stage"][:n],
                n_conv_per_stage_decoder=full["n_conv_per_stage_decoder"][
                    :n - 1],
                nonlin="torch.nn.LeakyReLU")
    ini = os.path.join(os.getcwd(), "engine", "config",
                       "fast_nnunet_bone_turbo.ini")
    cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
    cp.read(ini)
    inf = cp["inference"]
    cfg_p = TurboConfig.from_ini(ini)
    cfg_j = JaxConfig.from_ini(ini)
    k = cfg_p.num_classes
    plain = random_plain_params(arch, 1, k, seed=args.seed)
    jnet = get_network_from_plans("PlainConvUNet", arch, (), 1, k,
                                  dtype=jnp.bfloat16)
    js2d = jax_s2d(jnet, arch, k, dtype=jnp.bfloat16)
    jtree = js2d.convert_params(plain)
    tree = jax.tree_util.tree_map(np.asarray, jtree)
    tnet = make_s2d_engine_net(arch, k, 1, compute_dtype=torch.bfloat16)
    params_from_jax(tnet, tree)
    kw = dict(air_skip=inf.getboolean("skip_air_tiles", True),
              air_margin_hu=inf.getfloat("air_margin_hu", 200.0))
    ct, spacing = make_synthetic_ct(tuple(args.size), (0.8, 0.8, 1.0),
                                    seed=args.seed)

    jeng = JaxEngine(js2d, cfg_j.patch_size, k,
                     tile_step_size=cfg_j.step_size,
                     use_gaussian=cfg_j.use_gaussian,
                     compute_dtype=jnp.bfloat16, sweep_acc_dtype=jnp.bfloat16,
                     shape_bucket=32, tile_batch=args.tile_batch,
                     use_s2d_sweep=True)
    teng = SlidingWindowEngine(tnet, cfg_p.patch_size, k,
                               tile_step_size=cfg_p.step_size,
                               use_gaussian=cfg_p.use_gaussian,
                               compute_dtype=torch.bfloat16,
                               sweep_acc_dtype=torch.bfloat16,
                               shape_bucket=32, tile_batch=args.tile_batch,
                               device="cpu")
    masks, seconds = {}, {}
    for pkg, make, params in (
            ("jax", lambda **r: JaxPipeline(jeng, cfg_j, **kw, **r), jtree),
            ("port", lambda **r: TurboPipeline(teng, cfg_p, **kw, **r),
             tree)):
        for route, r in (("device", dict(host_preprocess=False,
                                         host_revert=True)),
                         ("host", dict(host_preprocess=True))):
            t0 = time.perf_counter()
            masks[pkg, route] = np.asarray(
                make(**r).predict_volume(params, ct, spacing))
            seconds[f"{pkg}_{route}"] = time.perf_counter() - t0

    def agree(a, b):
        return float((masks[a] == masks[b]).mean())

    print(json.dumps({
        "ct": list(ct.shape), "stages": n,
        "features": arch["features_per_stage"], "classes": k,
        "tile_batch": args.tile_batch, "seed": args.seed,
        "labels_in_mask": int(len(np.unique(masks["port", "host"]))),
        "jax_host_vs_device": agree(("jax", "host"), ("jax", "device")),
        "port_host_vs_device": agree(("port", "host"), ("port", "device")),
        "host_port_vs_jax": agree(("port", "host"), ("jax", "host")),
        "device_port_vs_jax": agree(("port", "device"), ("jax", "device")),
        "seconds": seconds}))


if __name__ == "__main__":
    main()
