"""Data-parallel training in the port (fast_nnunet_tpu_torch/parallel/,
the trainer's ranks) against the JAX package's global-batch step.

Ranks are spawned on the CPU under gloo (parallel/distributed.py ``spawn``,
tests/torch_parallel_ranks.py); each takes its slice of a seeded global
batch. One 2-rank step must equal JAX's ``make_train_step`` on the whole
batch sharded over a 2-device data mesh of the 8-device CPU mesh: batch
Dice on and off, a BatchNorm network (running averages too), deep
supervision with remat, the NaN watchdog with the NaN on one rank only,
the distillation step; losses and parameters within 1e-5 (float32
convolutions summed in another order), the replicas bit-equal. Also:
``local_batch_and_oversample`` and each rank's sampler against JAX's,
``-num_gpus 2`` and ``-num_hosts 2`` end to end through the CLI, and the
launcher's refusals."""
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.models.factory import get_network_from_plans as jax_net
from fast_nnunet_tpu.parallel import distributed as jdist
from fast_nnunet_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from fast_nnunet_tpu.training import distill as jdistill
from fast_nnunet_tpu.training import optimizers as jopt
from fast_nnunet_tpu.training import schedules as jsched
from fast_nnunet_tpu.training import train_step as jstep
from fast_nnunet_tpu_torch.models.students import build_student_arch_kwargs
from fast_nnunet_tpu_torch.parallel import distributed as pdist

from . import torch_parallel_ranks as ranks
from .test_torch_batchnorm import _bn, bn_tree
from .test_torch_train_e2e import DS, env  # noqa: F401 (fixture)
from .torch_port_common import (ARCH, K,  # noqa: F401 (fixture)
                                no_persistent_compile_cache, plain_params)

PATCH = (16, 16, 16)
N_DS = 2
GLOBAL_BATCH = 4
TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------- batch split
@pytest.mark.parametrize("batch,world", [(2, 1), (2, 2), (4, 2), (4, 4),
                                         (5, 2), (5, 3), (8, 4), (9, 4)])
def test_local_batch_and_oversample_matches_jax(batch, world):
    for oversample in (0.0, 0.33, 0.5, 1.0):
        sizes, n_fg = 0, 0
        for r in range(world):
            got = pdist.local_batch_and_oversample(batch, oversample, r,
                                                   world)
            assert got == jdist.local_batch_and_oversample(
                batch, oversample, r, world)
            sizes += got[0]
            n_fg += round(got[0] * got[1])
        # the global rule holds whatever the world: the last
        # round(bs * oversample) samples of the global batch are fg-forced
        assert sizes == batch
        assert n_fg == batch - round(batch * (1 - oversample))


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_sampler_matches_jax(env, monkeypatch, rank):  # noqa: F811
    """A rank's trainer samples its slice of the global batch with its
    share of the oversampling and seed 12345 + 7919 * rank; its sampler's
    batches equal JAX's sampler built with the same local batch,
    oversample and seed, bit for bit."""
    from fast_nnunet_tpu.training.dataloader import PatchSampler as JSampler
    from fast_nnunet_tpu.training.dataset import NpyCaseDataset as JDataset
    from fast_nnunet_tpu_torch.run.run_training import get_trainer_from_args
    monkeypatch.setenv("nnUNet_n_proc_DA", "1")
    trainer = get_trainer_from_args(DS, "3d_fullres", 0, device="cpu")
    trainer.rank, trainer.world_size = rank, 2
    trainer.configuration_manager.configuration["batch_size"] = 4
    trainer.get_dataloaders()
    loader = trainer.dataloader_train
    for d in (trainer.dataloader_train, trainer.dataloader_val):
        d.shutdown()
    bs, oversample = jdist.local_batch_and_oversample(
        4, trainer.oversample_foreground_percent, rank, 2)
    assert loader.seed == 12345 + 7919 * rank
    sampler = loader.sampler
    assert (sampler.batch_size, sampler.oversample) == (bs, oversample)
    sampler.transform = None
    tr_keys, _ = trainer.do_split()
    jsampler = JSampler(JDataset(trainer.preprocessed_dataset_folder,
                                 tr_keys), bs, sampler.initial_patch_size,
                        sampler.final_patch_size, oversample)
    rng_p, rng_j = (np.random.RandomState(loader.seed) for _ in range(2))
    for _ in range(3):
        a, b = sampler.generate_batch(rng_p), jsampler.generate_batch(rng_j)
        assert a.get("keys") == b.get("keys")
        np.testing.assert_array_equal(a["data"], b["data"])
        np.testing.assert_array_equal(a["target"], b["target"])


# --------------------------------------------------------------- steps
def _global_batch(seed, nan_rank=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(GLOBAL_BATCH, *PATCH, 1).astype(np.float32)
    lab = rng.randint(0, K, (GLOBAL_BATCH, *PATCH)).astype(np.int32)
    lab[:, 4:10, 4:10, 4:10] = 1
    lab[:GLOBAL_BATCH // 2][lab[:GLOBAL_BATCH // 2] == 2] = 0  # rank 0: no 2
    x[..., 0] += lab
    if nan_rank is not None:
        b = GLOBAL_BATCH // 2
        x[nan_rank * b:(nan_rank + 1) * b] = np.nan
    return x, (lab, lab[:, ::2, ::2, ::2])


def _cases():
    student = build_student_arch_kwargs(ARCH, 2)
    base = {"arch": ARCH, "k": K, "n_ds": N_DS, "batch_dice": False,
            "tree": plain_params(7),
            "batches": [_global_batch(0), _global_batch(1)]}
    return {
        "plain": base,
        "batch_dice": dict(base, batch_dice=True),
        "batchnorm": dict(base, arch=_bn(ARCH), bn=True,
                          tree=bn_tree("PlainConvUNet", 3)),
        "remat": dict(base, remat=True, batch_dice=True),
        "nan_on_one_rank": dict(base, skip_nonfinite=True, batches=[
            _global_batch(0), _global_batch(1, nan_rank=1),
            _global_batch(2)]),
        "distill": dict(base, arch=student, tree=plain_params(3, arch=student),
                        teacher_arch=ARCH, batch_dice=True,
                        teachers=[plain_params(10 + f) for f in range(2)]),
    }


@pytest.fixture(scope="module")
def two_rank_steps():
    cases = _cases()
    return cases, pdist.spawn(ranks.train_cases, 2, device="cpu",
                              args=(cases,))


def _jax_steps(case):
    """JAX's jitted step on the global batch sharded over a 2-device data
    mesh; a non-finite loss keeps the state (the Primus watchdog, JAX
    primus_trainers.py:84)."""
    mesh = make_mesh(n_data=2)
    kw = dict(dtype=jnp.float32)
    if not case.get("bn"):
        kw.update(norm_onepass=True, remat=case.get("remat", False))
    jnet = jax_net("PlainConvUNet", case["arch"], (), 1, K, **kw)
    opt = jopt.nnunet_sgd(jsched.poly_lr_jax(1e-2, 10))
    state = replicate(mesh, jstep.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, case["tree"]), opt))
    if case.get("teachers"):
        tnet = jax_net("PlainConvUNet", case["teacher_arch"], (), 1, K,
                       dtype=jnp.float32, norm_onepass=True)
        stacked = replicate(mesh, jax.tree_util.tree_map(
            lambda *a: jnp.stack([jnp.asarray(v) for v in a]),
            *case["teachers"]))
        dstep = jax.jit(jdistill.make_distill_train_step(
            jnet, tnet, opt, alpha=0.3, temperature=3.0,
            n_ds_levels=N_DS, n_teachers=2, batch_dice=case["batch_dice"],
            compute_dtype=jnp.float32))

        def step(st, x, t):
            st, *losses = dstep(st, stacked, x, t)
            return st, [float(v) for v in losses]
    else:
        tstep = jax.jit(jstep.make_train_step(
            jnet, opt, n_ds_levels=N_DS, batch_dice=case["batch_dice"],
            compute_dtype=jnp.float32))

        def step(st, x, t):
            st, loss = tstep(st, x, t)
            return st, float(loss)
    losses = []
    for x, labels in case["batches"]:
        data, targets = shard_batch(mesh, (x, labels))
        new, loss = step(state, data, tuple(targets))
        losses.append(loss)
        if case.get("skip_nonfinite") and not np.isfinite(loss):
            continue
        state = new
    return losses, jax.device_get(state.params)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", ["plain", "batch_dice", "batchnorm",
                                  "remat", "nan_on_one_rank", "distill"])
def test_two_rank_step_equals_jax_global_batch(two_rank_steps, name):
    cases, results = two_rank_steps
    case = cases[name]
    want_losses, want_params = _jax_steps(case)
    r0, r1 = results[0][name], results[1][name]
    # the replicas: the same losses and bit-equal weights on both ranks
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    p0, p1 = _leaves(r0["params"]), _leaves(r1["params"])
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
    # the global-batch step
    for got, want in zip(r0["losses"], want_losses):
        if not np.all(np.isfinite(want)):
            assert not np.all(np.isfinite(got))
            continue
        np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-7)
    want = _leaves(want_params)
    assert p0.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(p0[k], want[k], atol=TOL, rtol=TOL,
                                   err_msg=k)
    if name == "nan_on_one_rank":   # both ranks skipped the NaN step
        assert r0["skipped"] == r1["skipped"] == 1


def test_batch_dice_is_global_not_per_rank(two_rank_steps):
    """The test batches tell the global batch Dice from a rank's: class 2
    is absent from rank 0's slice, so the mean of per-rank batch-Dice
    losses (what a missing gather gives) is far from the global one,
    which the 2-rank step matches (above)."""
    from fast_nnunet_tpu_torch.training.losses import dc_and_ce_loss
    cases, results = two_rank_steps
    x, (lab, _) = cases["batch_dice"]["batches"][0]
    logits = torch.from_numpy(np.random.RandomState(0).randn(
        GLOBAL_BATCH, K, *PATCH).astype(np.float32))
    target = torch.from_numpy(lab.astype(np.int64))
    whole = float(dc_and_ce_loss(logits, target, batch_dice=True))
    halves = np.mean([float(dc_and_ce_loss(logits[s], target[s],
                                           batch_dice=True))
                      for s in (slice(0, 2), slice(2, 4))])
    assert abs(whole - halves) > 1e-2
    assert results[0]["batch_dice"]["losses"] != \
        results[0]["plain"]["losses"]


# --------------------------------------------------------------- end to end
def _rank_lines(text):
    return {int(m.group(1)): m.group(2) for m in re.finditer(
        r"^rank (\d+)/\d+ on \S+: (.*)$", text, re.M)}


def test_num_gpus_cli_trains_two_ranks(env, monkeypatch, capsys):  # noqa: F811
    """``-num_gpus 2 -device cpu``: two gloo ranks train fold all, both
    report the same losses, the final validation's cases are split over
    the ranks (all five predicted) and rank 0 alone wrote the log,
    debug.json, checkpoints and summary.json."""
    from fast_nnunet_tpu_torch.run.run_training import run_training_entry
    from fast_nnunet_tpu_torch.utils.io import join, load_json
    for k, v in (("FNNT_ITERS_PER_EPOCH", "2"),
                 ("FNNT_VAL_ITERS_PER_EPOCH", "1"),
                 ("FNNT_NUM_EPOCHS", "1"), ("nnUNet_n_proc_DA", "1")):
        monkeypatch.setenv(k, v)
    run_training_entry([DS, "3d_fullres", "all", "-tr",
                        "NNUNetTrainerNoMirroring", "-num_gpus", "2",
                        "-device", "cpu"])
    lines = _rank_lines(capsys.readouterr().out)
    assert sorted(lines) == [0, 1] and lines[0] == lines[1], lines
    out = join(env["results"], DS,
               "NNUNetTrainerNoMirroring__nnUNetPlans__3d_fullres",
               "fold_all")
    files = os.listdir(out)
    assert sum(f.startswith("training_log_") for f in files) == 1, files
    for f in ("checkpoint_final.fnnx", "debug.json"):
        assert f in files
    assert load_json(join(out, "debug.json"))["world_size"] == 2
    summary = load_json(join(out, "validation", "summary.json"))
    assert len(summary["metric_per_case"]) == 5
    preds = [f for f in os.listdir(join(out, "validation"))
             if f.endswith(".nii.gz")]
    assert len(preds) == 5


def test_num_hosts_cli_two_processes(env):  # noqa: F811
    """``-num_hosts 2 -coordinator -process_id``: two processes (one rank
    each) form one world and report the same losses; one checkpoint set
    exists (the JAX contract of tests/test_multihost.py, at tier-1 size)."""
    from fast_nnunet_tpu_torch.utils.io import isfile, join
    coordinator = f"127.0.0.1:{pdist.free_port()}"
    e = dict(os.environ, FNNT_ITERS_PER_EPOCH="2", FNNT_NUM_EPOCHS="1",
             FNNT_VAL_ITERS_PER_EPOCH="1", nnUNet_n_proc_DA="1",
             PYTHONPATH=REPO)
    e["nnUNet_results"] = join(env["results"], "hosts")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fast_nnunet_tpu_torch.run.run_training", DS,
         "3d_fullres", "0", "-num_hosts", "2", "-coordinator", coordinator,
         "-process_id", str(i), "-device", "cpu"], cwd=REPO, env=e,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    lines = {}
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
        lines.update(_rank_lines(out))
    assert sorted(lines) == [0, 1] and lines[0] == lines[1], lines
    fold = join(e["nnUNet_results"], DS,
                "NNUNetTrainer__nnUNetPlans__3d_fullres", "fold_0")
    assert isfile(join(fold, "checkpoint_final.fnnx"))
    assert isfile(join(fold, "validation", "summary.json"))


def test_distillation_through_the_launcher(env, monkeypatch):  # noqa: F811
    """The distillation trainer on two gloo ranks through ``spawn``
    (``distillation_rank``; its CLI has no -num_gpus, as JAX's): both
    ranks report the same losses and rank 0 alone wrote the final
    checkpoint."""
    from fast_nnunet_tpu_torch.run.distillation_train import \
        distillation_rank
    from fast_nnunet_tpu_torch.run.run_training import get_trainer_from_args
    from fast_nnunet_tpu_torch.utils.io import join
    for k, v in (("FNNT_ITERS_PER_EPOCH", "2"),
                 ("FNNT_VAL_ITERS_PER_EPOCH", "1"),
                 ("FNNT_NUM_EPOCHS", "1"), ("nnUNet_n_proc_DA", "1")):
        monkeypatch.setenv(k, v)
    teacher = join(env["results"], "teacher")
    t = get_trainer_from_args(DS, "3d_fullres", 0, device="cpu")
    t.output_folder = join(teacher, "fold_0")
    t.initialize()
    os.makedirs(t.output_folder)
    t.save_checkpoint(join(t.output_folder, "checkpoint_final.fnnx"))
    for f in ("plans.json", "dataset.json"):
        shutil.copy(join(env["preprocessed"], DS,
                         "nnUNetPlans.json" if f == "plans.json" else f),
                    join(teacher, f))
    out = pdist.spawn(distillation_rank, 2, device="cpu", kwargs=dict(
        dataset_name_or_id=DS, teacher_folder=teacher, teacher_folds=[0],
        device="cpu"))
    assert [r["rank"] for r in out] == [0, 1]
    assert out[0]["logging"]["train_losses"] == \
        out[1]["logging"]["train_losses"]
    folder = out[0]["output_folder"]
    files = os.listdir(folder)
    assert "checkpoint_final.fnnx" in files
    assert sum(f.startswith("training_log_") for f in files) == 1


# --------------------------------------------------------------- refusals
def test_num_gpus_above_the_cards_raises(monkeypatch):
    """Under NCCL one rank takes one card: asking for more names both
    numbers; nothing falls back to gloo or the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match=r"-num_gpus 2 .* is 1"):
        pdist.spawn(ranks.train_cases, 2, device="cuda", args=({},))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from fast_nnunet_tpu_torch.run.run_training import run_training
    with pytest.raises(RuntimeError, match="cuda"):
        run_training(DS, "3d_fullres", 0, num_gpus=2)
    with pytest.raises(RuntimeError, match="cuda"):
        pdist.spawn(ranks.train_cases, 1, args=({},))
