"""The port's last utilities against the JAX package's on the CPU: model zips
cross-install both ways and download from ``file://`` and a local HTTP
server (no network), batch-running CSVs byte-equal to JAX's on one results
tree with the command lines naming the port's script, torch.profiler trace
attribution (a synthetic trace and a real CPU trace), the worker-pool
environment shield (cleaned, restored, seen by a spawned worker), the
profiling helpers, and kernel A's dispatcher op (``opcheck``, eager results
equal to the wrapper's)."""
import gzip
import json
import multiprocessing
import os
import threading
import zipfile
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from http.server import HTTPServer, SimpleHTTPRequestHandler

import numpy as np
import pytest
import torch

from fast_nnunet_tpu.utils import batch_running as jbr
from fast_nnunet_tpu.utils import model_sharing as jms
from fast_nnunet_tpu_torch.utils import batch_running as pbr
from fast_nnunet_tpu_torch.utils import model_sharing as pms
from fast_nnunet_tpu_torch.utils.mp_env import cpu_only_child_env
from fast_nnunet_tpu_torch.utils.profiling import (PhaseTimer,
                                                   environment_summary,
                                                   maybe_trace)
from fast_nnunet_tpu_torch.utils.trace_analysis import (attribute_trace,
                                                        format_attribution)

from .torch_port_common import (K, PATCH,  # noqa: F401  (fixture)
                                no_persistent_compile_cache, s2d_pair)

DS = "Dataset977_Share"
FOLDER = "NNUNetTrainer__nnUNetPlans__3d_fullres"


@pytest.fixture()
def env(tmp_path, monkeypatch):
    for d in ("raw", "pre", "res"):
        (tmp_path / d).mkdir()
    monkeypatch.setenv("nnUNet_raw", str(tmp_path / "raw"))
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "pre"))
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "res"))
    return tmp_path


def _trained_tree(res):
    base = res / DS / FOLDER
    for f in (0, 1):
        os.makedirs(base / f"fold_{f}" / "validation")
        (base / f"fold_{f}" / "checkpoint_final.fnnx").write_bytes(
            np.random.RandomState(f).bytes(257))
        (base / f"fold_{f}" / "validation" / "case_0.nii.gz").write_bytes(
            b"seg" * (f + 1))
    (base / "plans.json").write_text('{"plans": 1}')
    (base / "dataset.json").write_text('{"labels": {"background": 0}}')
    return base


def _files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("writer,reader", [(jms, pms), (pms, jms), (pms, pms)],
                         ids=["jax_zip_port_install", "port_zip_jax_install",
                              "port_both"])
def test_model_zip_cross_installs(env, monkeypatch, writer, reader):
    base = _trained_tree(env / "res")
    zip_path = str(env / "model.zip")
    writer.export_pretrained_model(DS, zip_path, folds=(0, 1),
                                   export_crossval_predictions=True)
    fresh = env / "fresh"
    fresh.mkdir()
    monkeypatch.setenv("nnUNet_results", str(fresh))
    reader.install_model_from_zip_file(zip_path)
    assert _files(fresh) == _files(env / "res")
    assert (fresh / DS / FOLDER / "fold_1" / "checkpoint_final.fnnx"
            ).read_bytes() == (base / "fold_1" / "checkpoint_final.fnnx"
                               ).read_bytes()


def test_port_zip_equals_jax_zip_entries(env):
    _trained_tree(env / "res")
    for m, name in ((jms, "j.zip"), (pms, "p.zip")):
        m.export_pretrained_model(DS, str(env / name), folds=(0, 1))
    with zipfile.ZipFile(env / "j.zip") as a, zipfile.ZipFile(env / "p.zip") as b:
        assert sorted(a.namelist()) == sorted(b.namelist())
        for n in a.namelist():
            assert a.read(n) == b.read(n), n


def test_model_zip_strict_and_cli(env, monkeypatch):
    _trained_tree(env / "res")
    with pytest.raises(RuntimeError, match="fold 2"):
        pms.export_pretrained_model(DS, str(env / "x.zip"), folds=(0, 2))
    pms.export_entry([DS, "-o", str(env / "cli.zip"), "-f", "0", "1"])
    fresh = env / "fresh"
    fresh.mkdir()
    monkeypatch.setenv("nnUNet_results", str(fresh))
    pms.install_entry([str(env / "cli.zip")])
    assert (fresh / DS / FOLDER / "fold_0" / "checkpoint_final.fnnx").is_file()


def test_download_from_file_url_and_local_http(env, monkeypatch):
    _trained_tree(env / "res")
    src = env / "srv"
    src.mkdir()
    pms.export_pretrained_model(DS, str(src / "model.zip"), folds=(0,))
    for i, url in enumerate([(src / "model.zip").as_uri(), None]):
        dst = env / f"dl{i}"
        dst.mkdir()
        monkeypatch.setenv("nnUNet_results", str(dst))
        if url is None:
            httpd = HTTPServer(("127.0.0.1", 0),
                               partial(SimpleHTTPRequestHandler,
                                       directory=str(src)))
            t = threading.Thread(target=httpd.serve_forever, daemon=True)
            t.start()
            try:
                pms.download_entry(
                    [f"http://127.0.0.1:{httpd.server_address[1]}/model.zip"])
            finally:
                httpd.shutdown()
        else:
            pms.download_and_install_from_url(url)
        assert (dst / DS / FOLDER / "fold_0" / "checkpoint_final.fnnx"
                ).read_bytes() == (env / "res" / DS / FOLDER / "fold_0" /
                                   "checkpoint_final.fnnx").read_bytes()


def _summary(folder, dice):
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "summary.json"), "w") as f:
        json.dump({"foreground_mean": {"Dice": dice}}, f)


def _results_tree(res):
    for ds, cfgs in (("Dataset901_A", ("3d_fullres", "2d")),
                     ("Dataset902_B", ("3d_fullres",))):
        for c in cfgs:
            for tr in ("NNUNetTrainer", "NNUNetTrainerDA5"):
                base = res / ds / f"{tr}__nnUNetPlans__{c}"
                for f, dice in ((0, 0.8123456), (1, 0.9), (2, 0.75)):
                    if (tr, f) == ("NNUNetTrainerDA5", 2):
                        continue  # a missing fold: nan cells
                    _summary(str(base / f"fold_{f}" / "validation"),
                             dice - 0.01 * len(c))
    bench = res / "Dataset902_B" / \
        "NNUNetTrainerBenchmark_5epochs__nnUNetPlans__3d_fullres" / "fold_0"
    os.makedirs(bench)
    with open(bench / "benchmark_result.json", "w") as f:
        json.dump({"host__NVIDIA H100 80GB HBM3": {"fastest_epoch": 12.345},
                   "host__cpu": {"fastest_epoch": None}}, f)


def test_batch_running_csvs_byte_equal_to_jax(env, capsys):
    _results_tree(env / "res")
    ds = ["Dataset901_A", "Dataset902_B"]
    trainers = {"NNUNetTrainer": ("nnUNetPlans",),
                "NNUNetTrainerDA5": ("nnUNetPlans",)}
    outs = {}
    for name, m in (("jax", jbr), ("port", pbr)):
        d = env / name
        d.mkdir()
        m.collect_results(ds, str(d / "long.csv"),
                          configurations=("3d_fullres", "2d"),
                          folds=(0, 1, 2),
                          trainers=tuple(trainers))
        m.collect_results_wide(trainers, ds, str(d / "wide.csv"),
                               folds=(0, 1, 2))
        m.summarize_wide(str(d / "wide.csv"), str(d / "summary.csv"),
                         folds=(0, 1, 2), configs=("3d_fullres", "2d"),
                         datasets=ds, trainers=trainers)
        m.benchmark_results_csv(ds, str(d / "bench.csv"),
                                configurations=("3d_fullres",))
        outs[name] = {f: (d / f).read_bytes()
                      for f in ("long.csv", "wide.csv", "summary.csv",
                                "bench.csv")}
        outs[name + "_entries"] = m.summarize_benchmark_results(
            ds, configurations=("3d_fullres",))
    assert outs["port"] == outs["jax"]
    assert outs["port_entries"] == outs["jax_entries"]
    assert b"nan" in outs["port"]["summary.csv"]
    assert b"12.35" in outs["port"]["bench.csv"] and \
        b"MISSING" in outs["port"]["bench.csv"]


def test_batch_running_commands_name_the_port_script():
    kw = dict(configurations=("2d", "3d_fullres"), folds=(0, 1),
              trainers=("NNUNetTrainer", "NNUNetTrainerDA5"),
              command_prefix="sbatch", num_gpus=2)
    got = pbr.generate_training_commands([5, 7], **kw)
    want = jbr.generate_training_commands([5, 7], **kw)
    assert got == [w.replace("nnUNetv2_train", "fast_nnunet_train_torch")
                   for w in want]
    assert got[0] == ("sbatch fast_nnunet_train_torch 5 2d 0 -tr "
                      "NNUNetTrainer -p nnUNetPlans -num_gpus 2")
    b = pbr.generate_benchmark_commands([2], configurations=("2d",))
    assert b == [w.replace("nnUNetv2_train", "fast_nnunet_train_torch")
                 for w in jbr.generate_benchmark_commands(
                     [2], configurations=("2d",))]
    assert all(" -num_gpus" not in c for c in b)


def test_trace_attribution_synthetic(tmp_path):
    """JAX's synthetic-trace test in torch.profiler's event shape: device
    leaves are kernel / gpu_memcpy / gpu_memset events (any pid / tid),
    host events do not count, the four hand kernels get their own
    buckets, and the idle share is 1 - union of the busy intervals over
    the device window."""
    ev = lambda cat, name, ts, dur, pid=0, tid=7: {  # noqa: E731
        "ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
        "pid": pid, "tid": tid}
    events = [
        ev("cpu_op", "aten::conv3d", 0, 50_000_000, pid=123),
        ev("cuda_runtime", "cudaLaunchKernel", 0, 10, pid=123),
        ev("kernel", "sm90_xmma_fprop_implicit_gemm_bf16bf16", 0, 2_000_000),
        ev("kernel", "void spatial_sum_sumsq_kernel<__nv_bfloat16>(...)",
           2_000_000, 250_000),
        ev("kernel", "void grouped_argmax_kernel<__nv_bfloat16>(...)",
           2_250_000, 250_000),
        ev("kernel", "void s2d_accumulate_kernel<16, ...>(...)",
           2_500_000, 500_000),
        ev("kernel", "void scatter_accumulate_kernel<float>(...)",
           3_000_000, 500_000, tid=8),
        ev("kernel", "void at::native::vectorized_elementwise_kernel<4>(...)",
           3_000_000, 250_000),   # overlaps D on another stream
        ev("kernel", "void at::native::reduce_kernel<512, 1>(...)",
           3_500_000, 125_000),
        ev("kernel", "void cudnn::ops::nchwToNhwcKernel<...>(...)",
           3_625_000, 125_000),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 5_000_000,
           1_000_000),
    ]
    d = tmp_path / "trace"
    d.mkdir()
    with gzip.open(d / "host_1.123.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    att = attribute_trace(str(tmp_path))
    b = dict(att["buckets"])
    assert abs(att["total_s"] - 5.0) < 1e-9
    assert b["convolution(cuDNN/cuBLAS)"] == 2.0
    assert b["A spatial_sum_sumsq"] == b["B grouped_argmax"] == 0.25
    assert b["C s2d_accumulate"] == b["D scatter_accumulate"] == 0.5
    assert b["elementwise"] == 0.25 and b["reduction"] == 0.125
    assert b["copy/transpose"] == 0.125 and b["memcpy/memset"] == 1.0
    assert att["launches"]["A spatial_sum_sumsq"] == 1
    assert abs(att["window_s"] - 6.0) < 1e-9
    assert abs(att["busy_s"] - 4.75) < 1e-9      # the gap 3.75-5.0 idle
    assert abs(att["idle_share"] - (1 - 4.75 / 6.0)) < 1e-9
    txt = format_attribution(att)
    assert "device leaf total: 5.0000 s" in txt and "x1" in txt


def test_trace_of_a_cpu_forward(tmp_path):
    """A real torch.profiler trace written by ``maybe_trace`` on the CPU:
    the file is found and parsed; a CPU run has no device events, so the
    attribution is empty, not invented."""
    _, net, _ = s2d_pair(seed=0)
    x = torch.randn(2, 1, *PATCH)
    with maybe_trace(str(tmp_path / "t")) as prof, torch.no_grad():
        assert prof is not None
        net(x)
    files = [f for f in os.listdir(tmp_path / "t")
             if f.endswith(".pt.trace.json.gz")]
    assert len(files) == 1
    with gzip.open(tmp_path / "t" / files[0], "rt") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    att = attribute_trace(str(tmp_path / "t"))
    assert att["total_s"] == 0.0 and att["idle_share"] is None
    with maybe_trace(None) as prof:
        assert prof is None       # FNNT_PROFILE_DIR unset: a no-op


def test_maybe_trace_reads_fnnt_profile_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("FNNT_PROFILE_DIR", str(tmp_path / "env"))
    with maybe_trace() as prof:
        torch.ones(4).sum()
    assert prof is not None
    assert any(f.endswith(".pt.trace.json.gz")
               for f in os.listdir(tmp_path / "env"))


def test_phase_timer_and_environment_summary(monkeypatch):
    from fast_nnunet_tpu.utils.profiling import PhaseTimer as JaxTimer
    t, j = PhaseTimer(), JaxTimer()
    for timer in (t, j):
        for name in ("fwd", "fwd", "bwd"):
            with timer.phase(name):
                pass
    assert set(t.summary()) == set(j.summary()) == {"fwd", "bwd"}
    assert t.summary()["fwd"]["count"] == 2
    assert "x2" in t.report() and "fwd" in t.report()
    monkeypatch.setenv("FNN_AOT_CACHE", "/somewhere")
    info = environment_summary("cpu")
    assert info["torch"] == torch.__version__ and info["device"] == "cpu"
    assert info["env"]["FNN_AOT_CACHE"] == "/somewhere"
    assert "gpu_name" not in info
    for k in ("hostname", "python", "platform", "cpu_count", "cuda"):
        assert k in info


def _child_env():
    return {k: os.environ.get(k) for k in ("CUDA_VISIBLE_DEVICES",
                                           "JAX_PLATFORMS")}


def test_cpu_only_child_env_cleans_and_restores(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    before = dict(os.environ)
    ctx = multiprocessing.get_context("spawn")
    with cpu_only_child_env():
        assert os.environ["CUDA_VISIBLE_DEVICES"] == ""
        assert os.environ["JAX_PLATFORMS"] == "cpu"
        with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as ex:
            seen = ex.submit(_child_env).result()
    assert seen == {"CUDA_VISIBLE_DEVICES": "", "JAX_PLATFORMS": "cpu"}
    assert dict(os.environ) == before
    with pytest.raises(KeyError):
        with cpu_only_child_env():
            raise KeyError("restored on error too")
    assert dict(os.environ) == before


def _norm_args(op, shape, dt, seed):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(*shape)).to(dt)
    if op == "s2d_instance_norm":
        c = shape[1] // 8
        return (x, torch.tensor(rng.rand(c) + 0.5, dtype=torch.float32),
                torch.tensor(rng.randn(c), dtype=torch.float32), 1e-5, 8, 0)
    c = shape[1]
    return (x, torch.tensor(rng.rand(c) + 0.5, dtype=torch.float32),
            torch.tensor(rng.randn(c), dtype=torch.float32), 1e-5)


@pytest.mark.parametrize("op", ["s2d_instance_norm", "instance_norm"])
@pytest.mark.parametrize("shape,dt", [((2, 16, 8, 4, 4), torch.float32),
                                      ((1, 8, 6, 8, 4), torch.bfloat16)])
def test_norm_ops_opcheck_and_eager_results(op, shape, dt):
    """The norms' dispatcher ops pass ``opcheck`` (schema, fake, dispatch)
    and return the eager functions' values bit for bit."""
    from fast_nnunet_tpu_torch.models import blocks, s2d
    args = _norm_args(op, shape, dt, seed=5)
    fn = {"s2d_instance_norm": (s2d.instance_norm_op, s2d.instance_norm),
          "instance_norm": (blocks.instance_norm_op, blocks.instance_norm)}
    op_fn, eager = fn[op]
    torch.library.opcheck(op_fn, args)
    got = getattr(torch.ops.fnn_torch, op)(*args)
    want = eager(*args)
    assert got.dtype == want.dtype == dt and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("shape,dt", [((2, 16, 8, 4, 4), torch.float32),
                                      ((1, 8, 6, 8, 4), torch.bfloat16)])
def test_s2d_norm_op_with_conv_bias_opcheck_and_eager_results(shape, dt):
    """``fnn_torch::s2d_instance_norm`` with a conv bias (the one an s2d
    block's traced forward passes it) passes ``opcheck`` and returns the
    eager norm's values bit for bit."""
    from fast_nnunet_tpu_torch.models import s2d
    args = _norm_args("s2d_instance_norm", shape, dt, seed=7)
    cb = torch.tensor(np.random.RandomState(8).randn(shape[1]),
                      dtype=torch.float32)
    torch.library.opcheck(s2d.instance_norm_op, args + (cb,))
    got = torch.ops.fnn_torch.s2d_instance_norm(*args, cb)
    want = s2d.instance_norm(*args, conv_bias=cb)
    assert got.dtype == want.dtype == dt
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, s2d.instance_norm(*args))


def test_s2d_norm_takes_kernel_a_eagerly_and_its_op_when_traced(
        monkeypatch):
    """The s2d InstanceNorm calls kernel A's wrapper in eager (values as
    the float64 formula's); a block traced by torch.export records the norm
    as ``fnn_torch.s2d_instance_norm`` (kernel A inside it, no reduction of
    Inductor's in its place) and runs kernel A once when called."""
    from fast_nnunet_tpu_torch.models import s2d
    calls = []
    real = s2d.spatial_sum_sumsq
    monkeypatch.setattr(s2d, "spatial_sum_sumsq",
                        lambda x: calls.append(tuple(x.shape)) or real(x))
    x = torch.tensor(np.random.RandomState(6).randn(2, 16, 16, 16, 16),
                     dtype=torch.float32)
    scale = torch.ones(2)
    bias = torch.zeros(2)
    y = s2d.instance_norm(x, scale, bias, 1e-5, groups=8)
    assert calls == [(2, 16, 16, 16, 16)]
    xr = x.reshape(2, 8, 2, -1).permute(0, 2, 1, 3).reshape(2, 2, -1).double()
    mean = xr.mean(-1)
    var = xr.var(-1, unbiased=False)
    want = (x.double().reshape(2, 8, 2, -1)
            - mean.reshape(2, 1, 2, 1)) / torch.sqrt(
                var.reshape(2, 1, 2, 1) + 1e-5)
    torch.testing.assert_close(y.double(), want.reshape(x.shape), rtol=1e-4,
                               atol=1e-4)
    blk = s2d._Block(16, 16, (3, 3, 3), (1, 1, 1), (1, 1, 1), groups=8,
                     eps=1e-5, slope=0.01).eval()
    ep = torch.export.export(blk, (x,))
    code = ep.graph_module.code
    assert "fnn_torch.s2d_instance_norm" in code
    assert "var_mean" not in code and "aten.sum" not in code
    del calls[:]
    with torch.no_grad():
        torch.testing.assert_close(ep.module()(x), blk(x), rtol=0, atol=0)
    assert len(calls) == 2  # the traced block's op, then the eager block


def test_plain_norm_is_its_op_when_traced():
    """A plain network's block traced by torch.export records its norm as
    ``fnn_torch.instance_norm`` (the op the native engine registers in
    C++) and gives the eager block's values bit for bit; eager and the
    training form do not go through the op."""
    from fast_nnunet_tpu_torch.models import blocks
    x = torch.tensor(np.random.RandomState(7).randn(2, 3, 8, 6, 4),
                     dtype=torch.float32)
    blk = blocks.ConvDropoutNormReLU(3, 4, (3, 3, 3), (1, 1, 1)).eval()
    ep = torch.export.export(blk, (x,))
    code = ep.graph_module.code
    assert "fnn_torch.instance_norm" in code and "var_mean" not in code
    with torch.no_grad():
        torch.testing.assert_close(ep.module()(x), blk(x), rtol=0, atol=0)
    onepass = blocks.InstanceNorm(3, onepass=True)
    assert "fnn_torch" not in torch.export.export(onepass, (x,)) \
        .graph_module.code
