"""primus_m.train at a size a CPU test holds: its files load and agree with
the trainer it names; the work counted from the shapes equals the counts
worked out by hand; its readers read synthetic phases and traces (and
nothing where a program lacks the spans); its runner's ``readings`` runs
every mode, the program's passing the cell's tiny limits and each control
failing one; a sound run comes out correct and a run with the timed path
broken underneath comes out not correct."""
import time
from unittest import mock

import pytest
import torch

import fast_nnunet_tpu_torch.training.optimizers as optimizers
import fast_nnunet_tpu_torch.training.train_step as train_step
from benchmark import control, kernels
from benchmark.harness import cli, common, grid, primus_train, trace
from benchmark.tests import tiny_primus as tiny

CPU = torch.device("cpu")
SPEC = common.benchmark_spec()
CELL = "primus_m.train"


def test_cell_names_the_trainer_and_widths():
    from fast_nnunet_tpu_torch.models.primus import swiglu_hidden
    from fast_nnunet_tpu_torch.run.run_training import find_trainer_class
    files = common.cell_files(SPEC, CELL)
    cfg, net = files["config"], files["config"]["network"]
    cls = find_trainer_class(cfg["trainer"])
    assert (cls.embed_dim, cls.depth, cls.num_heads) == (
        net["embed_dim"], net["depth"], net["num_heads"]) == (864, 16, 12)
    assert list(cls.patch_embed_size) == net["patch_embed_size"]
    assert net["head_dim"] == net["embed_dim"] // net["num_heads"] == 72
    assert net["mlp_hidden"] == swiglu_hidden(net["embed_dim"]) == 2304
    assert cfg["training"]["patch_size"] == [160, 160, 160]
    assert primus_train.tokens(cfg) == 8000
    assert primus_train.store_config(cfg)["name"] == cfg["store_config"]
    assert control.readings("primus_train") is primus_train.readings
    assert files["traffic"]["host_threads"]["loader"] == 12


def test_work_counted_by_hand():
    """Per patch: the patch embedding 2 x 8000 x 864 x 512 = 7,077,888,000;
    a block's linears 2 x 8000 x 864 x (4 x 864 + 3 x 2304) =
    143,327,232,000 and its attention 4 x 12 x 8000^2 x 72 =
    221,184,000,000 (16 blocks: 5,832,179,712,000); the transposed convs
    47,775,744,000 + 95,551,488,000 + 191,102,976,000 and the seg head
    2 x 160^3 x 108 x 61 = 53,968,896,000: 6,227,656,704,000, x 2 patches.
    F: 16 launches of 4 x 2 x 12 x 8000^2 x 72 = 442,368,000,000; G: 32
    launches doing 16 x 2.5 times that."""
    cfg = common.cell_files(SPEC, CELL)["config"]
    assert primus_train.forward_flops(cfg) == 2 * 6_227_656_704_000
    assert primus_train.attention_flops(cfg) == 442_368_000_000
    w = primus_train.step_work(cfg)
    assert w["flops"] == 3 * 12_455_313_408_000
    assert w["F"] == (16, 7_077_888_000_000)
    assert w["G"] == (32, 17_694_720_000_000)


def test_kernel_files_f_and_g():
    reg = kernels.registry()
    assert reg["F"] == ("attention_fwd_kernel", "bf16")
    assert reg["G"] == ("attention_bwd_", "bf16")


F_SYM = ("void (anonymous namespace)::attention_fwd_kernel<8, 64>("
         "(anonymous namespace)::Args)")
G_SYMS = ("void (anonymous namespace)::attention_bwd_dq_kernel<4, 64>("
          "(anonymous namespace)::Args)",
          "void (anonymous namespace)::attention_bwd_dkdv_kernel<4, 64>("
          "(anonymous namespace)::Args)")


def _trace(n_f, n_g, dur_f=2000.0, dur_g=3000.0):
    ev = [{"ph": "X", "cat": "kernel", "name": F_SYM, "ts": 1e4 * i,
           "dur": dur_f} for i in range(n_f)]
    ev += [{"ph": "X", "cat": "kernel", "name": G_SYMS[i % 2],
            "ts": 1e6 + 1e4 * i, "dur": dur_g} for i in range(n_g)]
    return trace.read({"traceEvents": ev})


def test_rooflines_of_f_and_g():
    # 16 F launches of 2 ms doing 442.368 GFLOP each: 22.36% of 989 TFLOP/s;
    # 32 G passes of 3 ms doing 16 x 1105.92 GFLOP: 18.64%
    cfg = common.cell_files(SPEC, CELL)["config"]
    w = primus_train.step_work(cfg)
    run = {"trace": _trace(16, 32), "work": {"F": w["F"], "G": w["G"]}}
    assert run["trace"]["kernels"]["G"] == (pytest.approx(0.096), 32)
    assert common.metric_reader("roofline.F.primus")(run) == pytest.approx(
        100 * 442.368e9 / 989e12 / 2e-3)
    assert common.metric_reader("roofline.G.primus")(run) == pytest.approx(
        100 * 16 * 1105.92e9 / 989e12 / 0.096)
    # a pass missing from the trace: the count no longer describes the work
    run["trace"] = _trace(16, 31)
    assert common.metric_reader("roofline.G.primus")(run) is None
    assert grid.roofline_percent({"work": w}, "F") is None


@pytest.mark.parametrize("phases,att_ms,fused", [
    ({"attention": 40.0, "attention_backward": 120.0,
      "count:attn_calls": 64, "count:attn_fused": 64}, 40.0, 100.0),
    ({"attention": 40.0, "count:attn_calls": 64, "count:attn_fused": 32},
     10.0, 50.0),
    # a float32 network: calls counted, none fused
    ({"attention": 40.0, "count:attn_calls": 64}, 10.0, 0.0),
    # a program without the attention's spans and counters
    ({"forward_loss": 100.0, "backward": 200.0}, None, None),
])
def test_attention_readers(phases, att_ms, fused):
    run = {"n": 4, "phases_ms": phases}
    got = common.metric_reader("primus.attention_ms")(run)
    assert got == (None if att_ms is None else pytest.approx(att_ms))
    got = common.metric_reader("primus.attn_fused")(run)
    assert got == (None if fused is None else pytest.approx(fused))
    assert common.metric_reader("primus.attn_fused")({"n": 4}) is None


def test_mfu_reads_the_runners_flops():
    run = {"flops": 3 * 37_365_940_224_000, "window_s": 1.0}
    assert common.metric_reader("mfu.primus")(run) == pytest.approx(
        100 * 3 * 37.365940224e12 / 989e12)


# ------------------------------------------------------ runs at a CPU size
@pytest.fixture
def files(monkeypatch):
    tiny.register_tiny_primus(monkeypatch)
    return tiny.primus_files()


def correct(files, seconds=0.5, seed=31):
    out = cli.measure(files, seed, seconds, False, CPU, time.perf_counter())
    return common.passed(out["checks"])


def test_primus_sound_run_is_correct(files):
    assert correct(files, seconds=1.0)


def _half_loss(network, loss_fn, weights, data, targets):
    n = data.shape[0] // 2
    return _forward_loss(network, loss_fn, weights, data[:n],
                         [t[:n] for t in targets])


def _altered_loss(*a, **k):
    out, loss = _forward_loss(*a, **k)
    return out, loss * 1.05


_forward_loss = train_step.forward_loss
FAULTS = {
    "state_unchanged": lambda: mock.patch.object(
        optimizers.ChainedOptimizer, "step", lambda self: None),
    "half_batch": lambda: mock.patch.object(train_step, "forward_loss",
                                            _half_loss),
    "answer_altered": lambda: mock.patch.object(train_step, "forward_loss",
                                                _altered_loss),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_primus_fault_is_not_correct(files, fault):
    with FAULTS[fault]():
        assert not correct(files)


@pytest.mark.parametrize("mode", ["program", "control", "half_batch",
                                  "unchanged"])
def test_primus_readings_every_mode(files, mode):
    r = control.readings("primus_train")(files, 33, mode, CPU)
    ok = common.passed(common.checks_of(r, files["limits"]))
    assert ok == (mode == "program"), r
