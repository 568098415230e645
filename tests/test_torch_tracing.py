"""The port's one tracer (utils/profiling.py ``PhaseTimer`` and ``phase``)
on the CPU: host times summed per name, the host and count totals, the off path, the phases in a torch.profiler trace, and the
counters where the work happens (the s2d sweep's tiles, the masks' copies
to the host, the training loader's queue)."""
import gzip
import json
import threading
import types

import numpy as np
import pytest
import torch

from fast_nnunet_tpu_torch.inference import engine as engine_module
from fast_nnunet_tpu_torch.inference.engine import SlidingWindowEngine
from fast_nnunet_tpu_torch.inference.turbo import (TurboConfig, TurboPipeline,
                                                   pack_mask6)
from fast_nnunet_tpu_torch.models.factory import get_network_from_plans
from fast_nnunet_tpu_torch.models.s2d import make_s2d_engine_net
from fast_nnunet_tpu_torch.training.dataloader import AsyncBatchIterator
from fast_nnunet_tpu_torch.training.trainer import NNUNetTrainer
from fast_nnunet_tpu_torch.utils import profiling
from fast_nnunet_tpu_torch.utils.profiling import PhaseTimer, phase

from .torch_port_common import ARCH, K, PATCH, plain_params

CFG = dict(patch_size=(16, 8, 8), target_spacing=(1.0, 1.0, 1.0),
           mean=40.0, std=100.0, lower_bound=-60.0, upper_bound=400.0,
           num_classes=K)


@pytest.fixture(scope="module")
def served():
    """A tiny s2d engine on the CPU and its weights."""
    net = make_s2d_engine_net(ARCH, K, 1, compute_dtype=torch.float32)
    tree = net.convert_params(plain_params(0))
    eng = SlidingWindowEngine(net, PATCH, K, shape_bucket=4,
                              compute_dtype=torch.float32,
                              sweep_acc_dtype=torch.float32, tile_batch=2,
                              device="cpu")
    return eng, tree


@pytest.fixture
def timed(served):
    """The engine with a fresh timer, removed after the test."""
    eng, tree = served
    eng.timer = PhaseTimer()
    try:
        yield eng, tree, eng.timer
    finally:
        eng.timer = None


def _air_ct():
    # a body in one corner: far tile batches are all air
    vol = np.full((44, 40, 36), -1000.0, np.float32)
    vol[2:14, 2:14, 2:14] = 300.0 + np.random.RandomState(7).rand(
        12, 12, 12) * 100
    return vol, (1.0, 1.0, 1.0)


def _clock(monkeypatch, ms):
    """The tracer's host clock reads ``ms`` (milliseconds), in turn."""
    ticks = iter(int(m * 1e6) for m in ms)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: next(ticks)))


def test_nested_phases_sum_host_time_per_name(monkeypatch):
    _clock(monkeypatch, [0, 1, 2, 5, 6, 10, 14, 20])
    t = PhaseTimer()
    with t.phase("a"):
        with t.phase("b"):
            with t.phase("c"):
                pass
        with t.phase("b"):
            pass
    assert t.host == {"a": [20.0, 1], "b": [9.0, 2], "c": [3.0, 1]}


def test_host_and_count_totals(monkeypatch):
    _clock(monkeypatch, [0, 1.5, 2, 2.25, 3, 7])
    t = PhaseTimer()
    for _ in range(3):
        with t.phase("x"):
            pass
    t.count("n", 4)
    t.count("n", 2)
    tot = t.totals()
    assert tot == {"host:x": 5.75, "count:n": 6}   # no device keys on the CPU


def test_summary_and_report_read_the_host_totals():
    t = PhaseTimer()
    for name in ("fwd", "fwd", "bwd"):
        with t.phase(name):
            pass
    s = t.summary()
    assert set(s) == {"fwd", "bwd"} and s["fwd"]["count"] == 2
    assert s["fwd"]["total_s"] == pytest.approx(
        t.totals()["host:fwd"] / 1e3, abs=1e-4)
    assert "x2" in t.report()


def test_a_phase_that_raises_still_counts(monkeypatch):
    _clock(monkeypatch, [0, 1, 4, 6, 10, 11])
    t = PhaseTimer()
    with pytest.raises(ValueError):
        with t.phase("outer"):
            with t.phase("inner"):
                raise ValueError("boom")
    with t.phase("next"):
        pass
    assert t.host == {"outer": [6.0, 1], "inner": [3.0, 1],
                      "next": [1.0, 1]}


def test_off_path_is_a_shared_null_context(served):
    eng, tree = served
    assert eng.timer is None
    assert phase(None, "x") is phase(None, "y") is profiling._NULL
    assert eng.phase("forward") is profiling._NULL
    # a timer taken off sees nothing more
    t = eng.timer = PhaseTimer()
    TurboPipeline(eng, TurboConfig(**CFG)).predict_volume(tree, *_air_ct())
    eng.timer = None
    before = t.totals()
    TurboPipeline(eng, TurboConfig(**CFG), air_skip=True).predict_volume(
        tree, *_air_ct())
    assert t.totals() == before


def _annotations(tmp_path, run):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def test_phases_annotate_the_profiler_trace_without_a_timer(served,
                                                            tmp_path):
    eng, tree = served
    pipe = TurboPipeline(eng, TurboConfig(**CFG), air_skip=True)
    names = _annotations(tmp_path,
                         lambda: pipe.predict_volume(tree, *_air_ct()))
    assert names.count("predict_volume") == 1
    for name in ("upload", "preprocess", "forward", "accumulate",
                 "finalize", "revert", "d2h"):
        assert name in names, name
    assert profiling.phase(None, "x") is profiling._NULL   # off again


def test_a_timer_records_beside_the_profiler(timed, tmp_path):
    eng, tree, t = timed
    pipe = TurboPipeline(eng, TurboConfig(**CFG))
    names = _annotations(tmp_path,
                         lambda: pipe.predict_volume(tree, *_air_ct()))
    assert t.host["predict_volume"][1] == names.count("predict_volume") == 1
    assert t.host["forward"][1] == names.count("forward") > 0


def test_predict_volume_holds_each_ct_phases(timed):
    eng, tree, t = timed
    pipe = TurboPipeline(eng, TurboConfig(**CFG))
    for _ in range(2):
        pipe.predict_volume(tree, *_air_ct())
    assert t.host["predict_volume"][1] == 2
    assert t.host["d2h"][1] == 2
    inner = sum(ms for name, (ms, _) in t.host.items()
                if name != "predict_volume")
    assert inner <= t.host["predict_volume"][0]


def _air_flags(pipe, vol, spacing):
    """The per-chunk batch flags the pipeline's sweep takes, and B."""
    with torch.no_grad():
        _, _, _, valid = pipe.preprocess(vol[None], spacing)
    return valid, pipe.engine.tile_batch


def test_tile_counters_with_air_skipping(timed):
    eng, tree, t = timed
    pipe = TurboPipeline(eng, TurboConfig(**CFG), air_skip=True)
    vol, spacing = _air_ct()
    valid, B = _air_flags(pipe, vol, spacing)
    live = valid.any(axis=2)
    assert 0 < live.sum() < live.size          # both kinds of batch
    t.counters.clear()
    pipe.predict_volume(tree, vol, spacing)
    tot = t.totals()
    assert tot["count:tiles_kept"] == int(valid.sum())
    assert tot["count:tiles_forwarded"] == B * int(live.sum())
    assert t.host["forward"][1] == int(live.sum())   # no air batch runs


def test_tile_counters_without_air_skipping(timed):
    eng, tree, t = timed
    pipe = TurboPipeline(eng, TurboConfig(**CFG))
    vol, spacing = _air_ct()
    pipe.predict_volume(tree, vol, spacing)
    in_shape, new_shape = pipe._geometry(vol[None], spacing)
    _, steps = eng.s2d_sweep_plan(new_shape)
    starts_x, coords_b, valid_b = eng.sweep_tiles(steps)
    n = len(starts_x)
    tot = t.totals()
    assert tot["count:tiles_kept"] == n * int(valid_b.sum())
    assert tot["count:tiles_forwarded"] == n * coords_b.shape[0] * \
        coords_b.shape[1]


def test_norm_counters_count_every_block_of_every_forward(timed):
    """``norms`` is the network's blocks times its forwards; on the CPU no
    norm launches kernel E, so ``norms_fused`` stays 0 (on the card it
    equals ``norms``: tests/test_torch_kernels_cuda.py)."""
    eng, tree, t = timed
    pipe = TurboPipeline(eng, TurboConfig(**CFG), air_skip=True)
    pipe.predict_volume(tree, *_air_ct())
    tot = t.totals()
    blocks = eng.network.norm_count()
    assert blocks == sum(ARCH["n_conv_per_stage"]) + \
        sum(ARCH["n_conv_per_stage_decoder"])
    assert tot["count:norms"] == blocks * t.host["forward"][1] > 0
    assert tot.get("count:norms_fused", 0) == 0


def test_conv_bias_folded_counts_every_forward(timed):
    """``conv_bias_folded`` (kernel E's launches that took a block's conv
    bias) is counted in every forward, 0 on the CPU where no norm launches
    the kernel (on the card it equals ``norms``:
    tests/test_torch_kernels_cuda.py), so its reader always finds it."""
    eng, tree, t = timed
    pipe = TurboPipeline(eng, TurboConfig(**CFG), air_skip=True)
    pipe.predict_volume(tree, *_air_ct())
    tot = t.totals()
    assert tot["count:conv_bias_folded"] == 0 < tot["count:norms"]


def test_mask_bytes_count_as_pageable_on_the_device_route(timed):
    eng, tree, t = timed
    mask = TurboPipeline(eng, TurboConfig(**CFG)).predict_volume(
        tree, *_air_ct())
    tot = t.totals()
    assert tot["count:d2h_pageable_bytes"] == mask.nbytes
    assert "count:d2h_pinned_bytes" not in tot


def test_mask_bytes_count_as_pinned_with_the_host_revert(timed):
    eng, tree, t = timed
    pipe = TurboPipeline(eng, TurboConfig(**CFG), host_revert=True)
    vol, spacing = _air_ct()
    mask = pipe.predict_volume(tree, vol, spacing)
    _, new_shape = pipe._geometry(vol[None], spacing)
    packed = pack_mask6(torch.zeros(new_shape, dtype=torch.uint8))
    tot = t.totals()
    assert tot["count:d2h_pinned_bytes"] == packed.nbytes
    assert packed.nbytes < mask.nbytes           # 6 bits of the 8
    assert "count:d2h_pageable_bytes" not in tot
    assert "host:host_revert" in tot


def _plain_engine():
    net = get_network_from_plans("PlainConvUNet", ARCH, (), 1, K,
                                 compute_dtype=torch.float32)
    return SlidingWindowEngine(net, PATCH, K, compute_dtype=torch.float32,
                               acc_dtype=torch.float32,
                               sweep_acc_dtype=torch.float32, device="cpu",
                               shape_bucket=16, tile_batch=2)


def test_plain_logits_count_as_pageable():
    eng = _plain_engine()
    eng.timer = t = PhaseTimer()
    vol = np.random.RandomState(3).randn(1, 21, 13, 18).astype(np.float32)
    logits = eng.predict_logits(plain_params(0), vol)
    assert t.counters == {"d2h_pageable_bytes": logits.nbytes}
    assert t.host["d2h"][1] == 1


def test_streamed_host_route_rows_count_as_pinned(timed, monkeypatch):
    """The streamed host route copies each chunk's packed rows out as the
    chunk ends: every piece is counted, inside a d2h phase."""
    put = engine_module.RowFetcher.put
    pieces = []

    def spy(self, rows):
        pieces.append(rows.nbytes)
        put(self, rows)
    monkeypatch.setattr(engine_module.RowFetcher, "put", spy)
    monkeypatch.setenv("FNN_TURBO_STREAM", "1")
    eng, tree, t = timed
    pipe = TurboPipeline(eng, TurboConfig(**CFG), host_preprocess=True)
    vol, spacing = _air_ct()
    mask = pipe.predict_volume(tree, vol.astype(np.int16), spacing)
    assert pipe.route == "streamed"
    assert len(pieces) == t.host["d2h"][1] > 1
    assert t.counters["d2h_pinned_bytes"] == sum(pieces)
    assert "d2h_pageable_bytes" not in t.counters
    assert sum(pieces) < mask.nbytes  # 6 bits of the 8


class _Sampler:
    """Batches as fast as the loader asks, after a short wait."""

    def __init__(self):
        self.event = threading.Event()

    def generate_batch(self, rng):
        self.event.wait(0.002)
        return {"data": np.zeros(2, np.float32)}


def test_loader_ready_stays_within_the_queue():
    prefetch = 3
    loader = AsyncBatchIterator(_Sampler(), num_workers=2,
                                prefetch=prefetch)
    t = PhaseTimer()
    stub = types.SimpleNamespace(timer=t, batch_to_device=lambda b: b)
    readies = []
    try:
        for _ in range(6):
            n0 = t.counters["loader_ready"]
            NNUNetTrainer.next_batch(stub, loader)
            readies.append(t.counters["loader_ready"] - n0)
    finally:
        loader.shutdown()
    assert all(0 <= r <= prefetch for r in readies)
    assert t.host["data"][1] == t.host["h2d"][1] == 6
    tot = t.totals()
    assert tot["host:data"] >= 0 and tot["count:loader_ready"] == \
        sum(readies)


def test_next_batch_without_a_timer_counts_nothing():
    loader = iter([{"data": 1}, {"data": 2}])
    stub = types.SimpleNamespace(timer=None, batch_to_device=lambda b: b)
    assert NNUNetTrainer.next_batch(stub, loader) == {"data": 1}


def test_engine_timer_is_the_profiling_timer():
    assert engine_module.PhaseTimer is PhaseTimer
