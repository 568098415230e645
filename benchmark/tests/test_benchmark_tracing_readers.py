"""The readers of the metrics that read the program's tracer
(utils/profiling.py ``PhaseTimer.totals()``, which the runners keep as
``phases_ms``): a value from a synthetic run, and None where the run lacks
the keys (a program without the tracer's spans and counters). Among them
``s2d.norm_fused.serve``: the engine's counters ``norms_fused`` (kernel
E's launches in the forwards) over ``norms``."""
import pytest

from benchmark.harness import common

RUN = {"n": 4, "phases_ms": {
    "d2h": 50.0, "forward": 800.0,
    "count:tiles_kept": 810, "count:tiles_forwarded": 1000,
    "count:d2h_pageable_bytes": 100_000_000,
    "count:d2h_pinned_bytes": 25_000_000,
    "host:forward_loss": 200.0, "host:backward": 240.0,
    "host:optimizer": 40.0, "host:data": 2.0, "count:loader_ready": 18}}


@pytest.mark.parametrize("name,want", [
    ("s2d.tile_yield.serve", 81.0),
    ("turbo.d2h_gbps.serve", 2.5),        # 125 MB in 50 ms
    ("train.host_step_ms", 120.0),
    ("train.loader_wait_ms", 0.5),
    ("train.loader_ready", 4.5),
])
def test_reader_value(name, want):
    assert common.metric_reader(name)(RUN) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "s2d.tile_yield.serve", "turbo.d2h_gbps.serve", "train.host_step_ms",
    "train.loader_wait_ms", "train.loader_ready", "s2d.norm_fused.serve"])
def test_reader_without_its_keys(name):
    read = common.metric_reader(name)
    # the parent's totals: CUDA-event phases only
    assert read({"n": 4, "phases_ms": {"d2h": 50.0, "forward": 800.0,
                                       "backward": 300.0, "data": 1.0}}) \
        is None
    assert read({"n": 4}) is None


def test_pinned_bytes_alone_read_a_bandwidth():
    run = {"n": 1, "phases_ms": {"d2h": 10.0,
                                 "count:d2h_pinned_bytes": 30_000_000}}
    assert common.metric_reader("turbo.d2h_gbps.serve")(run) == \
        pytest.approx(3.0)


@pytest.mark.parametrize("counters,want", [
    ({"count:norms": 660, "count:norms_fused": 660}, 100.0),
    ({"count:norms": 660, "count:norms_fused": 330}, 50.0),
    ({"count:norms": 660, "count:norms_fused": 0}, 0.0),
    # no launch counted: the pass was bypassed in every forward
    ({"count:norms": 22}, 0.0),
    # a program with the tile counters and without the norm counters
    ({"count:tiles_kept": 810, "count:tiles_forwarded": 1000}, None),
])
def test_norm_fused_share(counters, want):
    run = {"n": 4, "phases_ms": dict({"forward": 800.0}, **counters)}
    got = common.metric_reader("s2d.norm_fused.serve")(run)
    assert got == (None if want is None else pytest.approx(want))
