"""The reader of ``s2d.bias_folded.serve``: the engine's counters
``conv_bias_folded`` (kernel E's launches that took a conv bias) over
``norms``; None for a program that does not count the first."""
import pytest

from benchmark.harness import common


@pytest.mark.parametrize("counters,want", [
    ({"count:norms": 660, "count:conv_bias_folded": 660}, 100.0),
    ({"count:norms": 660, "count:conv_bias_folded": 330}, 50.0),
    # counted, and no launch took a bias (the CPU's plain version)
    ({"count:norms": 660, "count:conv_bias_folded": 0}, 0.0),
    # a program that counts the norms and not the folded biases
    ({"count:norms": 660, "count:norms_fused": 660}, None),
    ({"count:tiles_kept": 810, "count:tiles_forwarded": 1000}, None),
])
def test_bias_folded_share(counters, want):
    run = {"n": 4, "phases_ms": dict({"forward": 800.0}, **counters)}
    got = common.metric_reader("s2d.bias_folded.serve")(run)
    assert got == (None if want is None else pytest.approx(want))


def test_bias_folded_without_phases():
    read = common.metric_reader("s2d.bias_folded.serve")
    assert read({"n": 4}) is None
    assert read({"n": 4, "phases_ms": {}}) is None
