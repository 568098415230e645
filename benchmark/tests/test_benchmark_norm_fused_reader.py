"""The reader of ``s2d.norm_fused.serve`` (the engine's counters
``norms_fused`` / ``norms`` in the tracer's totals, kept as ``phases_ms``):
its value from a synthetic run, and None where the run lacks the keys (a
program without the counters)."""
import pytest

from benchmark.harness import common

NAME = "s2d.norm_fused.serve"


@pytest.mark.parametrize("fused,want", [(660, 100.0), (330, 50.0),
                                        (0, 0.0)])
def test_reader_value(fused, want):
    run = {"n": 4, "phases_ms": {"forward": 800.0, "count:norms": 660,
                                 "count:norms_fused": fused}}
    assert common.metric_reader(NAME)(run) == pytest.approx(want)


def test_no_launch_counted_reads_zero():
    run = {"n": 4, "phases_ms": {"forward": 800.0, "count:norms": 22}}
    assert common.metric_reader(NAME)(run) == 0.0


def test_reader_without_its_keys():
    read = common.metric_reader(NAME)
    # the parent's totals: phases and tile counters, no norm counters
    assert read({"n": 4, "phases_ms": {
        "forward": 800.0, "count:tiles_kept": 810,
        "count:tiles_forwarded": 1000}}) is None
    assert read({"n": 4}) is None
