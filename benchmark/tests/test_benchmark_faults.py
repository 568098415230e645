"""A run at a size a CPU test holds, with the look for a chip skipped:
sound, it comes out correct; with the timed path broken underneath it
comes out not correct, once for each fault the cell can have (a state
left unchanged, half of the batch left out with the mean taken over the
rest, an answer altered where it is produced; one chip: no exchange to
leave out). And the control, the reference in float8 in the program's
place, fails a number of each cell."""
import time
from unittest import mock

import pytest
import torch

import fast_nnunet_tpu_torch.inference.engine as engine
import fast_nnunet_tpu_torch.inference.turbo as turbo
import fast_nnunet_tpu_torch.training.optimizers as optimizers
import fast_nnunet_tpu_torch.training.train_step as train_step
from benchmark import control
from benchmark.harness import cli, common
from benchmark.tests import tiny

CPU = torch.device("cpu")


def correct(files, seconds=0.5, seed=31):
    out = cli.measure(files, seed, seconds, False, CPU, time.perf_counter())
    return common.passed(out["checks"])


# ----------------------------------------------------------------- serving
_accumulate = engine.s2d_accumulate
_predict = turbo.TurboPipeline.predict_volume


def _unchanged(acc, *a, **k):
    return None


def _half(acc, feats, g, w, b, coords, valid, row_base=0):
    v = valid.copy()
    v[len(v) // 2:] = 0
    return _accumulate(acc, feats, g, w, b, coords, v, row_base)


def _altered(self, *a, **k):
    m = _predict(self, *a, **k).copy()
    z = m.shape[0] // 2
    m[z, 8:16, 8:16] = (m[z, 8:16, 8:16] + 1) % 5
    return m


SERVE_FAULTS = {
    "state_unchanged": mock.patch.object(engine, "s2d_accumulate",
                                         _unchanged),
    "half_batch": mock.patch.object(engine, "s2d_accumulate", _half),
    "answer_altered": mock.patch.object(turbo.TurboPipeline,
                                        "predict_volume", _altered),
}


def test_serve_sound_run_is_correct():
    assert correct(tiny.serve_files())


@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
def test_serve_fault_is_not_correct(fault):
    with SERVE_FAULTS[fault]:
        assert not correct(tiny.serve_files())


def test_serve_control_fails():
    files = tiny.serve_files()
    r = control.readings("serve")(files, 11, "control", CPU)
    assert not common.passed(common.checks_of(r, files["limits"]))


# ---------------------------------------------------------------- training
_forward_loss = train_step.forward_loss


def _half_loss(network, loss_fn, weights, data, targets):
    n = data.shape[0] // 2
    return _forward_loss(network, loss_fn, weights, data[:n],
                         [t[:n] for t in targets])


def _altered_loss(*a, **k):
    out, loss = _forward_loss(*a, **k)
    return out, loss * 1.05


TRAIN_FAULTS = {
    "state_unchanged": mock.patch.object(optimizers.ChainedOptimizer, "step",
                                         lambda self: None),
    "half_batch": mock.patch.object(train_step, "forward_loss", _half_loss),
    "answer_altered": mock.patch.object(train_step, "forward_loss",
                                        _altered_loss),
}


@pytest.mark.parametrize("mix", ["train", "distill"])
def test_train_sound_run_is_correct(mix):
    assert correct(tiny.train_files(mix), seconds=1.0)


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_is_not_correct(fault):
    with TRAIN_FAULTS[fault]:
        assert not correct(tiny.train_files(), seconds=0.5)


@pytest.mark.parametrize("mix", ["train", "distill"])
def test_train_control_fails(mix):
    files = tiny.train_files(mix)
    r = control.readings("train")(files, 12, "control", CPU)
    assert not common.passed(common.checks_of(r, files["limits"]))


@pytest.mark.cuda
def test_serve_control_fails_at_the_cells_size():
    """On the card: the control at bone_turbo.serve's own size reads above
    the cell's limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    files = common.cell_files(common.benchmark_spec(), "bone_turbo.serve")
    r = control.readings("serve")(files, 5001, "control",
                                  torch.device("cuda", 0))
    assert not common.passed(common.checks_of(r, files["limits"]))
