"""What decides ``correct``: the plain reference against the program, the
control, and runs with the timed path broken underneath, all at tiny width
on the CPU and held to the limits of ``gpt2-1.5b.s1024-b16``."""

import contextlib

import pytest

from portbench import calibrate, compare

from .conftest import tiny_cell

SEEDS = (3, 2 ** 31 + 17)


def judged(cell, seed, fault=contextlib.nullcontext):
    with fault():
        out = cell.driver.run(cell, seed, 0.0, False, "cpu", lambda: 0.0)
    values = compare.readings(out["readings"]["program"],
                              out["readings"]["reference"])
    ok, _ = compare.judge(values, cell.limits)
    return ok and out["failed"] == 0, values


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_follows_the_program_in_fp32(seed):
    # Same parameters in fp32 on both sides: only the order of sums differs.
    cell = tiny_cell("float32")
    _, v = judged(cell, seed)
    assert v["loss_gap"] < 1e-6
    assert v["grad_norm_gap"] < 1e-5
    assert v["change_norm_gap"] < 1e-3


@pytest.mark.parametrize("seed", SEEDS)
def test_a_sound_run_is_correct(seed):
    ok, v = judged(tiny_cell(), seed)
    assert ok, v


@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails(seed):
    cell = tiny_cell()
    fam, conf = cell.family, cell.config
    batches = fam.make_batches(conf, cell.mix, seed, cell.mix["pool"],
                               "cpu")[:cell.mix["check_steps"]]
    ref = fam.reference_train(conf, fam.make_weights(conf, seed, "cpu"),
                              batches)
    ctl = fam.reference_train(conf, fam.make_weights(conf, seed, "cpu"),
                              batches, "fp8")
    ok, checks = compare.judge(compare.readings(ctl, ref), cell.limits)
    assert not ok, checks


@contextlib.contextmanager
def loss_altered():
    """The loss each step reports, altered by a part in a thousand where
    the model produces it."""
    from ray_tpu_torch.models import gpt2

    orig = gpt2.GPT2.loss_fn
    gpt2.GPT2.loss_fn = lambda self, *a, **k: orig(self, *a, **k) * 1.001
    try:
        yield
    finally:
        gpt2.GPT2.loss_fn = orig


FAULTS = dict(calibrate.FAULTS, loss_altered=loss_altered)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    ok, v = judged(tiny_cell(), SEEDS[0], FAULTS[fault])
    assert not ok, v
    # The fault is gone once its context has closed.
    assert judged(tiny_cell(), SEEDS[0])[0]


def test_floored_lists_the_parameters_under_the_median():
    ref = {("a", 0): 1.0, ("a", 1): 0.01, ("b", 0): 2.0, ("b", 1): 0.5,
           ("c", 0): 3.0}
    prog = dict(ref)
    prog[("a", 1)] = 0.0   # wholly wrong, yet 1% of the median's norm
    prog[("b", 1)] = 0.55
    keys = list(ref)
    assert compare.gaps(prog, ref, keys)[("a", 1)] == pytest.approx(0.01)
    out = compare.floored(prog, ref, keys)
    assert sorted(out) == ["a", "b"]
    assert out["a"] == pytest.approx([1, 0.01, 1.0])
    assert out["b"] == pytest.approx([1, 0.5, 0.1])
