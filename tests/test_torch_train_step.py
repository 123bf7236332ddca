"""Training step of the port (ray_tpu_torch.train) against the JAX
package's ``build_sharded_train`` on a 1-device mesh.

Same tiny GPT-2, same initial parameters (carried across), same tokens;
three steps of ``adamw_lowmem`` (bf16 moments), with and without the
fp32 master copy, with a constant lr and with the warmup-cosine
schedule. After each step: loss, grad_norm and every parameter.

Tolerances: the model runs in fp32 in both packages, so losses and norms
agree to 1e-5 relative. Parameters take three Adam steps whose moments
are rounded to bf16 (and, with the master copy, whose gradients and live
parameters are bf16), so they are held to 2e-3 of each tensor's largest
entry plus 1e-6, at lr 1e-3: where Adam's first moment nearly cancels
across steps, a one-ulp bf16 difference in a gradient or a moment moves
that update by a sizeable part of lr, and at lr 1e-3 this stays inside
the bound. Adam's eps is 1e-5 in both packages: the key bias's
gradient is zero up to rounding (softmax ignores a shift shared by a
row), and with eps 1e-8 Adam turns that rounding noise into steps of
+-lr that differ between any two summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel.mesh import MeshSpec
from ray_tpu.train.optim import adamw_lowmem as j_adamw_lowmem
from ray_tpu.train.step import build_sharded_train
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import (gpt2_params_from_numpy,
                                          gpt2_tree_to_numpy)
from ray_tpu_torch.train import optim as toptim
from ray_tpu_torch.train.step import build_train

TINY = dict(vocab_size=128, max_seq=64, num_layers=2, num_heads=2,
            d_model=64)
EPS = 1e-5


@pytest.fixture(autouse=True)
def _full_fp32():
    """fp32 products at full precision whatever the process was left with:
    the plain versions are the reference here (see ``device.full_fp32``)."""
    with tdevice.full_fp32():
        yield


def _close(actual, desired, bf16: bool):
    """Within 2e-3 of the tensor's largest entry (+1e-6); live bf16
    parameters may also sit one bf16 ulp (<= 2^-7 relative) apart where
    the fp32 masters straddle a rounding boundary."""
    tol = 2e-3 * np.abs(desired).max() + 1e-6
    if bf16:
        tol = tol + 2.0 ** -7 * np.abs(desired)
    err = np.abs(actual - desired)
    assert np.all(err <= tol), float((err - tol).max())


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("master_fp32", [False, True])
@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine"])
def test_three_steps_match_jax(master_fp32, schedule):
    jcfg = jgpt2.GPT2Config(**TINY, dtype=jnp.float32,
                            attention_impl="flash")
    tcfg = tgpt2.GPT2Config(**TINY, dtype=torch.float32,
                            attention_impl="flash")
    if schedule == "constant":
        j_lr = t_lr = 1e-3
    else:  # bench.py's shape, shortened: lr 0 at step 0, then warmup
        j_lr = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10,
                                                  end_value=1e-4)
        t_lr = toptim.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10,
                                                   end_value=1e-4)

    mesh = MeshSpec(dp=1).build(jax.devices()[:1])
    sinit, sstep, _ = build_sharded_train(
        lambda key: jgpt2.init_params(key, jcfg),
        lambda p, b: jgpt2.loss_fn(p, b, jcfg), mesh,
        optimizer=j_adamw_lowmem(j_lr, eps=EPS), master_fp32=master_fp32)
    jparams, jopt, jstep = sinit(jax.random.PRNGKey(0))

    init_tree = jax.tree.map(
        np.asarray, jgpt2.init_params(jax.random.PRNGKey(0), jcfg)[0])

    def init_fn(_generator):
        model = tgpt2.GPT2(tcfg)
        model.load_state_dict(gpt2_params_from_numpy(init_tree, tcfg))
        return model

    tinit, tstep = build_train(init_fn, lambda m, b: m.loss_fn(b),
                               optimizer=toptim.adamw_lowmem(t_lr, eps=EPS),
                               master_fp32=master_fp32, device="cpu")
    model, topt, step = tinit(0)

    # With bf16 gradients optax's global_norm sums their squares in bf16
    # and returns a bf16 scalar; the port sums in fp32. 1e-2 covers bf16's
    # 2^-8 relative spacing plus the rounding of the sum.
    gn_rtol = 1e-2 if master_fp32 else 1e-5
    rng = np.random.default_rng(0)
    for i in range(3):
        tokens = rng.integers(0, 128, (2, 33)).astype(np.int32)
        jparams, jopt, jstep, jm = sstep(jparams, jopt, jstep,
                                         {"tokens": jnp.asarray(tokens)})
        model, topt, step, tm = tstep(model, topt, step,
                                      {"tokens": torch.from_numpy(tokens)})
        assert step == i + 1
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=gn_rtol)
        tparams = gpt2_tree_to_numpy(dict(model.named_parameters()), tcfg)
        for pj, pt in zip(_leaves(jparams), jax.tree.leaves(tparams)):
            _close(pt, pj, bf16=master_fp32)
        if master_fp32:
            tmaster = gpt2_tree_to_numpy(dict(zip(
                (n for n, _ in model.named_parameters()), topt["master"])),
                tcfg)
            for pj, pt in zip(_leaves(jopt["master"]),
                              jax.tree.leaves(tmaster)):
                _close(pt, pj, bf16=False)
    dtypes = {p.dtype for p in model.parameters()}
    assert dtypes == ({torch.bfloat16} if master_fp32 else {torch.float32})


@pytest.mark.parametrize("count", [0, 1, 2, 5, 9, 10, 50])
def test_schedule_matches_optax(count):
    j = optax.warmup_cosine_decay_schedule(0.0, 1e-4, 3, 10, end_value=1e-5)
    t = toptim.warmup_cosine_decay_schedule(0.0, 1e-4, 3, 10,
                                            end_value=1e-5)
    np.testing.assert_allclose(t(count), float(j(count)), rtol=1e-6,
                               atol=1e-12)


def test_first_step_of_warmup_is_zero():
    """optax reads the schedule before incrementing: lr(0) = 0 with the
    bench schedule, so the first update leaves the parameters alone
    (weight decay included)."""
    sched = toptim.warmup_cosine_decay_schedule(0.0, 1e-4, 100, 1000,
                                                end_value=1e-5)
    opt = toptim.adamw_lowmem(sched)
    p = [torch.ones(3)]
    state = opt.init(p)
    upd, state = opt.update([torch.full((3,), 0.5)], state, p)
    assert torch.count_nonzero(upd[0]) == 0
    upd, state = opt.update([torch.full((3,), 0.5)], state, p)
    assert torch.all(upd[0] < 0)


def test_default_optimizer_matches_optax():
    """fp32 AdamW with clipping and the warmup-cosine schedule, three
    updates on fixed gradients, against ray_tpu's optax chain."""
    from ray_tpu.train.step import default_optimizer as j_default

    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32) * 3
             for _ in range(3)]
    jo = j_default(lr=1e-2, warmup=1, total_steps=5)
    to = toptim.default_optimizer(lr=1e-2, warmup=1, total_steps=5)
    jp, tp = jnp.asarray(p0), torch.from_numpy(p0.copy())
    js, ts = jo.init(jp), to.init([tp])
    for g in grads:
        ju, js = jo.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = to.update([torch.from_numpy(g)], ts, [tp])
        tp = tp + tu[0]
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-7)


BF16_TINY = dict(vocab_size=256, max_seq=64, num_layers=2, num_heads=2,
                 d_model=128)


def test_pure_bf16_adafactor_step_matches_jax():
    """bench.py's bench_15b recipe at a tiny size: bf16 parameters (the
    JAX package's ``cast_floating``; the port's), ``adafactor``, no master
    copy, ``mem2``, three steps of ``build_train`` against
    ``build_sharded_train`` on a 1-device mesh. d_model 128 so that the
    block weights are factored; lr 1e-2 so that an update moves a bf16
    parameter (at 1e-4 it rounds away).

    Tolerances. Both models compute in bf16, XLA fusing what PyTorch
    rounds op by op, so the bf16 gradients differ by roundings: losses
    agree to 1e-3 relative and the gradients' norms (summed in bf16 by
    optax, in fp32 here) to 1e-2. Adafactor divides each gradient by its
    own RMS estimate, so an element whose gradient is rounding noise (the
    key bias, which softmax ignores) moves by a whole step of either sign:
    an element may sit 3 bf16 ulps (3 * 2^-7 of its magnitude) plus twice
    its leaf's largest step of the reference at each step away, and the
    change of all parameters over the three steps is held to 15% (L2) of
    the reference's change (measured about 10%)."""
    from ray_tpu.models.common import cast_floating as j_cast_floating
    from ray_tpu_torch.models.common import cast_floating

    jcfg = jgpt2.GPT2Config(**BF16_TINY, dtype=jnp.bfloat16,
                            attention_impl="flash", remat=True,
                            remat_policy="mem2")
    tcfg = tgpt2.GPT2Config(**BF16_TINY, dtype=torch.bfloat16,
                            attention_impl="flash", remat_policy="mem2")

    def j_init(key):
        params, axes = jgpt2.init_params(key, jcfg)
        return j_cast_floating(params, jnp.bfloat16), axes

    mesh = MeshSpec(dp=1).build(jax.devices()[:1])
    sinit, sstep, _ = build_sharded_train(
        j_init, lambda p, b: jgpt2.loss_fn(p, b, jcfg), mesh,
        optimizer=optax.adafactor(learning_rate=1e-2), master_fp32=False)
    jparams, jopt, jstep = sinit(jax.random.PRNGKey(0))
    init_tree = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0))[0])

    def init_fn(_generator):
        model = cast_floating(tgpt2.GPT2(tcfg), torch.bfloat16)
        model.load_state_dict(gpt2_params_from_numpy(init_tree, tcfg))
        return model

    tinit, tstep = build_train(init_fn, lambda m, b: m.loss_fn(b),
                               optimizer=toptim.adafactor(1e-2),
                               master_fp32=False, device="cpu")
    model, topt, step = tinit(0)
    rng = np.random.default_rng(0)
    start = prev = _leaves(init_tree)
    slack = [np.zeros(()) for _ in start]
    for i in range(3):
        tokens = rng.integers(0, 256, (2, 65)).astype(np.int32)
        jparams, jopt, jstep, jm = sstep(jparams, jopt, jstep,
                                         {"tokens": jnp.asarray(tokens)})
        model, topt, step, tm = tstep(model, topt, step,
                                      {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-2)
        ref = _leaves(jparams)
        ours = jax.tree.leaves(gpt2_tree_to_numpy(
            dict(model.named_parameters()), tcfg))
        num = den = 0.0
        for k, (p0, p1, pj, pt) in enumerate(zip(start, prev, ref, ours)):
            slack[k] = slack[k] + 2 * np.abs(pj - p1).max()
            tol = 3 * 2.0 ** -7 * np.abs(pj) + slack[k]
            assert np.all(np.abs(pt - pj) <= tol), (i, k)
            num += float(np.sum((pt - pj) ** 2))
            den += float(np.sum((pj - p0) ** 2))
        change_err = (num / den) ** 0.5
        print(f"pure-bf16 adafactor step {i}: loss {float(tm['loss']):.6f} "
              f"(JAX {float(jm['loss']):.6f}); change of the parameters "
              f"{change_err:.4f} (L2) from the reference's")
        assert change_err < 0.15
        prev = ref
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    fs = topt["inner"][0]
    assert {t.dtype for k in ("v_row", "v_col", "v") for t in fs[k]
            if t is not None} == {torch.bfloat16}
