"""Adafactor of the port (``ray_tpu_torch.train.optim.adafactor``) against
``optax.adafactor``.

Both optimizers get the same parameters (a tiny GPT-2 made by the JAX
package and carried across by ``convert.py``) and, at every step, the same
gradients: the JAX package's, carried across bit for bit. d_model is 128
so that the block weights are factored (with narrower widths only ``wte``
is). optax runs eagerly, one rounding per operation, which is where the
port rounds too. The learning rate is 1e-2, not bench.py's 1e-4: at 1e-4 a
bf16 parameter moves less than one of its ulps, and its rounding would
hide a wrong update.

Tolerances. fp32: 1e-5 of each leaf's largest entry (summation order and
``pow`` against ``rsqrt``). bf16: an element may sit one bf16 ulp (2^-7
of its magnitude) from optax's, plus 1e-6 of the leaf's largest entry,
since one fp32 rounding that falls the other way in a sum or a root moves
the stored bf16 value by one ulp; the share of bit-equal elements is
printed beside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models.common import cast_floating as j_cast_floating
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.common import cast_floating, param_bytes
from ray_tpu_torch.models.convert import (gpt2_params_from_numpy,
                                          gpt2_tree_to_numpy,
                                          tensor_to_numpy)
from ray_tpu_torch.train import optim as toptim

TINY = dict(vocab_size=256, max_seq=64, num_layers=2, num_heads=2,
            d_model=128)
LR = 1e-2
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _full_fp32():
    """fp32 products at full precision whatever the process was left with
    (see ``device.full_fp32``)."""
    with tdevice.full_fp32():
        yield


def _setup(dtype: str, scale_layer1: bool = False):
    """(JAX config, JAX params, port config, module names, port params)."""
    jdt, tdt = DTYPES[dtype]
    jcfg = jgpt2.GPT2Config(**TINY, dtype=jdt, attention_impl="reference")
    tcfg = tgpt2.GPT2Config(**TINY, dtype=tdt)
    params, _ = jgpt2.init_params(jax.random.PRNGKey(0), jcfg)
    if scale_layer1:
        params["blocks"] = jax.tree.map(lambda x: x.at[1].multiply(4.0),
                                        params["blocks"])
    params = j_cast_floating(params, jdt)
    model = cast_floating(tgpt2.GPT2(tcfg), tdt)
    model.load_state_dict(gpt2_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg))
    names = [n for n, _ in model.named_parameters()]
    return jcfg, params, tcfg, names, [p.detach() for p in
                                       model.parameters()]


def _grads(jcfg, params, tcfg, names, step):
    tokens = np.random.default_rng(step).integers(
        0, TINY["vocab_size"], (2, 65)).astype(np.int32)
    g = jax.grad(lambda p: jgpt2.loss_fn(p, {"tokens": jnp.asarray(tokens)},
                                         jcfg))(params)
    named = gpt2_params_from_numpy(jax.tree.map(np.asarray, g), tcfg)
    return g, [named[n] for n in names]


def _tol(desired: np.ndarray, dtype: str) -> np.ndarray:
    big = np.abs(desired).max()
    if dtype == "fp32":
        return 1e-5 * big + 0.0 * desired
    return 2.0 ** -7 * np.abs(desired) + 1e-6 * big


def _worst(actual, desired, dtype):
    """Largest excess over the tolerance (<= 0 within it) and the share of
    bit-equal elements."""
    err = np.abs(actual - desired)
    return float((err - _tol(desired, dtype)).max()), float(
        np.mean(actual == desired))


def _run(dtype, steps, scale_layer1=False, grouped=True):
    """Both optimizers for ``steps`` steps; returns the JAX params and
    state, the port's params (as a JAX-layout tree), state and groups."""
    jcfg, jparams, tcfg, names, tparams = _setup(dtype, scale_layer1)
    jopt = optax.adafactor(learning_rate=LR)
    topt = toptim.adafactor(LR)
    groups = toptim.leaf_groups(names) if grouped else None
    jstate, tstate = jopt.init(jparams), topt.init(tparams, groups)
    for step in range(steps):
        jg, tg = _grads(jcfg, jparams, tcfg, names, step)
        ju, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, ju)
        tu, tstate = topt.update(tg, tstate, tparams)
        tparams = [p + u for p, u in zip(tparams, tu)]
        assert all(p.dtype == DTYPES[dtype][1] for p in tparams)
    ttree = gpt2_tree_to_numpy(dict(zip(names, tparams)), tcfg)
    return jparams, jstate, ttree, tstate, names


def _leaf_path(names, leaf):
    """The JAX tree path of one of the port's leaves."""
    name = names[leaf.members[0]]
    return ("blocks", name.split(".", 2)[2]) if leaf.stacked else (name,)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree, np.float32)


def _param_report(jparams, ttree, dtype):
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    out = {}
    for path, leaf in flat_j:
        keys = tuple(k.key for k in path)
        out[keys] = _worst(_at(ttree, keys), np.asarray(leaf, np.float32),
                           dtype)
    return out


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_adafactor_matches_optax(dtype, steps):
    jparams, jstate, ttree, tstate, names = _run(dtype, steps)
    report = _param_report(jparams, ttree, dtype)
    equal = np.mean([share for _, share in report.values()])
    print(f"adafactor {dtype} {steps} step(s): parameters bit-equal to "
          f"optax, mean share over leaves {equal:.4f}")
    bad = {k: v for k, v in report.items() if v[0] > 0}
    assert not bad, bad

    jfs = jstate[0]
    fs = tstate["inner"][0]
    assert fs["count"] == int(jfs.count) == steps
    n_factored = 0
    for i, leaf in enumerate(tstate["groups"]):
        path = _leaf_path(names, leaf)
        for key in ("v_row", "v_col", "v"):
            ours, ref = fs[key][i], _at(getattr(jfs, key), path)
            if ours is None:  # the reference keeps zeros((1,)) there
                assert ref.shape == (1,) and not ref.any(), (path, key)
                continue
            assert ours.dtype == DTYPES[dtype][1]
            assert tuple(ours.shape) == ref.shape, (path, key)
            excess, share = _worst(tensor_to_numpy(ours), ref, dtype)
            assert excess <= 0, (path, key, excess, share)
        n_factored += fs["v_row"][i] is not None
    # wte and the four block weights are factored (wpe's 64 rows are not).
    assert n_factored == 5


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_per_layer_block_rms_reads_above_the_tolerance(dtype):
    """Planted fault: each layer's tensor taken as a leaf of its own, on
    parameters whose second layer is scaled x4. Its block RMS (clip and
    parameter scale) then differs from the stacked leaf's; the grouped run
    of the same parameters stays within the tolerance."""
    jparams, _, good, _, _ = _run(dtype, 1, scale_layer1=True)
    assert max(v[0] for v in _param_report(jparams, good, dtype).values()
               ) <= 0
    _, _, bad, _, _ = _run(dtype, 1, scale_layer1=True, grouped=False)
    excess = {k: v[0] for k, v in _param_report(jparams, bad,
                                                dtype).items()}
    print(f"per-layer block RMS, {dtype}: largest excess over the "
          f"tolerance {max(excess.values()):.3e}")
    assert max(excess.values()) > 0
    assert all(excess[k] <= 0 for k in excess if k[0] != "blocks")


@pytest.mark.parametrize("shape,dims", [
    ((2, 128, 384), (1, 2)), ((48, 1600), None), ((300, 200), (1, 0)),
    ((2, 128, 128), (1, 2)), ((200, 4, 300), (0, 2)), ((512,), None),
    ((130, 127), None)])
def test_factored_dims_as_optax(shape, dims):
    """The factoring decision on the stacked shape, ties broken as
    optax's argsort breaks them (also when it picks the layer axis)."""
    from optax._src.factorized import _factored_dims as j_factored_dims

    assert toptim._factored_dims(shape, 128) == dims
    assert j_factored_dims(shape, True, 128) == dims


def test_factoring_over_the_layer_axis_matches_optax():
    """A leaf whose layer count reaches 128 is factored across its layers:
    the port stacks the group, so the reference's rule holds as is."""
    rng = np.random.default_rng(0)
    p = rng.standard_normal((130, 200)).astype(np.float32)
    g = rng.standard_normal((130, 200)).astype(np.float32)
    jopt, topt = optax.adafactor(LR), toptim.adafactor(LR)
    names = [f"blocks.{i}.b" for i in range(130)]
    tp = [torch.from_numpy(r.copy()) for r in p]
    tg = [torch.from_numpy(r.copy()) for r in g]
    ju, _ = jopt.update(jnp.asarray(g), jopt.init(jnp.asarray(p)),
                        jnp.asarray(p))
    tu, st = topt.update(tg, topt.init(tp, toptim.leaf_groups(names)), tp)
    assert st["inner"][0]["v_row"][0].shape == (130,)
    np.testing.assert_allclose(torch.stack(tu).numpy(), np.asarray(ju),
                               rtol=0, atol=1e-5 * np.abs(ju).max())


def test_leaf_groups_stack_blocks_by_name():
    names = ["wte", "blocks.0.w", "blocks.0.b", "blocks.1.w", "blocks.1.b",
             "enc.blocks.0.w", "lnf"]
    assert toptim.leaf_groups(names) == [
        toptim.Leaf((0,), False), toptim.Leaf((1, 3), True),
        toptim.Leaf((2, 4), True), toptim.Leaf((5,), True),
        toptim.Leaf((6,), False)]
    with pytest.raises(ValueError, match="not 0..1"):
        toptim.leaf_groups(["blocks.0.w", "blocks.2.w"])


def test_adafactor_state_is_small_and_in_the_params_dtype():
    """bf16 parameters give bf16 state, factored leaves a row and a column
    each: far below AdamW-bf16's 2 x 2 bytes a parameter."""
    _, _, _, names, tparams = _setup("bf16")
    state = toptim.adafactor(LR).init(tparams, toptim.leaf_groups(names))
    fs = state["inner"][0]
    tensors = [t for k in ("v_row", "v_col", "v") for t in fs[k]
               if t is not None]
    assert {t.dtype for t in tensors} == {torch.bfloat16}
    n = sum(p.numel() for p in tparams)
    assert sum(t.numel() * 2 for t in tensors) < 0.1 * 4 * n


def test_cast_floating_and_param_bytes():
    _, _, tcfg, _, _ = _setup("fp32")
    model = tgpt2.GPT2(tcfg)
    n = sum(p.numel() for p in model.parameters())
    assert param_bytes(model) == 4 * n
    assert cast_floating(model, torch.bfloat16) is model
    assert param_bytes(model) == 2 * n
    tree = cast_floating({"w": torch.ones(3), "i": [torch.arange(3)]},
                         torch.bfloat16)
    assert tree["w"].dtype == torch.bfloat16
    assert tree["i"][0].dtype == torch.int64
