"""GPT-2 of the port (ray_tpu_torch.models.gpt2) against the JAX package.

Both packages get the same parameters (made by the JAX package's init
and carried across by ``convert.py``) and the same tokens (numpy, from a
seed). The JAX side runs ``attention_impl="flash"``, i.e. the Pallas
kernels in interpret mode; the port runs its attention kernels' plain
versions on the CPU. Everything is fp32 here, so the tolerances only
absorb summation order: 1e-5 relative on the loss, 1e-4 of each
gradient's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.common import param_count
from ray_tpu_torch.models.convert import (gpt2_params_from_numpy,
                                          gpt2_tree_to_numpy,
                                          tensor_from_numpy)

TINY = dict(vocab_size=128, max_seq=64, num_layers=2, num_heads=2,
            d_model=64)


@pytest.fixture(autouse=True)
def _full_fp32():
    """fp32 products at full precision whatever the process was left with:
    the plain versions are the reference here (see ``device.full_fp32``)."""
    with tdevice.full_fp32():
        yield


def _pair(**kw):
    jcfg = jgpt2.GPT2Config(**TINY, dtype=jnp.float32,
                            attention_impl="flash", **kw)
    tcfg = tgpt2.GPT2Config(**TINY, dtype=torch.float32,
                            attention_impl="flash")
    params, _ = jgpt2.init_params(jax.random.PRNGKey(0), jcfg)
    model = tgpt2.GPT2(tcfg)
    model.load_state_dict(gpt2_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg))
    return jcfg, params, tcfg, model


def _tokens(b=2, s=33, seed=0, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_config_table_matches():
    assert set(tgpt2.CONFIGS) == set(jgpt2.CONFIGS)
    for name, jc in jgpt2.CONFIGS.items():
        tc = tgpt2.CONFIGS[name]
        assert tc.num_params() == jc.num_params()
        assert tgpt2.flops_per_token(tc, 1024) == jgpt2.flops_per_token(
            jc, 1024)


def test_param_count_matches_config():
    _, params, _, model = _pair()
    assert param_count(model) == sum(
        int(np.prod(p.shape)) for p in jax.tree.leaves(params))


@pytest.mark.parametrize("loss_chunk", [4096, 24])
def test_loss_and_grads_match_jax(loss_chunk):
    """loss_chunk 24 cuts 64 tokens into padded chunks (ignore_id path)."""
    jcfg, params, tcfg, model = _pair()
    tokens = _tokens()
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jgpt2.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg,
                                loss_chunk=loss_chunk))(params)
    loss_t = model.loss_fn({"tokens": torch.from_numpy(tokens)},
                           loss_chunk=loss_chunk)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    grads_t = gpt2_tree_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}, tcfg)
    flat_j = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    for path, gj in flat_j:
        gt = grads_t
        for key in path:
            gt = gt[key.key]
        gj = np.asarray(gj)
        err = np.abs(gt - gj).max() / max(np.abs(gj).max(), 1e-12)
        assert err < 1e-4, (jax.tree_util.keystr(path), err)


def test_logits_match_jax():
    jcfg, params, _, model = _pair()
    tokens = _tokens(s=32)
    lj = np.asarray(jgpt2.forward(params, jnp.asarray(tokens), jcfg))
    with torch.no_grad():
        lt = model(torch.from_numpy(tokens)).numpy()
    assert lt.dtype == np.float32
    np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-5)


def test_bf16_params_cross_bit_exact():
    """bf16 leaves cross as their uint16 bits (no ml_dtypes import)."""
    x = jnp.asarray(np.random.default_rng(1).standard_normal((3, 5)),
                    jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(x))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy(),
        np.asarray(x).view(np.int16))


@pytest.mark.parametrize("kw,item", [
    (dict(attention_impl="ring"), "item 7"),
    (dict(attention_impl="ulysses"), "item 7"),
    (dict(num_experts=4), "item 7"),
    (dict(remat_policy="dots"), "item 3b"),
])
def test_unported_options_raise(kw, item):
    cfg = tgpt2.GPT2Config(**TINY, **kw)
    with pytest.raises(NotImplementedError, match=item):
        tgpt2.GPT2(cfg)


def test_sharding_rules_raise():
    model = tgpt2.GPT2(tgpt2.GPT2Config(**TINY, dtype=torch.float32))
    with pytest.raises(NotImplementedError, match="item 7"):
        model.forward_features(torch.zeros((1, 4), dtype=torch.long),
                               rules={"layers": "pp"})


@pytest.mark.parametrize("fn", ["layer_norm", "rms_norm",
                                "cross_entropy_loss"])
def test_common_matches_jax(fn):
    """models/common.py pieces against ray_tpu.models.common (fp32)."""
    from ray_tpu.models import common as jc
    from ray_tpu_torch.models import common as tc

    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    t = torch.from_numpy
    if fn == "layer_norm":
        want = jc.layer_norm(x, scale, bias)
        got = tc.layer_norm(t(x), t(scale), t(bias))
    elif fn == "rms_norm":
        want = jc.rms_norm(x, scale)
        got = tc.rms_norm(t(x), t(scale))
    else:
        targets = rng.integers(-1, 16, (3, 5)).astype(np.int32)
        want = jc.cross_entropy_loss(x, targets)
        got = tc.cross_entropy_loss(t(x), t(targets))
        np.testing.assert_allclose(float(got[1]), float(want[1]))
        want, got = want[0], got[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
