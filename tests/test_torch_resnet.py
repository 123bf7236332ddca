"""ResNet of the port (ray_tpu_torch.models.resnet) against the JAX
package.

Both packages get the same parameters and batch statistics (the JAX
package's init, carried across by ``convert.py``: HWIO kernels become
OIHW) and the same images and labels (numpy, from a seed). Tiny configs:
stage_sizes (1, 1), width 8, the CIFAR and the ImageNet stem, 32x32
images, batch 4. Everything is fp32, so the tolerances only absorb
summation order: 1e-5 relative on logits and loss, 1e-4 of each
gradient's largest entry, and 1e-6 absolute on the new statistics (the
variances sit near 1, the means far below; measured 1.2e-7, one fp32 ulp
at 1).

Two planted faults must read above their gates: the symmetric padding of
``nn.Conv2d(padding=k // 2)`` in place of XLA's "SAME", and
``nn.BatchNorm2d``'s running-statistics update (unbiased variance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ray_tpu.models import resnet as jresnet
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.models import resnet as tresnet
from ray_tpu_torch.models.common import param_count
from ray_tpu_torch.models.convert import (resnet_params_from_numpy,
                                          resnet_tree_to_numpy)

TOL_LOGITS = 1e-5
TOL_STATS = 1e-6


@pytest.fixture(autouse=True)
def _full_fp32():
    """fp32 products at full precision (see ``device.full_fp32``)."""
    with tdevice.full_fp32():
        yield


def _pair(cifar_stem: bool):
    kw = dict(stage_sizes=(1, 1), width=8, num_classes=10,
              cifar_stem=cifar_stem)
    jcfg = jresnet.ResNetConfig(**kw, dtype=jnp.float32)
    tcfg = tresnet.ResNetConfig(**kw, dtype=torch.float32)
    params, stats = jresnet.init_params(jax.random.PRNGKey(0), jcfg)
    model = tresnet.ResNet(tcfg)
    model.load_state_dict(resnet_params_from_numpy(
        jax.tree.map(np.asarray, params)))
    tstats = resnet_params_from_numpy(jax.tree.map(np.asarray, stats))
    return jcfg, params, stats, model, tstats


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, (4,)).astype(np.int32))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _forward_errors(cifar_stem: bool):
    """Logits' and new statistics' largest relative errors against the JAX
    forward in training mode."""
    jcfg, params, stats, model, tstats = _pair(cifar_stem)
    images, _ = _batch()
    jlogits, jstats = jresnet.forward(params, stats, jnp.asarray(images),
                                      jcfg, training=True)
    with torch.no_grad():
        logits, new = model(tstats, torch.from_numpy(images), training=True)
    return _rel(logits.numpy(), np.asarray(jlogits)), _stats_err(new, jstats)


def _stats_err(new, jstats):
    ours = resnet_tree_to_numpy(new)
    return max(float(np.abs(ours[k] - np.asarray(v)).max())
               for k, v in jstats.items())


def test_config_table_matches():
    assert set(tresnet.CONFIGS) == set(jresnet.CONFIGS)
    for name, jc in jresnet.CONFIGS.items():
        tc = tresnet.CONFIGS[name]
        for f in ("stage_sizes", "num_classes", "width", "cifar_stem"):
            assert getattr(tc, f) == getattr(jc, f), (name, f)


@pytest.mark.parametrize("cifar_stem", [True, False])
def test_param_count_and_stats_match_jax(cifar_stem):
    _, params, stats, model, tstats = _pair(cifar_stem)
    assert param_count(model) == sum(int(x.size)
                                     for x in jax.tree.leaves(params))
    ref = tresnet.init_stats(model.cfg, "cpu")
    assert ref.keys() == tstats.keys() == stats.keys()
    assert all(torch.equal(ref[k], tstats[k]) for k in ref)


@pytest.mark.parametrize("size,k,stride", [(32, 3, 2), (16, 3, 2), (32, 1, 2),
                                           (31, 3, 2), (32, 3, 1)])
def test_same_conv_matches_xla(size, k, stride):
    """XLA's "SAME" on even and odd inputs, stride 1 and 2 (a 3x3 stride-2
    conv on an even input pads 0 before and 1 after)."""
    rng = np.random.default_rng(size + k + stride)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    want = np.asarray(jresnet.conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = tresnet.conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w).permute(3, 2, 0, 1), stride)
    assert _rel(got.permute(0, 2, 3, 1).numpy(), want) < TOL_LOGITS
    if (size, k, stride) == (32, 3, 2):
        assert tresnet.same_pads(size, k, stride) == (0, 1)


@pytest.mark.parametrize("cifar_stem", [True, False])
def test_forward_and_stats_match_jax(cifar_stem):
    e_logits, e_stats = _forward_errors(cifar_stem)
    assert e_logits < TOL_LOGITS
    assert e_stats < TOL_STATS
    jcfg, params, stats, model, tstats = _pair(cifar_stem)
    images, _ = _batch()
    jlogits, _ = jresnet.forward(params, stats, jnp.asarray(images), jcfg,
                                 training=False)
    with torch.no_grad():
        logits, same = model(tstats, torch.from_numpy(images))
    assert same.keys() == tstats.keys()
    assert all(same[k] is tstats[k] for k in same)
    assert _rel(logits.numpy(), np.asarray(jlogits)) < TOL_LOGITS


@pytest.mark.parametrize("cifar_stem", [True, False])
def test_loss_acc_and_grads_match_jax(cifar_stem):
    jcfg, params, stats, model, tstats = _pair(cifar_stem)
    images, labels = _batch(1)
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    (jloss, (jstats, jacc)), jgrads = jax.value_and_grad(
        lambda p: jresnet.loss_fn(p, stats, batch, jcfg), has_aux=True)(
            params)
    loss, (new, acc) = model.loss_fn(
        tstats, {"image": torch.from_numpy(images),
                 "label": torch.from_numpy(labels)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=TOL_LOGITS)
    assert float(acc) == float(jacc)
    grads = resnet_tree_to_numpy({n: p.grad for n, p in
                                  model.named_parameters()})
    assert grads.keys() == jgrads.keys()
    for name, jg in jgrads.items():
        jg = np.asarray(jg)
        err = np.abs(grads[name] - jg).max()
        assert err <= 1e-4 * np.abs(jg).max() + 1e-9, (name, err)
    assert _stats_err(new, jstats) < TOL_STATS


def _symmetric_conv(x, w, stride=1, padding="SAME"):
    if padding != "SAME":
        return F.conv2d(x, w, stride=stride, padding=padding[0][0])
    return F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2)


def _batchnorm2d_update(x, scale, bias, mean, var, training,
                        momentum=0.9, eps=1e-5):
    """nn.BatchNorm2d's training step: the same output, and running
    statistics updated with its momentum 0.1 and the unbiased variance."""
    rm, rv = mean.clone(), var.clone()
    y = F.batch_norm(x.float(), rm, rv, scale, bias, training=True,
                     momentum=0.1, eps=eps)
    return y.to(x.dtype), rm, rv


@pytest.mark.parametrize("cifar_stem", [True, False])
def test_planted_symmetric_padding_reads_above_the_gate(cifar_stem,
                                                         monkeypatch):
    monkeypatch.setattr(tresnet, "conv", _symmetric_conv)
    e_logits, _ = _forward_errors(cifar_stem)
    assert e_logits > TOL_LOGITS


@pytest.mark.parametrize("cifar_stem", [True, False])
def test_planted_batchnorm2d_update_reads_above_the_gate(cifar_stem,
                                                         monkeypatch):
    monkeypatch.setattr(tresnet, "batch_norm", _batchnorm2d_update)
    e_logits, e_stats = _forward_errors(cifar_stem)
    assert e_logits < TOL_LOGITS  # the output is the same
    assert e_stats > TOL_STATS
