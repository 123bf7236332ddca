"""ViT of the port (ray_tpu_torch.models.vit) against the JAX package.

Both packages get the same parameters (the JAX package's init, carried
across by ``convert.py``; the zero-initialised head is replaced by a
random one first, else no gradient reaches the blocks) and the same
images and labels (numpy, from a seed). The tiny config is
``tests/test_models.py``'s (32x32 images, patch 8, 2 layers, d 32, head
dim 16), with remat on and off. On the CPU both sides run plain
attention, non-causal. Everything is fp32, so the tolerances only absorb
summation order: 1e-5 relative on logits and loss, 1e-4 of each
gradient's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import vit as jvit
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.models.common import param_count
from ray_tpu_torch.models.convert import (vit_params_from_numpy,
                                          vit_tree_to_numpy)
from ray_tpu_torch.ops import _build

TINY = dict(image_size=32, patch_size=8, num_layers=2, num_heads=2,
            d_model=32, d_mlp=64, num_classes=10)


@pytest.fixture(autouse=True)
def _full_fp32():
    """fp32 products at full precision (see ``device.full_fp32``)."""
    with tdevice.full_fp32():
        yield


def _pair(remat: bool):
    jcfg = jvit.ViTConfig(**TINY, dtype=jnp.float32, remat=remat)
    tcfg = tvit.ViTConfig(**TINY, dtype=torch.float32, remat=remat)
    params, _ = jvit.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(7)
    params["head_w"] = jnp.asarray(
        0.02 * rng.standard_normal(params["head_w"].shape), jnp.float32)
    model = tvit.ViT(tcfg)
    model.load_state_dict(vit_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg))
    return jcfg, params, tcfg, model


def _batch(b=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, (b,)).astype(np.int32))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def test_config_table_matches():
    assert set(tvit.CONFIGS) == set(jvit.CONFIGS)
    for name, jc in jvit.CONFIGS.items():
        tc = tvit.CONFIGS[name]
        for f in ("image_size", "patch_size", "num_layers", "num_heads",
                  "d_model", "d_mlp", "num_classes", "remat",
                  "num_patches", "head_dim"):
            assert getattr(tc, f) == getattr(jc, f), (name, f)


def test_patchify_matches_jax():
    images, _ = _batch()
    want = np.asarray(jvit.patchify(jnp.asarray(images), 8))
    got = tvit.patchify(torch.from_numpy(images), 8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_and_grads_match_jax(remat):
    jcfg, params, tcfg, model = _pair(remat)
    images, labels = _batch()
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    want = np.asarray(jvit.forward(params, batch["image"], jcfg))
    got = model(torch.from_numpy(images))
    assert got.dtype == torch.float32
    assert _rel(got.detach().numpy(), want) < 1e-5

    jloss, jgrads = jax.value_and_grad(
        lambda p: jvit.loss_fn(p, batch, jcfg))(params)
    _build.reset_launch_counts()
    loss = model.loss_fn({"image": torch.from_numpy(images),
                          "label": torch.from_numpy(labels)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    grads = vit_tree_to_numpy({n: p.grad for n, p in
                               model.named_parameters()}, tcfg)
    for path, jg in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        keys = [k.key for k in path]
        tg = grads
        for k in keys:
            tg = tg[k]
        jg = np.asarray(jg)
        err = np.abs(tg - jg).max()
        assert err <= 1e-4 * np.abs(jg).max() + 1e-9, (keys, err)
    # The CPU runs the plain versions: no kernel launched.
    assert _build.launch_counts() == {}


def test_remat_is_one_checkpoint_per_block():
    """remat=True saves only each block's input for the backward (plus
    what lies outside the blocks); remat=False keeps every activation."""
    saved = {}
    for remat in (False, True):
        _, _, _, model = _pair(remat)
        images, labels = _batch()
        count = [0]

        def pack(t):
            count[0] += t.numel()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = model.loss_fn({"image": torch.from_numpy(images),
                                  "label": torch.from_numpy(labels)})
        loss.backward()
        saved[remat] = count[0]
    assert saved[True] < saved[False] / 2


def test_param_count_matches_jax():
    jcfg, params, _, model = _pair(False)
    assert param_count(model) == sum(int(x.size)
                                     for x in jax.tree.leaves(params))


def test_flops_per_image_counts_six_n_and_attention():
    cfg = tvit.CONFIGS["vit-b16"]
    n = 86_000_000
    s = 197
    assert tvit.flops_per_image(cfg, n) == s * (6 * n + 12 * 12 * 768 * s)
