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
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.models.convert import (gpt2_params_from_numpy,
                                          gpt2_tree_to_numpy,
                                          tensor_from_numpy)

TINY = dict(vocab_size=128, max_seq=64, num_layers=2, num_heads=2,
            d_model=64)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: at these sizes more buy little time and crowd
    the test processes running beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _full_fp32():
    """fp32 products at full precision whatever the process was left with:
    the plain versions are the reference here (see ``device.full_fp32``)."""
    with tdevice.full_fp32():
        yield


def _pair(remat_policy="none", attention_impl="flash", **kw):
    jcfg = jgpt2.GPT2Config(**TINY, dtype=jnp.float32,
                            attention_impl=attention_impl,
                            remat=remat_policy != "none",
                            remat_policy=remat_policy, **kw)
    tcfg = tgpt2.GPT2Config(**TINY, dtype=torch.float32,
                            attention_impl=attention_impl,
                            remat_policy=remat_policy, **kw)
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


def _grads(model):
    return {n: p.grad for n, p in model.named_parameters()}


def _assert_grads_match_jax(grads_j, model, tcfg):
    """Every gradient within 1e-4 of its largest JAX entry."""
    grads_t = gpt2_tree_to_numpy(_grads(model), tcfg)
    flat_j = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    for path, gj in flat_j:
        gt = grads_t
        for key in path:
            gt = gt[key.key]
        gj = np.asarray(gj)
        err = np.abs(gt - gj).max() / max(np.abs(gj).max(), 1e-12)
        assert err < 1e-4, (jax.tree_util.keystr(path), err)


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
    _assert_grads_match_jax(grads_j, model, tcfg)


POLICIES = ["full", "dots", "dots_attn", "mem", "mem2"]


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_matches_none_and_jax(policy, monkeypatch):
    """Each remat policy: loss and every gradient equal the port's "none"
    run (1e-6 relative, of each gradient's largest entry) and JAX's
    ``loss_fn`` under the same policy (1e-5 on the loss, 1e-4 on each
    gradient). The plain attention's forward runs once per layer where
    the policy keeps attention (dots_attn, mem, mem2) and twice where the
    backward recomputes it (full, dots)."""
    jcfg, params, tcfg, model = _pair(policy)
    _, _, _, plain = _pair()
    batch = {"tokens": torch.from_numpy(_tokens())}
    loss_none = plain.loss_fn(batch)
    loss_none.backward()
    forwards = []
    fwd = tattn.mha_reference_with_lse
    monkeypatch.setattr(tattn, "mha_reference_with_lse",
                        lambda *a, **k: forwards.append(1) or fwd(*a, **k))
    loss_t = model.loss_fn(batch)
    loss_t.backward()
    runs = 1 if "attn" in tgpt2.REMAT_KEEPS[policy] else 2
    assert len(forwards) == runs * TINY["num_layers"]
    assert abs(loss_t.item() - loss_none.item()) <= 1e-6 * loss_none.item()
    want = _grads(plain)
    for name, g in _grads(model).items():
        err = ((g - want[name]).abs().max()
               / want[name].abs().max().clamp_min(1e-12)).item()
        assert err < 1e-6, (name, err)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jgpt2.loss_fn(p, {"tokens": jnp.asarray(_tokens())},
                                jcfg))(params)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    _assert_grads_match_jax(grads_j, model, tcfg)


def _jax_remat(block, policy):
    """``block`` under the JAX package's remat policy of that name
    (``ray_tpu/models/gpt2.py`` forward_features)."""
    cp = jax.checkpoint_policies
    names = {"mem": ("qkv", "attn_out", "attn_lse", "mlp_in"),
             "mem2": ("qkv", "attn_out", "attn_lse")}
    if policy == "dots":
        return jax.checkpoint(block, policy=cp.dots_with_no_batch_dims_saveable)
    if policy == "dots_attn":
        return jax.checkpoint(block, policy=cp.save_from_both_policies(
            cp.dots_with_no_batch_dims_saveable,
            cp.save_only_these_names("attn_out", "attn_lse")))
    if policy in names:
        return jax.checkpoint(block,
                              policy=cp.save_only_these_names(*names[policy]))
    return jax.checkpoint(block)


@pytest.mark.parametrize("policy", POLICIES)
def test_moe_remat_policy_matches_none_and_jax(policy, monkeypatch):
    """MoE GPT-2 (4 experts, top-2) under each remat policy: loss and every
    gradient equal the port's "none" run (1e-6 relative, of each
    gradient's largest entry) and JAX's ``loss_fn`` at ``remat=True`` with
    the same policy (1e-5 on the loss, 1e-4 on each gradient). Attention's
    forward runs once per layer where the policy keeps it and twice where
    the backward recomputes it."""
    jcfg, params, tcfg, model = _pair(policy, num_experts=4)
    _, _, _, plain = _pair(num_experts=4)
    batch = {"tokens": torch.from_numpy(_tokens())}
    loss_none = plain.loss_fn(batch)
    loss_none.backward()
    forwards = []
    fwd = tattn.mha_reference_with_lse
    monkeypatch.setattr(tattn, "mha_reference_with_lse",
                        lambda *a, **k: forwards.append(1) or fwd(*a, **k))
    loss_t = model.loss_fn(batch)
    loss_t.backward()
    runs = 1 if "attn" in tgpt2.MOE_REMAT_KEEPS[policy] else 2
    assert len(forwards) == runs * TINY["num_layers"]
    assert abs(loss_t.item() - loss_none.item()) <= 1e-6 * loss_none.item()
    want = _grads(plain)
    for name, g in _grads(model).items():
        err = ((g - want[name]).abs().max()
               / want[name].abs().max().clamp_min(1e-12)).item()
        assert err < 1e-6, (name, err)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jgpt2.loss_fn(p, {"tokens": jnp.asarray(_tokens())},
                                jcfg))(params)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    _assert_grads_match_jax(grads_j, model, tcfg)


@pytest.mark.parametrize("policy", POLICIES)
def test_moe_remat_saved_set_matches_jax(policy):
    """What one MoE block (4 experts) leaves for its backward: the bytes a
    saved_tensors_hooks pack hook sees (each storage once, the block's
    input and the parameters left out) equal JAX's saved residuals of the
    same block under the same policy (``jax.ad_checkpoint``'s
    ``print_saved_residuals``, arguments left out, and the second name of
    attention's output, which ``_attend`` tags again, counted once). The
    layouts differ (a kept attention holds q, k, v in head layout where JAX
    keeps qkv), the bytes do not."""
    import contextlib
    import io
    import re
    from functools import partial

    import jax.ad_checkpoint

    jcfg, params, _, model = _pair(policy, num_experts=4)
    x = np.random.default_rng(2).standard_normal((2, 32, 64)).astype(
        np.float32)
    p0 = jax.tree.map(lambda a: a[0], params["blocks"])
    block = _jax_remat(partial(jgpt2._block, cfg=jcfg, rules=None), policy)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        jax.ad_checkpoint.print_saved_residuals(
            lambda x, p: (lambda r: r[0].sum() + r[1])(block(x, p)),
            jnp.asarray(x), p0)
    residuals = [re.match(r"(f32|s32)\[([\d,]*)\] (.*)", line).groups()
                 for line in text.getvalue().splitlines()]
    named = any("named 'attn_out'" in why for _, _, why in residuals)
    want = sum(4 * int(np.prod([int(n) for n in shape.split(",") if n]))
               for _, shape, why in residuals
               if not why.startswith("from the argument")
               and not (named and "(_attend)" in why))
    xt = torch.from_numpy(x).requires_grad_()
    skip = {p.untyped_storage().data_ptr() for p in model.parameters()}
    skip.add(xt.untyped_storage().data_ptr())
    storages = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in skip:
            storages[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out, aux = model.blocks[0](xt)
    (out.sum() + aux).backward()
    assert sum(storages.values()) == want, (storages, want)


def test_remat_saved_bytes_order():
    """Bytes the forward leaves for the backward, counted by a
    saved_tensors_hooks pack hook (each storage once): a checkpointed
    region shows only its inputs, a kept attention its q, k, v, o, lse.
    mem2 < mem < none, and full keeps least."""
    batch = {"tokens": torch.from_numpy(_tokens())}
    saved = {}
    for policy in ["none", "mem", "mem2", "full"]:
        model = _pair(policy)[3]
        storages = {}

        def pack(t):
            st = t.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = model.loss_fn(batch)
        loss.backward()
        saved[policy] = sum(storages.values())
    assert saved["full"] < saved["mem2"] < saved["mem"] < saved["none"], saved


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


PARALLEL = {  # the options that need parallel/, by name
    "ring": dict(attention_impl="ring"),
    "ulysses": dict(attention_impl="ulysses"),
    "moe": dict(num_experts=4),
}


EP2_DOTS = dict(num_experts=4, remat_policy="dots")
EP_RULES = {"batch": ("dp", "fsdp", "ep")}


@pytest.fixture(scope="module")
def sp2_world(tmp_path_factory):
    """Ring and Ulysses GPT-2 on two gloo ranks (sp=2), pp+MoE, and MoE
    under "dots" at ep=2."""
    import torch_dist_worker as W

    cases = [("case_gpt2_grads", dict(
        mesh=dict(sp=2), cfg=dict(TINY, dtype=torch.float32, **PARALLEL[o]),
        params=jax.tree.map(np.asarray, _pair(**PARALLEL[o])[1]),
        tokens=_tokens())) for o in ("ring", "ulysses")]
    cases.append(("case_pp_moe_raises", dict(cfg=dict(
        TINY, dtype=torch.float32, num_experts=4))))
    cases.append(("case_gpt2_grads", dict(
        mesh=dict(ep=2), cfg=dict(TINY, dtype=torch.float32, **EP2_DOTS),
        params=jax.tree.map(np.asarray, _pair(**EP2_DOTS)[1]),
        tokens=_tokens(), rules=EP_RULES)))
    return W.run_world(2, cases, tmp_path_factory.mktemp("gloo"))


@pytest.mark.parametrize("option", list(PARALLEL))
def test_parallel_options_match_jax(option, sp2_world):
    """Ring and Ulysses attention (sp=2, two gloo ranks, each rank's loss
    and gradients) and MoE (4 experts, top-2, one process) against the
    JAX model's ``loss_fn`` on the same mesh shape: 1e-5 relative on the
    loss, 1e-4 of each gradient's largest entry. Measured: losses <= 1e-7;
    gradients <= 5e-7 (ring, Ulysses) and 2.1e-6 (MoE)."""
    from ray_tpu.parallel.mesh import MeshSpec
    from ray_tpu.parallel.sharding import under_mesh

    jcfg, params, tcfg, model = _pair(**PARALLEL[option])
    tokens = _tokens()

    def loss(p):
        return jgpt2.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg)

    if option == "moe":
        loss_j, grads_j = jax.jit(jax.value_and_grad(loss))(params)
        loss_t = model.loss_fn({"tokens": torch.from_numpy(tokens)})
        loss_t.backward()
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
        _assert_grads_match_jax(grads_j, model, tcfg)
        return
    mesh = MeshSpec(sp=2).build(jax.devices()[:2])
    loss_j, grads_j = under_mesh(mesh, jax.jit(jax.value_and_grad(loss)))(
        params)
    for rank in sp2_world:
        res = rank[list(PARALLEL).index(option)]
        np.testing.assert_allclose(float(res["loss"]), float(loss_j),
                                   rtol=1e-5)
        for path, gj in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
            gt = res["grads"]
            for key in path:
                gt = gt[key.key]
            gj = np.asarray(gj)
            err = np.abs(gt - gj).max() / max(np.abs(gj).max(), 1e-12)
            assert err < 1e-4, (jax.tree_util.keystr(path), err)


def test_pp_with_moe_raises(sp2_world):
    """pp+MoE is refused, as the JAX package refuses it."""
    for rank in sp2_world:
        assert "pp+MoE is not supported" in str(rank[2]["error"])


def test_moe_ep2_dots_matches_jax(sp2_world):
    """MoE GPT-2 (4 experts) under "dots" at ep=2 (two gloo ranks, each
    routing its half of the batch to experts split over ep): each rank's
    loss and gradients against the JAX model at ``remat=True,
    remat_policy="dots"`` on the same mesh, 1e-5 relative on the loss and
    1e-4 of each gradient's largest entry."""
    from ray_tpu.parallel.mesh import MeshSpec
    from ray_tpu.parallel.sharding import prune_rules_for_mesh, under_mesh

    jcfg, params, _, _ = _pair(**EP2_DOTS)
    tokens = _tokens()
    mesh = MeshSpec(ep=2).build(jax.devices()[:2])
    rules = prune_rules_for_mesh(mesh, EP_RULES)
    loss_j, grads_j = under_mesh(mesh, jax.jit(jax.value_and_grad(
        lambda p: jgpt2.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg,
                                rules=rules))))(params)
    for rank in sp2_world:
        res = rank[3]
        np.testing.assert_allclose(float(res["loss"]), float(loss_j),
                                   rtol=1e-5)
        for path, gj in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
            gt = res["grads"]
            for key in path:
                gt = gt[key.key]
            gj = np.asarray(gj)
            err = np.abs(gt - gj).max() / max(np.abs(gj).max(), 1e-12)
            assert err < 1e-4, (jax.tree_util.keystr(path), err)


def test_parallel_attention_needs_a_mesh():
    _, _, _, model = _pair(attention_impl="ring")
    with pytest.raises(RuntimeError, match="ambient mesh"):
        model.loss_fn({"tokens": torch.from_numpy(_tokens())})


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        tgpt2.GPT2(tgpt2.GPT2Config(**TINY, remat_policy="dot"))


def test_rules_without_mesh_are_the_identity():
    """Rules without a mesh change nothing, as ``constrain`` in the JAX
    package: the logits equal those without rules (and pp rules do not
    pipeline)."""
    _, _, _, model = _pair()
    tokens = torch.from_numpy(_tokens(s=16))
    with torch.no_grad():
        plain = model(tokens)
        for rules in ({"layers": "pp"}, {"batch": "dp", "heads": "tp"}):
            torch.testing.assert_close(model(tokens, rules=rules), plain,
                                       rtol=0, atol=0)


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
