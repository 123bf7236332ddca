"""The port's ``build_sharded_train`` and ``make_eval_step``
(ray_tpu_torch.train.step) against the JAX package's, on the same mesh
shapes.

A tiny fp32 GPT-2 (the JAX package's initial parameters, carried across)
takes three ``adamw_lowmem`` steps (lr 1e-3, eps 1e-5, as
tests/test_torch_train_step.py) on the same tokens. The port runs as four
gloo ranks on the CPU (``torch_dist_worker``, one world for every mesh,
behind a module-scoped fixture); the JAX package on the conftest's virtual
CPU mesh. Dense attention is the port's flash entry point (its plain
version on the CPU) against the JAX package's reference attention; ring
and Ulysses are each package's own.

Meshes: dp2 x tp2; fsdp2 x sp2 with ring attention; dp2 x sp2 with
Ulysses; ep4 with 8 experts (the batch rule over dp, fsdp and ep); pp4
with rules {"layers": "pp"} (four layers stacked and sharded, one a
stage, each rank holding its own), which also runs
``make_eval_step`` after its steps. Losses and gradient norms are held to
1e-4 relative; measured: <= 3e-7 (this container's CPU). MoE GPT-2
without a mesh is held against the JAX ``loss_fn`` in one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel.mesh import MeshSpec
from ray_tpu.parallel.sharding import prune_rules_for_mesh, under_mesh
from ray_tpu.train.optim import adamw_lowmem as j_adamw_lowmem
from ray_tpu.train.step import build_sharded_train, make_eval_step
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import (gpt2_params_from_numpy,
                                          gpt2_tree_to_numpy)

TINY = dict(vocab_size=128, max_seq=64, num_heads=4, d_model=64)
MOE = dict(num_experts=8, moe_top_k=2)
RTOL = 1e-4
MESHES = {  # name: (mesh, model options, rules, layers)
    "dp2_tp2": (dict(dp=2, tp=2), {}, None, 2),
    "fsdp2_sp2_ring": (dict(fsdp=2, sp=2), dict(attention_impl="ring"),
                       None, 2),
    "dp2_sp2_ulysses": (dict(dp=2, sp=2), dict(attention_impl="ulysses"),
                        None, 2),
    "ep4_moe": (dict(ep=4), MOE, {"batch": ("dp", "fsdp", "ep")}, 2),
    "pp4": (dict(pp=4), {}, {"layers": "pp"}, 4),
}


def _tokens(seed, n=3, batch=8, seq=33):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, (batch, seq)).astype(np.int32)
            for _ in range(n)]


def _jcfg(layers, opts):
    opts = dict(opts)
    impl = opts.pop("attention_impl", "reference")
    return jgpt2.GPT2Config(**TINY, num_layers=layers, dtype=jnp.float32,
                            attention_impl=impl, remat=False, **opts)


def _params(layers, opts):
    return jax.tree.map(np.asarray, jgpt2.init_params(
        jax.random.PRNGKey(0), _jcfg(layers, opts))[0])


def _tcfg(layers, opts):
    return dict(TINY, num_layers=layers, dtype=torch.float32,
                **dict(dict(attention_impl="flash"), **opts))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = []
    for name, (mesh, opts, rules, layers) in MESHES.items():
        cases.append(("case_sharded_train", dict(
            mesh=mesh, cfg=_tcfg(layers, opts), params=_params(layers, opts),
            tokens=_tokens(0), rules=rules,
            eval_tokens=_tokens(1, 1)[0] if name == "pp4" else None)))
    results = W.run_world(4, cases, tmp_path_factory.mktemp("gloo"))
    return {name: [results[r][i] for r in range(4)]
            for i, name in enumerate(MESHES)}


def _jax_run(mesh_kw, opts, rules, layers, eval_tokens=None):
    jcfg = _jcfg(layers, opts)
    spec = MeshSpec(**mesh_kw)
    mesh = spec.build(jax.devices()[:spec.num_devices])
    pruned = prune_rules_for_mesh(mesh, rules)

    def loss_fn(p, b):
        return jgpt2.loss_fn(p, b, jcfg, rules=pruned)

    sinit, sstep, _ = build_sharded_train(
        lambda key: jgpt2.init_params(key, jcfg), loss_fn, mesh, rules=rules,
        optimizer=j_adamw_lowmem(1e-3, eps=1e-5), master_fp32=False)
    params, opt, step = sinit(jax.random.PRNGKey(0))
    losses, norms = [], []
    for tok in _tokens(0):
        params, opt, step, m = sstep(params, opt, step,
                                     {"tokens": jnp.asarray(tok)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    ev = None
    if eval_tokens is not None:
        ev = under_mesh(mesh, make_eval_step(loss_fn, mesh, rules, None))(
            params, {"tokens": jnp.asarray(eval_tokens)})
    return np.asarray(losses), np.asarray(norms), ev


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_steps_match_jax(world, name):
    mesh, opts, rules, layers = MESHES[name]
    want_l, want_n, _ = _jax_run(mesh, opts, rules, layers)
    for r, res in enumerate(world[name]):
        np.testing.assert_allclose(res["losses"], want_l, rtol=RTOL,
                                   err_msg=f"rank {r} losses")
        np.testing.assert_allclose(res["norms"], want_n, rtol=RTOL,
                                   err_msg=f"rank {r} grad norms")


def test_pp_stages_hold_their_own_layers(world):
    """Under pp4 the layers are stacked and sharded over pp, as the JAX
    package's ``P("pp")`` blocks: each rank holds one of the four layers
    of every block parameter, and so of its optimizer state."""
    _, _, _, layers = MESHES["pp4"]
    for res in world["pp4"]:
        assert len(res["layer_rows"]) == 12  # the dense block's parameters
        assert (res["layer_rows"] == layers // 4).all()
        assert len(res["state_layer_rows"]) >= 2 * 12  # Adam's mu and nu
        assert (res["state_layer_rows"] == layers // 4).all()
    for res in world["dp2_tp2"]:  # no "layers" rule: one block a layer
        assert len(res["layer_rows"]) == 0


def test_eval_step_matches_jax(world):
    mesh, opts, rules, layers = MESHES["pp4"]
    _, _, want = _jax_run(mesh, opts, rules, layers, _tokens(1, 1)[0])
    for res in world["pp4"]:
        np.testing.assert_allclose(res["eval"], float(want), rtol=RTOL)


def test_moe_gpt2_without_mesh_matches_jax():
    """MoE GPT-2 (8 experts, top-2) on plain tensors: loss and every
    gradient (router, experts included) against ``jax.value_and_grad`` of
    the JAX ``loss_fn``; 1e-5 relative on the loss, 1e-4 of each
    gradient's largest entry (measured: loss 1e-7, gradients 6.6e-7)."""
    jcfg = _jcfg(2, MOE)
    tcfg = tgpt2.GPT2Config(**_tcfg(2, MOE))
    params, _ = jgpt2.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = _tokens(2, 1)[0]
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jgpt2.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg)))(
        params)
    model = tgpt2.GPT2(tcfg)
    model.load_state_dict(gpt2_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg))
    with tdevice.full_fp32():
        loss_t = model.loss_fn({"tokens": torch.from_numpy(tokens)})
        loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    grads_t = gpt2_tree_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}, tcfg)
    assert set(grads_t["blocks"]) == set(grads_j["blocks"])
    for name, gj in grads_j["blocks"].items():
        gj = np.asarray(gj)
        err = np.abs(grads_t["blocks"][name] - gj).max() / np.abs(gj).max()
        assert err < 1e-4, (name, err)
