"""tp-sharded serving and Llama's sharding rules in the port, against the
JAX package (tests/test_llm_tp.py holds the JAX engine the same way).

The port runs as two gloo ranks on the CPU (``torch_dist_worker``, one
world for every case, behind a module-scoped fixture): rank 0 schedules,
rank 1 follows. llama-tiny (fp32) gets the JAX package's
``init_params(PRNGKey(0))`` weights, a 21-token prompt from
``default_rng(5)`` and 16 new tokens at ``num_slots=2, chunk=8,
page_size=8, decode_block=2``. Tokens must be equal: the port at tp2, the
port at tp1, the JAX engine at tp1 and at tp2 (``MeshSpec(tp=2)`` over two
of the conftest's virtual CPU devices), greedy and at temperature 0.7 with
seed 99. The tp2 sums run in another order than tp1's single products, so
the logits differ by rounding (~1e-7 relative); the tokens do not.
Llama's loss and gradients under tp2 rules are held to the JAX
``loss_fn`` on a two-device mesh within 1e-5 relative (each gradient to
its largest entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker as W
from ray_tpu.llm.engine import SlotEngine as JaxEngine
from ray_tpu.models import llama as jl
from ray_tpu.parallel.mesh import MeshSpec
from ray_tpu.parallel.sharding import prune_rules_for_mesh, under_mesh

CFG = jl.CONFIGS["llama-tiny"]
ENGINE = dict(num_slots=2, chunk=8, page_size=8, decode_block=2)
MAX_NEW = 16
SAMPLED = dict(temperature=0.7, seed=99)
RULES = {  # name: (rules, remat)
    "default": (None, False),
    "kv_tp_remat": ({"kv": "tp"}, True),
}


@pytest.fixture(scope="module")
def params():
    return jl.init_params(jax.random.PRNGKey(0), CFG)[0]


@pytest.fixture(scope="module")
def prompt():
    rng = np.random.default_rng(5)
    return [int(t) for t in rng.integers(1, CFG.vocab_size, size=21)]


def _loss_tokens():
    return np.random.default_rng(1).integers(
        1, CFG.vocab_size, (2, 25)).astype(np.int32)


@pytest.fixture(scope="module")
def world(params, prompt, tmp_path_factory):
    host = jax.tree.map(np.asarray, params)
    cases = [("case_llm_tp", dict(params=host, prompt=prompt,
                                  max_new=MAX_NEW, engine_kw=ENGINE)),
             ("case_llm_server_tp", dict(params=host, prompt=prompt,
                                         max_new=MAX_NEW))]
    cases += [("case_llama_grads", dict(params=host, tokens=_loss_tokens(),
                                        rules=rules, remat=remat))
              for rules, remat in RULES.values()]
    return W.run_world(2, cases, tmp_path_factory.mktemp("gloo"))


def _jax_drive(eng, prompt, **kw):
    h = eng.submit(prompt, max_new=MAX_NEW, **kw)
    for _ in range(4000):
        if h._done.is_set():
            return h.result(timeout=0).tokens
        eng.step()
    raise AssertionError("the JAX engine did not finish")


@pytest.fixture(scope="module")
def jax_tokens(params, prompt):
    """The JAX engine's greedy and sampled tokens at tp1 and tp2."""
    out = {}
    for tp in (1, 2):
        mesh = MeshSpec(tp=2).build(jax.devices()[:2]) if tp == 2 else None
        eng = JaxEngine(params, CFG, mesh=mesh, **ENGINE)
        out[tp] = (_jax_drive(eng, prompt), _jax_drive(eng, prompt, **SAMPLED))
    return out


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_tp2_tokens_equal_tp1_and_jax(world, jax_tokens, kind):
    res = world[0][0]
    i = ["greedy", "sampled"].index(kind)
    got = res[kind].tolist()
    assert len(got) == MAX_NEW
    assert got == res[f"{kind}_tp1"].tolist()
    assert got == jax_tokens[1][i] == jax_tokens[2][i]


def test_tp2_ranks_hold_their_shards(world):
    """After the requests (many in-place cache writes), each rank holds
    H/2 query heads, Hkv/2 KV heads, d_mlp/2 MLP columns, vocab/2 rows and
    Hkv/2 heads of every page; norms whole. No block graph at tp2."""
    d, hd = CFG.d_model, CFG.head_dim
    h2, kv2 = CFG.num_heads // 2, CFG.num_kv_heads // 2
    m2, v2 = CFG.d_mlp // 2, CFG.vocab_size // 2
    want = {"wte": (v2, d), "final_norm": (d,), "attn_norm": (d,),
            "ffn_norm": (d,), "wq": (d, h2 * hd), "wk": (d, kv2 * hd),
            "wv": (d, kv2 * hd), "wo": (h2 * hd, d), "w_gate": (d, m2),
            "w_up": (d, m2), "w_down": (m2, d)}
    for rank in world:
        res = rank[0]
        assert str(res["kv_spec"]) == str((None, None, None, None, "tp"))
        for name, shape in res["local"].items():
            assert tuple(shape) == want[name.rsplit(".", 1)[-1]], name
        pool = tuple(res["pool"])
        assert pool[4] == kv2 and pool[5] == hd, pool
    assert bool(world[0][0]["no_graphs"])


def test_tp_must_divide_head_counts(world):
    for rank in world:
        assert "tp=2 must divide" in str(rank[0]["bad_error"])


def test_decode_profile_counts_tp_devices(world):
    assert int(world[0][0]["devices"]) == 2


def test_sessions_cross_tp1_and_tp2(world):
    """A session exported at tp1 continues at tp2 with the tokens tp1
    gives, and one exported at tp2 (the whole heads: the shards gathered)
    continues at tp1 with tp2's."""
    res = world[0][0]
    assert int(res["session_tp_matched"]) > 0
    assert (res["session_tp_after_import"].tolist()
            == res["session_tp1_alone"].tolist())
    assert int(res["snapshot_heads"]) == CFG.num_kv_heads
    assert (res["session_tp1_after_import"].tolist()
            == res["session_tp_alone"].tolist())


def test_llm_server_tp2_answers_plain_and_streaming(world):
    rank0, rank1 = world[0][1], world[1][1]
    assert int(rank0["tp"]) == int(rank1["tp"]) == 2
    assert bool(rank1["followed"])
    assert rank0["plain"].tolist() == rank0["stream"].tolist() \
        == world[0][0]["greedy_tp1"].tolist()


@pytest.mark.parametrize("name", list(RULES))
def test_llama_rules_loss_and_grads_match_jax(world, params, name):
    rules, remat = RULES[name]
    import dataclasses

    jcfg = dataclasses.replace(CFG, remat=remat)
    mesh = MeshSpec(tp=2).build(jax.devices()[:2])
    pruned = prune_rules_for_mesh(mesh, rules)
    tokens = _loss_tokens()
    loss_j, grads_j = under_mesh(mesh, jax.jit(jax.value_and_grad(
        lambda p: jl.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg,
                             pruned))))(params)
    idx = 2 + list(RULES).index(name)
    for rank in world:
        res = rank[idx]
        np.testing.assert_allclose(float(res["loss"]), float(loss_j),
                                   rtol=1e-5)
        for path, gj in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
            gt = res["grads"]
            for key in path:
                gt = gt[key.key]
            gj = np.asarray(gj)
            err = np.abs(gt - gj).max() / max(np.abs(gj).max(), 1e-12)
            assert err < 1e-5, (jax.tree_util.keystr(path), err)
        # The weights are split as the rules say: wq over tp, wk by "kv".
        kv_split = 2 if rules and rules.get("kv") == "tp" else 1
        assert tuple(res["local"]["blocks.0.wq"]) == (
            CFG.d_model, CFG.d_model // 2)
        assert tuple(res["local"]["blocks.0.wk"]) == (
            CFG.d_model, CFG.num_kv_heads * CFG.head_dim // kv_split)
