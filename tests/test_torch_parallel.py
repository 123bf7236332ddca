"""The port's parallel layer (ray_tpu_torch.parallel) against the JAX
package's ``ray_tpu.parallel``.

The JAX side runs on the conftest's virtual 8-device CPU mesh. The port's
side runs as gloo processes on the CPU (``torch_dist_worker``): one world
of four ranks runs every multi-rank case, behind a module-scoped fixture,
and the tests read its results. Inputs come from numpy seeds on both
sides; everything is fp32.

Measured errors (largest |difference| over the largest |reference|, this
container's CPU): ring einsum output and gradients at sp=4 and sp=2, causal
and not, <= 6.6e-7; ring-flash <= 6.8e-7; Ulysses output and gradients
<= 4.6e-7; MoE at ep=1 and ep=4 <= 2.5e-7 with the expert choices and the
dispatch equal; the pipeline at pp=4 <= 3.8e-7; the in-graph ops
(``collective.ops``) and their gradients <= 1.2e-7. The tests hold them
to 1e-5 (the ops to 1e-6); the eager collectives exactly where they move
values and to 1e-6 (relative) where they sum four of them, in an order
gloo picks.
"""

import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_dist_worker as W
from ray_tpu.parallel import collective as jcoll
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import moe as jmoe
from ray_tpu.parallel import sharding as jsharding
from ray_tpu.parallel.pipeline import pipeline_apply as j_pipeline_apply
from ray_tpu.parallel.ring import ring_attention as j_ring_attention
from ray_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.parallel import bootstrap as tboot
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import moe as tmoe
from ray_tpu_torch.parallel import sharding as tsharding

TOL = 1e-5
RING = [  # (mesh, shape, causal): sp=4, then dp2 x sp2
    (dict(sp=4), (2, 2, 64, 16), True),
    (dict(sp=4), (2, 2, 64, 16), False),
    (dict(dp=2, sp=2), (2, 2, 32, 8), True),
    (dict(dp=2, sp=2), (2, 2, 32, 8), False),
]
ULYSSES = (dict(sp=4), (2, 8, 64, 16))
MOE = dict(tokens=32, model=8, hidden=16, experts=8, top_k=2,
           capacity_factor=2.0)

CASES = ([("case_mesh_device", {}), ("case_collectives", {}),
          ("case_ops", {})]
         + [("case_ring", dict(mesh=m, shape=s, causal=c))
            for m, s, c in RING]
         + [("case_ring", dict(mesh=dict(sp=4), shape=(2, 2, 64, 16),
                               causal=c, impl="flash")) for c in (True, False)]
         + [("case_ulysses", dict(mesh=ULYSSES[0], shape=ULYSSES[1]))]
         + [("case_moe_ep", MOE), ("case_pipeline", {})])


def _index(name, **kw):
    return next(i for i, (n, k) in enumerate(CASES)
                if n == name and all(k.get(a) == b for a, b in kw.items()))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every multi-rank case on one world of four gloo ranks."""
    return W.run_world(4, CASES, tmp_path_factory.mktemp("gloo"))


@pytest.fixture(autouse=True)
def _full_fp32():
    with tdevice.full_fp32():
        yield


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                     1e-12)
    assert err < tol, err


def _jmesh(**axes):
    spec = jmesh.MeshSpec(**axes)
    return spec.build(jax.devices()[:spec.num_devices])


# -- mesh, rules, bootstrap (one process) ----------------------------------------

@pytest.mark.parametrize("args", [
    dict(n=8, tp=2, sp=2), dict(n=8, tp=2, fsdp=2), dict(n=8, ep=4),
    dict(n=4, pp=4), dict(n=1), dict(n=16, tp=4, sp=2, fsdp=2)])
def test_mesh_spec_matches_jax(args):
    j = jmesh.MeshSpec.for_devices(**args)
    t = tmesh.MeshSpec.for_devices(**args)
    assert t.axis_sizes() == j.axis_sizes()
    assert t.num_devices == j.num_devices
    assert t.active_axes() == j.active_axes()
    assert t.describe() == j.describe()
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    for chips in (1, 4, 8):
        assert (tmesh.MeshClaim(t, name="c").to_bundles(chips)
                == jmesh.MeshClaim(j, name="c").to_bundles(chips))


@pytest.mark.parametrize("args", [dict(n=6, tp=4), dict(n=8, tp=2, fsdp=3)])
def test_mesh_spec_errors_match_jax(args):
    with pytest.raises(ValueError):
        jmesh.MeshSpec.for_devices(**args)
    with pytest.raises(ValueError):
        tmesh.MeshSpec.for_devices(**args)


def test_mesh_build_needs_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.MeshSpec(dp=2).build()


LOGICAL = [("batch", "seq", "embed"), (None, "heads"), ("layers", "embed",
           "qkv"), ("vocab", "embed"), ("expert", "embed", "mlp"),
           ("batch", "seq", None), (None, None), ()]
OVERRIDES = [None, {"batch": ("dp", "fsdp", "ep")}, {"layers": "pp"},
             {"embed": None, "mlp": ("tp", "ep")}]


@pytest.mark.parametrize("rules", OVERRIDES)
def test_spec_for_matches_jax(rules):
    for axes in LOGICAL:
        t = tsharding.spec_for(axes, rules)
        assert t == jsharding.spec_for(axes, rules), axes
    tree = {"a": ("batch", "seq"), "b": {"c": ("embed", "mlp")}}
    jt, tt = jsharding.tree_spec(tree, rules), tsharding.tree_spec(tree,
                                                                 rules)
    assert tt["a"] == jt["a"] and tt["b"]["c"] == jt["b"]["c"]
    assert tsharding.P("dp", None) == JP("dp", None)


@pytest.mark.parametrize("axes", [dict(dp=8), dict(dp=2, tp=2, sp=2),
                                  dict(ep=4, dp=2), dict(pp=4, fsdp=2)])
@pytest.mark.parametrize("rules", OVERRIDES)
def test_prune_rules_matches_jax(axes, rules):
    j = _jmesh(**axes)
    spec = tmesh.MeshSpec(**axes)
    # The port reads a mesh's dim names and shape only.
    fake = types.SimpleNamespace(
        mesh_dim_names=tmesh.AXIS_ORDER,
        mesh=torch.zeros([getattr(spec, a) for a in tmesh.AXIS_ORDER]))
    pruned = tsharding.prune_rules_for_mesh(fake, rules)
    assert pruned == jsharding.prune_rules_for_mesh(j, rules)
    # Placements: Shard(i) on each mesh dim the spec splits tensor dim i
    # over, as the JAX NamedSharding's spec names them.
    tree = {"w": ("embed", "mlp"), "x": ("batch", "seq", None)}
    jspecs = jsharding.tree_spec(tree, pruned)
    for name, pl in tsharding.shardings_for(fake, tree, pruned).items():
        want = {}
        for dim, entry in enumerate(jspecs[name]):
            for axis in ((entry,) if isinstance(entry, str) else entry or ()):
                want[axis] = dim
        got = {a: p.dim for a, p in zip(tmesh.AXIS_ORDER, pl)
               if p.is_shard()}
        assert got == want, name


def test_constrain_is_identity_without_a_mesh():
    x = torch.randn(2, 3)
    assert tsharding.constrain(x, ("batch", None), {"batch": "dp"}) is x
    assert tsharding.constrain(x, ("batch", None), None) is x


# Bootstrap over the in-process KV, as tests/test_bootstrap.py drives the
# JAX package's over its stores.

def test_concurrent_rank_claims_are_disjoint():
    kv, world, results = tboot.InMemoryKV(), 8, {}
    barrier = threading.Barrier(world, timeout=10)

    def host(i):
        bs = tboot.Bootstrap(kv, world_size=world, session="s1")
        barrier.wait()
        results[i] = bs.claim_rank()

    threads = [threading.Thread(target=host, args=(i,)) for i in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert sorted(results.values()) == list(range(world))


def test_extra_host_rejected_and_reclaim():
    kv = tboot.InMemoryKV()
    bs = tboot.Bootstrap(kv, world_size=1, session="s2")
    assert bs.claim_rank() == 0
    bs.rank = None
    assert bs.claim_rank() == 0  # same token: its own slot again
    with pytest.raises(tboot.BootstrapError):
        tboot.Bootstrap(kv, world_size=1, session="s2").claim_rank()


def test_coordinator_publish_and_poll():
    kv, world, addresses = tboot.InMemoryKV(), 3, {}

    def host(i):
        bs = tboot.Bootstrap(kv, world_size=world, session="s3")
        rank = bs.claim_rank()
        addresses[rank] = bs.coordinator_address(port=12345, timeout_s=10)

    threads = [threading.Thread(target=host, args=(i,)) for i in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=15)
    assert len(addresses) == world
    assert set(addresses.values()) == {"127.0.0.1:12345"}


def test_barrier_blocks_until_all_arrive():
    kv, world, order = tboot.InMemoryKV(), 4, []

    def host(i):
        bs = tboot.Bootstrap(kv, world_size=world, session="s4")
        bs.claim_rank()
        time.sleep(0.05 * i)
        bs.barrier("sync", timeout_s=10)
        order.append(i)

    threads = [threading.Thread(target=host, args=(i,)) for i in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=15)
    assert sorted(order) == list(range(world))


def test_unclaimed_rank_raises():
    bs = tboot.Bootstrap(tboot.InMemoryKV(), world_size=2)
    for call in (bs.coordinator_address, bs.barrier, bs.initialize_torch):
        with pytest.raises(tboot.BootstrapError):
            call()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the "
                    "refusal on a machine without a card")
def test_mesh_defaults_to_the_card(world):
    """A gloo group does not put its mesh on the CPU: ``build()`` asks for
    the card (and raises without one); the CPU only when asked for."""
    for rank in range(4):
        res = world[rank][_index("case_mesh_device")]
        assert str(res["default"]).startswith("raised:")
        assert "no CUDA device" in str(res["default"])
        assert str(res["cpu"]) == "cpu"


# -- collectives over four ranks, against the JAX eager forms on [4, ...] ----------

@pytest.fixture(scope="module")
def jgroup():
    name = "torch_parity"
    jcoll.init_collective_group(_jmesh(dp=4), axis="dp", group_name=name)
    yield name
    jcoll.destroy_collective_group(name)


@pytest.mark.parametrize("op", ["sum", "max", "min", "mean"])
def test_allreduce_matches_jax(world, jgroup, op):
    x = W.rand(0, 4, 3, 4)
    want = np.asarray(jcoll.allreduce(jnp.asarray(x), op, group_name=jgroup))
    i = _index("case_collectives")
    for r in range(4):
        got = world[r][i][f"allreduce_{op}"]
        if op in ("sum", "mean"):  # four fp32 terms, summed in any order
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


def test_allgather_broadcast_reducescatter_match_jax(world, jgroup):
    x = jnp.asarray(W.rand(0, 4, 3, 4))
    rs = jnp.asarray(W.rand(1, 4, 8, 3))
    ag = np.asarray(jcoll.allgather(x, group_name=jgroup))
    bc = np.asarray(jcoll.broadcast(x, src_rank=2, group_name=jgroup))
    red = np.asarray(jcoll.reducescatter(rs, "sum", group_name=jgroup))
    i = _index("case_collectives")
    for r in range(4):
        np.testing.assert_array_equal(world[r][i]["allgather"], ag)
        np.testing.assert_array_equal(world[r][i]["broadcast"], bc)
    np.testing.assert_allclose(
        np.concatenate([world[r][i]["reducescatter"] for r in range(4)]),
        red, rtol=1e-6)


def test_send_recv_reduce_gather_match_jax(world, jgroup):
    x = jnp.asarray(W.rand(0, 4, 3, 4))
    sr = np.asarray(jcoll.send_recv(x, 1, 3, group_name=jgroup))
    red = np.asarray(jcoll.reduce(x, 1, "sum", group_name=jgroup))
    gat = np.asarray(jcoll.gather(x, 0, group_name=jgroup))
    i = _index("case_collectives")
    for r in range(4):
        res = world[r][i]
        np.testing.assert_array_equal(res["send_recv"], sr[r])
        np.testing.assert_allclose(res["reduce"], red[r], rtol=1e-6)
        assert bool(res["gather_is_none"]) == (r != 0)
    np.testing.assert_array_equal(world[0][i]["gather"], gat)


@pytest.mark.parametrize("name", W.OPS)
def test_in_graph_ops_match_jax(world, name):
    """``collective.ops`` on each rank's row, against ``jax.lax`` inside
    ``shard_map`` over sp = 4: outputs and the gradient of sum(out * g)
    (pmax and pmin are not differentiated). The JAX body returns each
    rank's result as a row, so every output's spec mentions sp."""
    xs, gs = (jnp.asarray(a) for a in W.ops_inputs(4))
    jm = _jmesh(sp=4)
    lax_ops = types.SimpleNamespace(
        psum=jax.lax.psum, pmean=jax.lax.pmean, pmax=jax.lax.pmax,
        pmin=jax.lax.pmin, psum_scatter=jax.lax.psum_scatter,
        all_gather=jax.lax.all_gather, all_to_all=jax.lax.all_to_all,
        ppermute=jax.lax.ppermute,
        ring_permute=lambda x, a: jax.lax.ppermute(
            x, a, [(i, (i + 1) % 4) for i in range(4)]))

    def body(x):
        return W.apply_op(lax_ops, name, x[0], "sp")[None]

    fn = jax.jit(jsharding.smap(body, jm, in_specs=(JP("sp"),),
                                out_specs=JP("sp")))
    if name in ("pmax", "pmin"):  # not differentiable in JAX either
        out, vjp = fn(xs), None
    else:
        out, vjp = jax.vjp(fn, xs)
    i = _index("case_ops")
    for r in range(4):
        res = world[r][i]
        assert int(res["axis_index"]) == r
        _close(res[name], out[r], 1e-6)
    if vjp is None:
        return
    g = np.stack([np.resize(np.asarray(gs[r]), out.shape[1:])
                  for r in range(4)])
    (gx,) = vjp(jnp.asarray(g))
    for r in range(4):
        _close(world[r][i][name + "_grad"], gx[r], 1e-6)


# -- ring, ring-flash, Ulysses --------------------------------------------------------

def _qkvg(seed, shape):
    return [jnp.asarray(W.rand(seed + i, *shape)) for i in range(4)]


@pytest.mark.parametrize("mesh,shape,causal", RING)
def test_ring_einsum_matches_jax(world, mesh, shape, causal):
    """Output and q/k/v gradients of sum(out * g), every rank."""
    q, k, v, g = _qkvg(3, shape)
    jm = _jmesh(**mesh)

    def f(q, k, v):
        return j_ring_attention(q, k, v, jm, causal=causal, impl="einsum")

    out, vjp = jax.vjp(jax.jit(f), q, k, v)
    grads = vjp(g)
    i = _index("case_ring", mesh=mesh, causal=causal, impl=None)
    for r in range(4):
        res = world[r][i]
        _close(res["out"], out)
        for name, gj in zip(("dq", "dk", "dv"), grads):
            _close(res[name], gj)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_flash_matches_jax(world, causal):
    q, k, v, _ = _qkvg(3, (2, 2, 64, 16))
    want = j_ring_attention(q, k, v, _jmesh(sp=4), causal=causal,
                            impl="flash")
    i = _index("case_ring", causal=causal, impl="flash")
    for r in range(4):
        _close(world[r][i]["out"], want)


def test_ulysses_matches_jax(world):
    q, k, v, g = _qkvg(7, ULYSSES[1])
    jm = _jmesh(**ULYSSES[0])

    def f(q, k, v):
        return j_ulysses(q, k, v, jm, causal=True)

    out, vjp = jax.vjp(jax.jit(f), q, k, v)
    grads = vjp(g)
    i = _index("case_ulysses")
    for r in range(4):
        _close(world[r][i]["out"], out)
        for name, gj in zip(("dq", "dk", "dv"), grads):
            _close(world[r][i][name], gj)


# -- MoE ------------------------------------------------------------------------------

def _moe_kw():
    return dict(num_experts=MOE["experts"], top_k=MOE["top_k"],
                capacity_factor=MOE["capacity_factor"])


def test_moe_local_matches_jax():
    """ep=1 (no axis): routing, dispatch, output, aux and gradients."""
    x, rw, wi, wo = W.moe_inputs(4 * MOE["tokens"], MOE["model"],
                                 MOE["hidden"], MOE["experts"])
    jx = [jnp.asarray(a) for a in (x, rw, wi, wo)]
    jvals, jidx, _ = jmoe.router_topk(jx[0] @ jx[1], MOE["top_k"])
    tx = [torch.from_numpy(a).requires_grad_() for a in (x, rw, wi, wo)]
    tvals, tidx, _ = tmoe.router_topk(tx[0].detach() @ tx[1].detach(),
                                      MOE["top_k"])
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    for cap in (8, 24):
        jd, jc = jmoe._dispatch_mask(jidx, jvals, MOE["experts"], cap)
        td, tc = tmoe._dispatch_mask(tidx, tvals, MOE["experts"], cap)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        _close(tc.numpy(), jc)

    def jf(*a):
        y, aux = jmoe.moe_ffn_local(*a, axis_name=None, **_moe_kw())
        return jnp.sum(y * y) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3),
                                             has_aux=True)(*jx)
    ty, taux = tmoe.moe_ffn_local(*tx, axis_name=None, **_moe_kw())
    ((ty * ty).sum() + taux).backward()
    _close(ty.detach().numpy(), jy)
    _close(taux.detach().numpy(), jaux)
    for t, g in zip(tx, jg):
        _close(t.grad.numpy(), g)


def test_moe_expert_parallel_matches_jax(world):
    """ep=4: each rank's output, aux, choices, dispatch and gradients
    against the JAX body inside shard_map on the same tokens."""
    x, rw, wi, wo = (jnp.asarray(a) for a in W.moe_inputs(
        4 * MOE["tokens"], MOE["model"], MOE["hidden"], MOE["experts"]))
    jm = _jmesh(ep=4)
    def body(*a):
        y, aux = jmoe.moe_ffn_local(*a, axis_name="ep", **_moe_kw())
        return y, aux[None]

    fn = jax.jit(jsharding.smap(
        body, jm, in_specs=(JP("ep"), JP(), JP("ep"), JP("ep")),
        out_specs=(JP("ep"), JP("ep"))))
    (y, aux), vjp = jax.vjp(lambda x, wi, wo: fn(x, rw, wi, wo), x, wi, wo)
    gx, gwi, gwo = vjp((jnp.ones_like(y), jnp.zeros_like(aux)))
    i = _index("case_moe_ep")
    t = MOE["tokens"]
    e_local = MOE["experts"] // 4
    for r in range(4):
        res = world[r][i]
        rows = slice(r * t, (r + 1) * t)
        _close(res["y"], y[rows])
        _close(res["aux"], aux[r])
        _close(res["dx"], gx[rows])
        _close(res["dw_in"], gwi[r * e_local:(r + 1) * e_local])
        _close(res["dw_out"], gwo[r * e_local:(r + 1) * e_local])
        vals, idx, _ = jmoe.router_topk(x[rows] @ rw, MOE["top_k"])
        np.testing.assert_array_equal(res["gate_idx"], np.asarray(idx))
        cap = int(MOE["capacity_factor"] * t * MOE["top_k"]
                  / MOE["experts"])
        jd, _ = jmoe._dispatch_mask(idx, vals, MOE["experts"],
                                    -(-cap // 8) * 8)
        np.testing.assert_array_equal(res["dispatch"], np.asarray(jd))


# -- pipeline ---------------------------------------------------------------------------

def test_pipeline_matches_jax(world):
    ws, x, g = (jnp.asarray(a) for a in W.pipeline_inputs())
    jm = _jmesh(pp=4)

    def f(ws):
        return j_pipeline_apply(lambda w, xb: jnp.tanh(xb @ w), ws, x, jm,
                                params_spec=JP("pp"), data_spec=JP())

    out, vjp = jax.vjp(jax.jit(f), ws)
    (dws,) = vjp(g)
    i = _index("case_pipeline")
    for r in range(4):
        _close(world[r][i]["out"], out)
        _close(world[r][i]["dws"], dws)
