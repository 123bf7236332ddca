"""The port's Gaussian draws, SAC and TD3 (ray_tpu_torch) against the JAX
package's (ray_tpu.rllib.sac, .td3).

``random.normal`` draws JAX's uniforms bit for bit but takes
``torch.erfinv`` of them, not XLA's fp32 ``erf_inv``; ``tanh`` and ``exp``
differ from XLA's in the last bit too. So the continuous-action draws,
actions and log-probabilities are held within a stated tolerance, not bit
for bit. The learner tests give both learners the same parameters (the
JAX package's, carried by ``set_state``), the same numpy-seeded batches
and the same keys; the whole-iteration tests fill both replay buffers
with the same transitions and hold the replay indices bit for bit. fp32
products at IEEE fp32 (``full_fp32``) throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.core.runtime
from ray_tpu.rllib import sac as jsac
from ray_tpu.rllib import td3 as jtd3
from ray_tpu_torch import device as tdevice
from ray_tpu_torch import random as trandom
from ray_tpu_torch.models.convert import rl_tree_from_numpy, rl_tree_to_numpy
from ray_tpu_torch.rllib import sac as tsac
from ray_tpu_torch.rllib import td3 as ttd3
from ray_tpu_torch.rllib.algorithm import batch_to
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, DONES, NEXT_OBS, OBS,
                                              REWARDS, SampleBatch)

# random.normal against jax.random.normal: |difference| over max(|draw|, 1)
# (measured on 10**6 draws: 5.8e-6; the uniforms are bit-equal).
TOL_NORMAL = 1e-5
# Actions (and a SAC fragment's columns) and log-probabilities of a draw,
# absolute: the normal's error times std and the action scale, plus
# tanh's and exp's last bits (measured: 4.8e-7 and 1.6e-5).
TOL_ACTION = 1e-5
TOL_LOGP = 1e-4
# Networks without a draw (actor_dist, _q, deterministic_action): fp32
# sums in another order and tanh's last bit, relative to the largest
# |value| (measured: up to 1.7e-6).
TOL_NET = 1e-5
# Losses and metrics of updates, relative (measured: up to 2.2e-7).
TOL_LOSS = 1e-5
# Parameters after updates: the L2 norm of the difference over all of a
# tree's leaves over the tree's norm (measured: up to 9.4e-8). Adam's
# first steps move an element by about lr whatever its gradient's size,
# so an element whose gradient is near zero may step differently in the
# two packages: a per-element bound would not hold.
TOL_PARAMS = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _full_fp32():
    with tdevice.full_fp32():
        yield


@pytest.fixture(autouse=True)
def _no_runtime(monkeypatch):
    """The JAX package's Algorithm starts its actor runtime when built;
    local mode never uses it."""
    monkeypatch.setattr(ray_tpu.core.runtime, "auto_init", lambda: None)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _tree_rel(got, want) -> float:
    """L2 of the difference over all leaves / L2 of ``want``."""
    g = np.concatenate([np.ravel(x) for x in jax.tree.leaves(got)])
    w = np.concatenate([np.ravel(x) for x in jax.tree.leaves(want)])
    return float(np.linalg.norm(g.astype(np.float64) - w)
                 / max(np.linalg.norm(w.astype(np.float64)), 1e-30))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(rng, n, obs_dim=3, adim=1):
    return {OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
            ACTIONS: rng.uniform(-2, 2, (n, adim)).astype(np.float32),
            REWARDS: rng.normal(size=n).astype(np.float32),
            NEXT_OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
            DONES: rng.random(n) < 0.1}


@pytest.mark.parametrize("seed,shape", [(0, (7,)), (1, (3, 5)),
                                        (2, (4000,)), (-3, (2, 64, 3))])
def test_normal_matches_jax(seed, shape):
    """``random.normal``: the uniforms under it bit-equal to JAX's, the
    normals within TOL_NORMAL of max(|draw|, 1); also from a split key."""
    key_j, key_t = jax.random.PRNGKey(seed), trandom.prng_key(seed)
    for _ in range(2):
        want = np.asarray(jax.random.normal(key_j, shape))
        got = trandom.normal(key_t, shape).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        assert err.max() <= TOL_NORMAL, err.max()
        lo = np.nextafter(np.float32(-1), np.float32(0))
        np.testing.assert_array_equal(
            trandom.uniform(key_t, shape, minval=lo, maxval=1.0).numpy(),
            np.asarray(jax.random.uniform(key_j, shape, minval=lo,
                                          maxval=1.0)))
        key_j = jax.random.split(key_j)[1]
        key_t = trandom.take(trandom.split(key_t), 1)


def _sac_trees(adim=2, hidden=(32, 32)):
    jparams = jsac.init_sac_params(jax.random.PRNGKey(0), 3, adim, hidden)
    return jparams, rl_tree_from_numpy(_np_tree(jparams))


def test_sac_networks_match_jax():
    """``actor_dist`` and ``_q`` within TOL_NET; ``sample_action``'s
    action and logp within TOL_ACTION/TOL_LOGP for several keys, the
    affine rescale of [-2, 2] and of [0, 1]; ``init_sac_params``' tree has
    the JAX tree's names and shapes."""
    jparams, tparams = _sac_trees()
    assert jax.tree.structure(_np_tree(jparams)) == jax.tree.structure(
        rl_tree_to_numpy(tsac.init_sac_params(
            torch.Generator().manual_seed(0), 3, 2, (32, 32))))
    obs = np.random.default_rng(0).normal(size=(256, 3)).astype(np.float32)
    jm, js = jsac.actor_dist(jparams["actor"], jnp.asarray(obs), 2)
    tm, ts = tsac.actor_dist(tparams["actor"], torch.from_numpy(obs), 2)
    assert _rel(tm, jm) < TOL_NET and _rel(ts, js) < TOL_NET
    act = np.random.default_rng(1).uniform(-2, 2, (256, 2)).astype(
        np.float32)
    assert _rel(tsac._q(tparams["q1"], torch.from_numpy(obs),
                        torch.from_numpy(act)),
                jsac._q(jparams["q1"], jnp.asarray(obs),
                        jnp.asarray(act))) < TOL_NET
    for seed, (low, high) in [(3, (-2.0, 2.0)), (4, (0.0, 1.0)),
                              (5, (-2.0, 2.0))]:
        ja, jl = jsac.sample_action(jparams["actor"], jnp.asarray(obs),
                                    jax.random.PRNGKey(seed), 2, low, high)
        ta, tl = tsac.sample_action(tparams["actor"], torch.from_numpy(obs),
                                    trandom.prng_key(seed), 2, low, high)
        assert np.abs(ta.numpy() - np.asarray(ja)).max() <= TOL_ACTION
        assert np.abs(tl.numpy() - np.asarray(jl)).max() <= TOL_LOGP


def test_td3_deterministic_action_matches_jax():
    jparams = jtd3.init_td3_params(jax.random.PRNGKey(1), 3, 1, (32, 32))
    tparams = rl_tree_from_numpy(_np_tree(jparams))
    obs = np.random.default_rng(2).normal(size=(128, 3)).astype(np.float32)
    assert _rel(ttd3.deterministic_action(tparams["actor"],
                                          torch.from_numpy(obs), -2.0, 2.0),
                jtd3.deterministic_action(jparams["actor"], jnp.asarray(obs),
                                          -2.0, 2.0)) < TOL_NET


def _small(cfg, **training):
    cfg.policy_hidden = (32, 32)
    return cfg.rollouts(num_envs_per_worker=4, rollout_fragment_length=8) \
        .training(train_batch_size=32, **training)


def _pair(jcfg, tcfg):
    """(JAX algorithm, the port's on the CPU with the JAX parameters)."""
    jalgo, talgo = jcfg.build(), tcfg.build(device="cpu")
    talgo.set_state({"params": jalgo.get_state()["params"]})
    return jalgo, talgo


def test_sac_update_matches_jax():
    """One SAC update from the same parameters, batch and key (and
    initial_alpha 0.5, so alpha is not 1): its losses, alpha and entropy
    within TOL_LOSS, every parameter after it (actor, critics, log_alpha
    and the polyak targets) within TOL_PARAMS; the targets moved by
    exactly tau toward the critics."""
    jalgo, talgo = _pair(_small(jsac.SACConfig(), initial_alpha=0.5),
                         _small(tsac.SACConfig(), initial_alpha=0.5))
    np.testing.assert_array_equal(
        talgo.get_state()["params"]["log_alpha"],
        np.asarray(jalgo.params["log_alpha"]))
    batch = _batch(np.random.default_rng(3), 64)
    jparams, jopt, jaux = jalgo._update(
        jalgo.params, jalgo.opt_state,
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(9))
    tparams, _, taux = talgo._update(talgo.params, talgo.opt_state,
                                     batch_to(batch, "cpu"),
                                     trandom.prng_key(9))
    for k in ("critic_loss", "actor_loss", "alpha", "entropy"):
        assert _rel(taux[k], jaux[k]) < TOL_LOSS, k
    got, want = rl_tree_to_numpy(tparams), _np_tree(jparams)
    assert set(got) == set(want)
    for k in want:
        assert _tree_rel(got[k], want[k]) < TOL_PARAMS, k


@pytest.mark.parametrize("order", [(True, False), (False, True)])
def test_td3_updates_match_jax(order):
    """Two TD3 updates (with and without the delayed actor step, in either
    order) from the same parameters, batches and keys: the critic and
    actor losses within TOL_LOSS (the actor's 0 on a critic-only step),
    every parameter within TOL_PARAMS; on a critic-only step the actor
    and every target are unchanged, bit for bit."""
    jalgo, talgo = _pair(_small(jtd3.TD3Config()), _small(ttd3.TD3Config()))
    rng = np.random.default_rng(4)
    jstate = (jalgo.params, jalgo.opt_state)
    tstate = (talgo.params, talgo.opt_state)
    for i, do_actor in enumerate(order):
        batch = _batch(rng, 48)
        before = rl_tree_to_numpy(tstate[0])
        jp, jo, jaux = jalgo._update(*jstate, {k: jnp.asarray(v) for k, v in
                                               batch.items()},
                                     jax.random.PRNGKey(20 + i),
                                     jnp.asarray(do_actor))
        tp, to, taux = talgo._update(*tstate, batch_to(batch, "cpu"),
                                     trandom.prng_key(20 + i), do_actor)
        jstate, tstate = (jp, jo), (tp, to)
        assert _rel(taux["critic_loss"], jaux["critic_loss"]) < TOL_LOSS
        if do_actor:
            assert _rel(taux["actor_loss"], jaux["actor_loss"]) < TOL_LOSS
        else:
            assert float(taux["actor_loss"]) == float(jaux["actor_loss"]) == 0
            after = rl_tree_to_numpy(tp)
            for k in ("actor", "target_actor", "target_q1", "target_q2"):
                for name in after[k]:
                    np.testing.assert_array_equal(after[k][name],
                                                  before[k][name])
        got, want = rl_tree_to_numpy(tp), _np_tree(jp)
        for k in want:
            assert _tree_rel(got[k], want[k]) < TOL_PARAMS, (i, k)


def _record_indices(buffer):
    """Keep a copy of every index draw of ``buffer``'s generator."""
    seen, rng = [], buffer._rng

    class Recording:
        def integers(self, *args, **kwargs):
            out = rng.integers(*args, **kwargs)
            seen.append(np.array(out))
            return out

    buffer._rng = Recording()
    return seen


def _fill(algos, n, adim=1):
    """The same ``n`` random transitions into each algorithm's buffer."""
    cols = _batch(np.random.default_rng(5), n, adim=adim)
    for a in algos:
        a.buffer.add(SampleBatch({k: v.copy() for k, v in cols.items()}))


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_training_step_matches_jax(algo):
    """A whole ``train()`` after ``learning_starts`` from the same replay
    contents and parameters: the fragment sampled first (SAC: within
    TOL_ACTION, its draws; TD3: bit-equal, the uniform warm-up), every
    replay index bit-equal, the metrics within TOL_LOSS, the learner's
    parameters within TOL_PARAMS per tree, and the workers' new weights
    equal to the learner's."""
    mods = {"sac": (jsac.SACConfig, tsac.SACConfig),
            "td3": (jtd3.TD3Config, ttd3.TD3Config)}[algo]
    kw = dict(learning_starts=64, num_updates_per_iter=4)
    jalgo, talgo = _pair(_small(mods[0](), **kw), _small(mods[1](), **kw))
    _fill((jalgo, talgo), 96)
    seen = [_record_indices(a.buffer) for a in (jalgo, talgo)]
    want, got = jalgo.train(), talgo.train()
    assert len(seen[0]) == len(seen[1]) == 4
    for a, b in zip(*seen):
        np.testing.assert_array_equal(b, a)
    n = 4 * 8  # the fragment, after the 96 rows both buffers were given
    for k in (OBS, ACTIONS, REWARDS, NEXT_OBS, DONES):
        jcol, tcol = (a.buffer._cols[k][96:96 + n] for a in (jalgo, talgo))
        if algo == "td3":
            np.testing.assert_array_equal(tcol, jcol, err_msg=k)
        else:
            np.testing.assert_allclose(tcol, jcol, rtol=0, atol=TOL_ACTION,
                                       err_msg=k)
    for k in ("timesteps_this_iter", "num_learner_updates",
              "replay_buffer_size"):
        assert got[k] == want[k], k
    for k in ("critic_loss", "actor_loss", "alpha", "entropy"):
        if k in want:
            assert _rel(got[k], want[k]) < TOL_LOSS, k
    gp, wp = talgo.get_state()["params"], _np_tree(jalgo.params)
    for k in wp:
        assert _tree_rel(gp[k], wp[k]) < TOL_PARAMS, k
    wk = talgo.workers.local_worker.get_weights()
    for name, v in gp["actor"].items():
        np.testing.assert_array_equal(wk["actor"][name], v)
    jalgo.stop()
    talgo.stop()


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_save_restore(algo, tmp_path):
    """``save`` then ``restore`` into a fresh build: the learner's
    parameters, the Adam state, the key, the update count (TD3: the end
    of the warm-up too) bit-equal, the worker's actor the learner's."""
    cls = {"sac": tsac.SACConfig, "td3": ttd3.TD3Config}[algo]
    kw = dict(learning_starts=32, num_updates_per_iter=3)
    a = _small(cls(), **kw).build(device="cpu")
    a.train()
    path = a.save(str(tmp_path))
    b = _small(cls(), **kw).build(device="cpu")
    b.restore(path)
    sa, sb = a.get_state(), b.get_state()
    assert sb["num_updates"] == sa["num_updates"] == 3
    np.testing.assert_array_equal(sb["rng_key"], sa["rng_key"])
    for x, y in zip(jax.tree.leaves(sa["params"]),
                    jax.tree.leaves(sb["params"])):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(jax.tree.leaves(sa["opt_state"]),
                    jax.tree.leaves(sb["opt_state"])):
        np.testing.assert_array_equal(x, y)
    wk = b.workers.local_worker.get_weights()["actor"]
    for k, v in sb["params"]["actor"].items():
        np.testing.assert_array_equal(wk[k], v)
    if algo == "td3":
        assert b._warmup_done
        assert not b.workers.local_worker.policy.random_phase
    a.stop()
    b.stop()
