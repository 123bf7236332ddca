"""The port's Ape-X and ES/ARS (ray_tpu_torch.rllib.apex, .es) against the
JAX package's, and both on a real actor runtime.

Ape-X's worker priorities, ε ladder and replay shard, and ES's noise
table, centered ranks and flat parameter order are held against the JAX
package's on the same inputs; ES and ARS take one whole local iteration
from the JAX run's flat parameters. The remote test injects
``runtime=ray_tpu.core`` (the port imports no runtime) and runs under its
own time limit, so that a hung actor fails it and not the suite.
"""

import signal

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import ray_tpu as rt
import ray_tpu.core
import ray_tpu.core.runtime
from ray_tpu.rllib import apex as japex
from ray_tpu.rllib import es as jes
from ray_tpu.rllib.policy import JaxPolicy
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.models.convert import ravel_tree, unravel_tree
from ray_tpu_torch.rllib import (ARSConfig, ApexConfig, ApexDQN, ESConfig,
                                 SharedNoiseTable)
from ray_tpu_torch.rllib import apex as tapex
from ray_tpu_torch.rllib import es as tes

# Ape-X's initial priorities |Q(s, a) - target|, absolute: fp32 products
# of a (32, 32) Q-net in another order (measured: up to 1.2e-7).
TOL_PRIO = 1e-5
# ES/ARS flat parameters after one step from the same returns, relative to
# the largest (the gradient is numpy on both sides; measured: 0).
TOL_FLAT = 1e-6
LIMIT_S = 300  # the remote test's own limit


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


# -- Ape-X --------------------------------------------------------------------


def test_sample_with_priorities_matches_jax():
    """Ape-X's worker on CartPole (4 envs, ε 0.3) with the JAX worker's
    Q-net: two fragments of 16 steps bit-equal to the JAX worker's (the ε
    draws are numpy, the greedy actions an argmax) and their initial
    priorities within TOL_PRIO."""
    cfg = {"hidden": (32, 32)}
    jw = japex.ApexRolloutWorker("FastCartPole", 4, dict(cfg), seed=3)
    tw = tapex.ApexRolloutWorker("FastCartPole", 4, dict(cfg), seed=3)
    tw.set_weights(jw.get_weights())
    for w in (jw, tw):
        w.set_epsilon(0.3)
    for _ in range(2):
        jb, jp = jw.sample_with_priorities(16, 0.99)
        tb, tp = tw.sample_with_priorities(16, 0.99)
        assert set(tb) == set(jb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert tp.dtype == np.float32 and tp.shape == jp.shape
        assert np.abs(tp - jp).max() <= TOL_PRIO


def test_epsilon_ladder_and_config():
    """The per-worker ε ladder as the JAX package computes it in
    ``ApexDQN.setup``, and ``ApexConfig``'s defaults equal to JAX's."""
    for n in (1, 2, 3, 8):
        want = [float(0.4 ** (1.0 + (i / max(n - 1, 1)) * 7.0))
                for i in range(n)]
        assert tapex.epsilon_ladder(n, 0.4, 7.0) == want
    assert tapex.epsilon_ladder(2, 0.4, 7.0) == [0.4, 0.4 ** 8]
    j, t = japex.ApexConfig(), ApexConfig()
    for k in ("num_rollout_workers", "num_replay_shards",
              "worker_epsilon_base", "worker_epsilon_alpha",
              "weight_sync_period", "sample_wait_timeout",
              "num_updates_per_iter", "train_batch_size", "learning_starts",
              "prioritized_alpha", "prioritized_beta", "buffer_capacity",
              "target_network_update_freq", "policy_hidden"):
        assert getattr(t, k) == getattr(j, k), k


def test_replay_shard_matches_jax():
    """``ReplayShard``: the same adds, prioritized samples (indices,
    importance weights, rows), priority updates and stats as the JAX
    shard's, bit for bit."""
    rng = np.random.default_rng(8)
    shards = [japex.ReplayShard(64, 0.6, 5), tapex.ReplayShard(64, 0.6, 5)]
    assert shards[1].sample(4, 0.4) is None
    for _ in range(3):
        batch = {"obs": rng.normal(size=(24, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, 24).astype(np.int32),
                 "rewards": rng.normal(size=24).astype(np.float32)}
        prios = rng.random(24).astype(np.float32) + 0.1
        sizes = [s.add(dict(batch), prios.copy()) for s in shards]
        assert sizes[0] == sizes[1]
        out = [s.sample(16, 0.4) for s in shards]
        assert set(out[0]) == set(out[1])
        for k in out[0]:
            np.testing.assert_array_equal(out[1][k], out[0][k], err_msg=k)
        new = rng.random(16).astype(np.float32)
        for s, o in zip(shards, out):
            assert s.update_priorities(o["batch_indexes"], new) is True
    assert shards[0].stats() == shards[1].stats() == {
        "size": 64, "adds": 3, "samples": 3}


def test_apex_needs_a_runtime():
    """No local fallback: without ``runtime=`` ApexDQN raises, even with
    no rollout workers (its replay shards are actors)."""
    cfg = ApexConfig().rollouts(num_rollout_workers=0)
    with pytest.raises(ValueError, match="runtime="):
        cfg.build(device="cpu")


# -- ES / ARS -----------------------------------------------------------------


def test_noise_table_and_ranks_bit_equal():
    """``SharedNoiseTable`` (numpy's generator: the same table and index
    draws) and ``centered_ranks`` (ties, one and two entries) equal to the
    JAX package's."""
    j, t = jes.SharedNoiseTable(50_000, 7), SharedNoiseTable(50_000, 7)
    np.testing.assert_array_equal(t.noise, j.noise)
    assert t.noise.dtype == np.float32
    r1, r2 = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(5):
        i = t.sample_index(r1, 300)
        assert i == j.sample_index(r2, 300)
        np.testing.assert_array_equal(t.get(i, 300), j.get(i, 300))
    rng = np.random.default_rng(2)
    for x in (rng.normal(size=32), np.array([3.0, 1.0, 3.0, 2.0]),
              np.array([5.0]), np.array([1.0, 1.0])):
        np.testing.assert_array_equal(tes.centered_ranks(x),
                                      jes.centered_ranks(x))


@pytest.mark.parametrize("hidden", [(32, 32), (8,)])
def test_flat_order_matches_ravel_pytree(hidden):
    """``ravel_tree`` of the JAX policy's parameters is
    ``ravel_pytree``'s vector; ``unravel_tree`` gives the tree back; the
    port's ES worker, given JAX's weights, flattens to the same vector and
    perturbs the same parameters (one noise slice added, the weights it
    evaluates equal the JAX unravel's)."""
    jp = JaxPolicy((4,), 2, hidden=hidden, seed=1)
    want, unravel = ravel_pytree(jp.params)
    tree = jax.tree.map(np.asarray, jp.params)
    flat = ravel_tree(tree)
    np.testing.assert_array_equal(flat, np.asarray(want))
    back = unravel_tree(flat, tree)
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k])
    w = tes.ESEvalWorker("FastCartPole", {"hidden": hidden}, seed=1,
                         noise_size=10_000)
    w.policy.set_weights(tree)
    np.testing.assert_array_equal(w.flat_params(), np.asarray(want))
    moved = flat + 0.05 * w.noise.get(17, w.dim)
    got = unravel_tree(moved, w._like)
    for k, v in jax.tree.map(np.asarray, unravel(moved)).items():
        np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("algo", ["es", "ars"])
def test_es_training_step_matches_jax(monkeypatch, algo):
    """One local ``train()`` of ES and ARS (4 antithetic pairs, CartPole)
    from the JAX run's flat parameters: the same returns and env steps
    (greedy CartPole actions), and the flat parameters after the step
    within TOL_FLAT of JAX's."""
    monkeypatch.setattr(ray_tpu.core.runtime, "auto_init", lambda: None)
    jcls, tcls = ((jes.ESConfig, ESConfig) if algo == "es"
                  else (jes.ARSConfig, ARSConfig))

    def configure(cfg):
        return cfg.rollouts(num_rollout_workers=0).training(
            episodes_per_batch=4, noise_size=100_000)

    jalgo = configure(jcls()).build()
    talgo = configure(tcls()).build(device="cpu")
    assert talgo.dim == jalgo.dim
    talgo.set_state({"flat_params": jalgo.get_state()["flat_params"]})
    want, got = jalgo.train(), talgo.train()
    for k in ("timesteps_this_iter", "episodes_this_iter",
              "episode_reward_mean", "timesteps_total"):
        assert got[k] == want[k], k
    assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-6 * max(
        want["grad_norm"], 1e-6)
    t, j = talgo.get_state(), jalgo.get_state()
    assert np.abs(t["flat_params"] - j["flat_params"]).max() <= (
        TOL_FLAT * np.abs(j["flat_params"]).max())
    assert t["t"] == j["t"] == 1
    jalgo.stop()
    talgo.stop()


def test_es_needs_a_runtime_for_workers():
    with pytest.raises(ValueError, match="runtime="):
        ESConfig().build(device="cpu")  # 2 evaluation workers by default


# -- on the real runtime ------------------------------------------------------


def _on_alarm(signum, frame):
    raise TimeoutError(f"remote actors took over {LIMIT_S} s")


def test_apex_and_es_on_runtime():
    """Ape-X with 2 rollout workers and 2 replay shards on
    ``runtime=ray_tpu.core``: 3 iterations; adds, prioritized samples and
    priority updates flow as actor calls, the learner updates, each
    worker's ε is its rung of the ladder and, after a weight sync, its
    weights are the learner's. Then ES with 2 remote evaluation workers:
    one iteration of 2 x 2 pairs. The runtime is shut down in any case."""
    previous = signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(LIMIT_S)
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=4)
    try:
        cfg = (ApexConfig().environment("FastCartPole")
               .rollouts(num_rollout_workers=2, num_envs_per_worker=4,
                         rollout_fragment_length=16)
               .training(train_batch_size=32, learning_starts=0,
                         num_updates_per_iter=2, weight_sync_period=4))
        cfg.policy_hidden = (32, 32)
        algo = cfg.build(device="cpu", runtime=ray_tpu.core)
        try:
            assert isinstance(algo, ApexDQN)
            for _ in range(3):
                r = algo.train()
            assert r["num_learner_updates"] >= 2
            stats = r["replay_shards"]
            assert len(stats) == 2
            assert all(s["adds"] > 0 for s in stats), stats
            assert sum(s["samples"] for s in stats) > 0, stats
            assert r["replay_buffer_size"] > 0 and np.isfinite(r["loss"])
            eps = ray_tpu.core.get(
                [w.apply.remote(lambda wk: wk.policy.epsilon)
                 for w in algo.workers.remote_workers])
            assert eps == tapex.epsilon_ladder(2, 0.4, 7.0)
            want = algo.get_state()["params"]
            if r["num_learner_updates"] % 4 == 0:
                for w in algo.workers.remote_workers:
                    got = ray_tpu.core.get(w.get_weights.remote())
                    for k in want:
                        np.testing.assert_array_equal(got[k], want[k])
            assert all(p.device.type == "cpu" for p in algo.params.values())
        finally:
            algo.stop()
        es = (ESConfig().rollouts(num_rollout_workers=2)
              .training(episodes_per_batch=4, noise_size=100_000)
              .build(device="cpu", runtime=ray_tpu.core))
        try:
            r = es.train()
            assert r["episodes_this_iter"] == 8
            assert r["timesteps_this_iter"] >= 8
            assert np.isfinite(r["grad_norm"]) and es.evaluate(1) > 0
        finally:
            es.stop()
    finally:
        rt.shutdown()
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
