"""The port's external envs and policy server (``rllib/external.py``)
against the JAX package's.

The cases of tests/test_external_env.py and the slot-stateful refusal of
tests/test_connectors.py run through both packages (each with its own
``ExternalEnv``, workers and ``FastCartPole``). With the port's Q weights
carried into the JAX worker and a simulator that runs one episode at a
time, the first transition rows of the two workers are equal, greedy and
at ε 0.3 (both draw ε from ``default_rng(seed + 1)``). Each package's
``PolicyClient`` drives the other's ``PolicyServerInput`` over HTTP on
localhost (the same pickled wire format), and DQN takes two iterations on
``ExternalDQNWorker`` on the CPU. Every simulator and client thread is
joined with a timeout, every server shut down in a ``finally``, and each
test has its own limit (``torch_time_limit``).
"""

import threading
import types

import numpy as np
import pytest

import ray_tpu.rllib.env as jenv
import ray_tpu.rllib.external as jext
import ray_tpu_torch.rllib.env as tenv
import ray_tpu_torch.rllib.external as text
from ray_tpu_torch.rllib import DQN, DQNConfig
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, DONES, NEXT_OBS, OBS,
                                              REWARDS)
from torch_time_limit import time_limit

LIMIT_S = 120  # each test's own limit
JOIN_S = 30    # a thread's
PACKAGES = {"jax": types.SimpleNamespace(ext=jext, env=jenv),
            "port": types.SimpleNamespace(ext=text, env=tenv)}

_limit = time_limit(LIMIT_S)


def cartpole_external(pkg, episodes=50, off_policy_every=0):
    """The simulator of tests/test_external_env.py on ``pkg``'s classes: it
    owns the loop, one episode at a time, and queries the policy."""

    class CartPoleExternal(pkg.ext.ExternalEnv):
        def __init__(self):
            super().__init__(obs_shape=(4,), num_actions=2)
            self._sim = pkg.env.FastCartPole(num_envs=1, seed=7)

        def run(self):
            for _ in range(episodes):
                eid = self.start_episode()
                obs = self._sim.vector_reset()[0]
                done, steps = False, 0
                while not done and steps < 200:
                    if off_policy_every and steps % off_policy_every == 1:
                        action = 0
                        self.log_action(eid, obs, action)
                    else:
                        action = self.get_action(eid, obs)
                    nobs, rew, dones, _ = self._sim.vector_step(
                        np.array([action]))
                    self.log_returns(eid, float(rew[0]))
                    obs, done = nobs[0], bool(dones[0])
                    steps += 1
                self.end_episode(eid, obs)

    return CartPoleExternal()


def assert_chained(batch):
    """Within an episode the rows chain: next_obs[t] == obs[t+1]."""
    n = len(batch[OBS])
    for t in range(n - 1):
        if not batch[DONES][t]:
            np.testing.assert_array_equal(batch[NEXT_OBS][t],
                                          batch[OBS][t + 1])


@pytest.mark.parametrize("name", list(PACKAGES))
def test_worker_collects_coherent_transitions(name):
    pkg = PACKAGES[name]
    worker = pkg.ext.ExternalEnvWorker(
        lambda: cartpole_external(pkg, episodes=200))
    batch = worker.sample(rollout_length=64)
    n = len(batch[OBS])
    assert n >= 64
    assert batch[OBS].shape == batch[NEXT_OBS].shape == (n, 4)
    assert batch[ACTIONS].shape == (n,)
    assert set(np.unique(batch[ACTIONS])) <= {0, 1}
    assert np.all(batch[REWARDS] >= 0.0)
    assert_chained(batch)
    assert worker.episode_stats()["episodes"] >= 0


@pytest.mark.parametrize("name", list(PACKAGES))
def test_off_policy_log_action(name):
    pkg = PACKAGES[name]
    worker = pkg.ext.ExternalEnvWorker(
        lambda: cartpole_external(pkg, episodes=100, off_policy_every=3))
    batch = worker.sample(rollout_length=48)
    assert len(batch[OBS]) >= 48
    assert_chained(batch)


@pytest.mark.parametrize("name", list(PACKAGES))
def test_episode_errors(name):
    env = cartpole_external(PACKAGES[name], episodes=1)
    env.start_episode("ep1")
    with pytest.raises(ValueError):
        env.start_episode("ep1")  # duplicate
    env.log_returns("ep1", 1.0)
    env.end_episode("ep1", np.zeros(4))
    with pytest.raises(ValueError):
        env.log_returns("ep1", 1.0)  # finished
    with pytest.raises(ValueError):
        env.get_action("nope", np.zeros(4))


def drive_client(client, sim, episodes, steps=100):
    """A client thread's loop: ``episodes`` episodes of ``sim`` through
    ``client``; returns (thread, done event, failures, episode ends)."""
    done, failures, ends = threading.Event(), [], []

    def run():
        try:
            for _ in range(episodes):
                eid = client.start_episode()
                obs = sim.vector_reset()[0]
                over, n = False, 0
                while not over and n < steps:
                    a = client.get_action(eid, obs)
                    assert a in (0, 1)
                    nobs, rew, dones, _ = sim.vector_step(np.array([a]))
                    client.log_returns(eid, float(rew[0]))
                    obs, over = nobs[0], bool(dones[0])
                    n += 1
                client.end_episode(eid, obs)
                ends.append(eid)
        except Exception as e:  # noqa: BLE001 — reported by the test
            failures.append(e)
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, done, failures, ends


def pump_until(worker, done):
    """Answer the clients' actions until their loop has ended."""
    while not done.is_set():
        try:
            worker.sample(rollout_length=8, timeout_s=2.0)
        except TimeoutError:
            pass


# (server package, client package): each alone, then across.
PAIRS = [("jax", "jax"), ("port", "port"), ("port", "jax"), ("jax", "port")]


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS)
def test_policy_server_client_round_trip(server_pkg, client_pkg):
    srv, cli = PACKAGES[server_pkg], PACKAGES[client_pkg]
    server = srv.ext.PolicyServerInput(obs_shape=(4,), num_actions=2, port=0)
    try:
        worker = srv.ext.ExternalDQNWorker(server)
        worker.set_epsilon(0.3)
        client = cli.ext.PolicyClient(server.address, timeout_s=JOIN_S)
        t, done, failures, ends = drive_client(
            client, cli.env.FastCartPole(num_envs=1, seed=3), episodes=30)
        batch = worker.sample(rollout_length=64)
        assert len(batch[OBS]) >= 64
        assert batch[DONES].dtype == bool
        assert_chained(batch)
        pump_until(worker, done)
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
        assert not failures, failures
        assert len(ends) == 30
        with pytest.raises(RuntimeError, match="not found"):
            client.log_returns("missing-episode", 1.0)
    finally:
        server.shutdown()


@pytest.mark.parametrize("name", list(PACKAGES))
def test_external_env_rejects_slot_stateful_and_probes_shape(name):
    ext = PACKAGES[name].ext
    stop = threading.Event()

    class Dummy(ext.ExternalEnv):
        def __init__(self):
            super().__init__(obs_shape=(4,), num_actions=2)

        def run(self):
            stop.wait(JOIN_S)

    try:
        with pytest.raises(ValueError, match="slot-stateful"):
            ext.ExternalEnvWorker(Dummy(), policy_config={
                "connectors": {"agent": [("FrameStack", {"k": 4})]}})
        # MeanStdObs is fine, the probe leaves its statistics alone, and
        # the policy's input follows the transformed shape.
        w = ext.ExternalEnvWorker(Dummy(), policy_config={
            "connectors": {"agent": ["MeanStdObs"]}})
        assert w._connected_obs_shape == (4,)
        assert w.agent_connectors.connectors[0].count == 0
    finally:
        stop.set()


@pytest.mark.parametrize("epsilon", [0.0, 0.3])
def test_carried_q_weights_give_the_same_rows(epsilon):
    """The port's ExternalDQNWorker and the JAX one, the port's initial
    Q weights in both, one simulator episode at a time: the first rows
    are equal."""
    n = 96
    port = text.ExternalDQNWorker(
        lambda: cartpole_external(PACKAGES["port"], episodes=40), seed=3)
    jax_w = jext.ExternalDQNWorker(
        lambda: cartpole_external(PACKAGES["jax"], episodes=40), seed=3)
    jax_w.set_weights(port.get_weights())
    for w in (port, jax_w):
        w.set_epsilon(epsilon)
    got, want = port.sample(rollout_length=n), jax_w.sample(rollout_length=n)
    for key in (OBS, ACTIONS, REWARDS, NEXT_OBS, DONES):
        np.testing.assert_array_equal(got[key][:n], want[key][:n], key)
    assert got[DONES][:n].any()  # episodes ended inside the window


def test_dqn_on_external_worker_learns_on_the_cpu():
    class ExternalDQN(DQN):
        _worker_cls = text.ExternalDQNWorker

    cfg = (DQNConfig()
           .environment(lambda: cartpole_external(PACKAGES["port"],
                                                  episodes=500))
           .rollouts(rollout_fragment_length=64)
           .training(learning_starts=64, num_updates_per_iter=4,
                     train_batch_size=32)
           .debugging(seed=0))
    algo = ExternalDQN(cfg, device="cpu")
    start = {k: v.detach().clone() for k, v in algo.params.items()}
    results = [algo.train() for _ in range(2)]
    assert all(np.isfinite(r["loss"]) for r in results)
    assert all(r["timesteps_this_iter"] >= 64 for r in results)
    assert any(not np.array_equal(start[k].numpy(), v.detach().numpy())
               for k, v in algo.params.items())
    assert all(v.device.type == "cpu" for v in algo.params.values())
    # The worker acts with the learner's weights.
    w = algo.workers.local_worker.get_weights()
    np.testing.assert_array_equal(w["q_w"],
                                  algo.params["q_w"].detach().numpy())
