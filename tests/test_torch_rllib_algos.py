"""Whole training iterations of the port's actor-based algorithms
(ray_tpu_torch.rllib) against the JAX package's, in local mode
(``num_rollout_workers=0``), and their checkpoints.

Each pair is built from the same config and seed; the port then takes the
JAX learner's parameters (``set_state``), so both sample with the same
weights, env seeds and keys. The sampled fragments are held bit for bit
(actions, observations, rewards, dones) and the float results within the
tolerance each test states.
"""

import jax
import numpy as np
import pytest
import torch

import ray_tpu.core.runtime
from ray_tpu.rllib import (A2CConfig as JA2C, APPOConfig as JAPPO,
                           DQNConfig as JDQN, ImpalaConfig as JImpala,
                           PPOConfig as JPPO)
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.rllib import (A2C, A2CConfig, APPOConfig, DQNConfig,
                                 ImpalaConfig, PPOConfig)
from ray_tpu_torch.rllib.algorithm import tree_map
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, DONES, LOGPS, OBS,
                                              REWARDS, STATE_IN, VF_PREDS)


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
    local mode never uses it, so these tests skip that start."""
    monkeypatch.setattr(ray_tpu.core.runtime, "auto_init", lambda: None)


LSTM = {"use_lstm": True, "lstm_cell_size": 16, "fcnet_hiddens": (32,)}


def _configure(cfg, case):
    """One small configuration per case, applied alike to both sides."""
    if case == "ppo":
        return (cfg.environment("FastCartPole")
                .rollouts(num_envs_per_worker=4, rollout_fragment_length=32)
                .training(sgd_minibatch_size=32, num_sgd_iter=2))
    if case == "ppo_lstm":
        return (cfg.environment("RepeatPrevObs")
                .rollouts(num_envs_per_worker=4, rollout_fragment_length=16)
                .training(sgd_minibatch_size=32, num_sgd_iter=2,
                          model=LSTM))
    if case == "a2c":
        return cfg.rollouts(num_envs_per_worker=4, rollout_fragment_length=16)
    if case in ("impala", "impala_lstm", "appo"):
        cfg = cfg.rollouts(num_envs_per_worker=4, rollout_fragment_length=16)
        cfg.training(num_batches_per_iter=2)
        if case == "impala_lstm":
            cfg.training(model=LSTM)
        return cfg
    assert case == "dqn"
    cfg.policy_hidden = (32, 32)
    return (cfg.rollouts(num_envs_per_worker=4, rollout_fragment_length=16)
            .training(learning_starts=48, num_updates_per_iter=4,
                      target_network_update_freq=3, train_batch_size=16))


CONFIGS = {"ppo": (JPPO, PPOConfig), "ppo_lstm": (JPPO, PPOConfig),
           "a2c": (JA2C, A2CConfig), "impala": (JImpala, ImpalaConfig),
           "impala_lstm": (JImpala, ImpalaConfig),
           "appo": (JAPPO, APPOConfig), "dqn": (JDQN, DQNConfig)}


def _pair(case):
    """(JAX algorithm, the port's on the CPU with the JAX parameters)."""
    jcls, tcls = CONFIGS[case]
    jalgo = _configure(jcls(), case).build()
    talgo = _configure(tcls(), case).build(device="cpu")
    state = jalgo.get_state()
    talgo.set_state({k: state[k] for k in ("params", "target_params")
                     if k in state})
    return jalgo, talgo


def _record_samples(worker):
    """Keep a copy of every fragment ``worker.sample`` returns."""
    seen = []
    sample = worker.sample

    def recorded(*args, **kwargs):
        batch = sample(*args, **kwargs)
        seen.append({k: np.array(v) for k, v in batch.items()})
        return batch

    worker.sample = recorded
    return seen


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.mark.parametrize("case", list(CONFIGS))
def test_train_iteration_matches_jax(case):
    """One ``train()`` of each algorithm from the same parameters: every
    fragment's actions, observations, rewards and dones equal the JAX
    run's, bit for bit; behaviour log-probabilities, values and the
    recurrent STATE_IN (fp32 results of either package) within 1e-5; the numeric results (losses, counts) within 1e-4
    relative; the learner's parameters after within 1e-4 of each leaf's
    largest entry."""
    jalgo, talgo = _pair(case)
    seen = [_record_samples(a.workers.local_worker) for a in (jalgo, talgo)]
    want, got = jalgo.train(), talgo.train()
    assert len(seen[0]) == len(seen[1]) > 0
    for jb, tb in zip(*seen):
        assert set(jb) == set(tb)
        for k in (ACTIONS, OBS, REWARDS, DONES, "next_obs"):
            if k in jb:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        for k in (LOGPS, VF_PREDS, "last_values", STATE_IN):
            if k in jb:
                np.testing.assert_allclose(tb[k], jb[k], rtol=1e-5,
                                           atol=1e-5, err_msg=k)
    assert set(got) == set(want)
    for k, v in want.items():
        if k in ("time_this_iter_s", "env_steps_per_sec"):
            continue
        if isinstance(v, (int, float)):
            assert abs(got[k] - v) <= 1e-4 * max(abs(v), 1e-3), (k, got[k], v)
        else:
            assert got[k] == v, k
    wparams = jax.tree.map(np.asarray, jalgo.params)
    gparams = talgo.get_state()["params"]
    assert set(gparams) == set(wparams)
    for name, p in gparams.items():
        assert _rel(p, wparams[name]) < 1e-4, name
    jalgo.stop()
    talgo.stop()


@pytest.mark.parametrize("case", ["ppo", "a2c", "dqn"])
def test_save_restore(case, tmp_path):
    """``save`` then ``restore`` into a fresh build: the learner's and
    the worker's weights bit-equal, the iteration count kept (A2C's
    optimizer state bit-equal too)."""
    _, tcls = CONFIGS[case]
    algo = _configure(tcls(), case).build(device="cpu")
    algo.train()
    path = algo.save(str(tmp_path))
    fresh = _configure(tcls(), case).build(device="cpu")
    fresh.restore(path)
    assert fresh.iteration == 1
    for a, b in ((algo.get_state()["params"], fresh.get_state()["params"]),
                 (algo.workers.local_worker.get_weights(),
                  fresh.workers.local_worker.get_weights())):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    if case == "a2c":  # its optimizer state is saved too
        saved, restored = ([], [])
        tree_map(saved.append, algo.opt_state)
        tree_map(restored.append, fresh.opt_state)
        assert len(saved) == len(restored) == 2 * len(algo.params) + 1
        for a, b in zip(saved, restored):
            assert torch.equal(a, b)
    algo.stop()
    fresh.stop()


def test_as_trainable_reports_each_iteration():
    """``as_trainable`` runs ``stop_iters`` iterations with the tune
    config's overrides and hands each result to the given ``report``."""
    reports = []
    fn = A2C.as_trainable(_configure(A2CConfig(), "a2c"), reports.append,
                          stop_iters=2, device="cpu")
    fn({"lr": 5e-4})
    assert [r["training_iteration"] for r in reports] == [1, 2]
    assert reports[-1]["timesteps_total"] == 2 * 4 * 16
    assert all(np.isfinite(r["total_loss"]) for r in reports)


def test_compute_single_action_and_learner_device():
    """The learner's parameters and optimizer state are on the device it
    was built for, the worker's policy on the CPU; a single deterministic
    action is an int in range."""
    algo = _configure(PPOConfig(), "ppo").build(device="cpu")
    assert all(p.device.type == "cpu" and p.requires_grad
               for p in algo.params.values())
    assert algo.workers.local_worker.policy.device.type == "cpu"
    a = algo.compute_single_action(np.zeros(4, np.float32))
    assert isinstance(a, int) and 0 <= a < 2
    algo.stop()
