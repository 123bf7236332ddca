"""The port's multi-agent envs and sampler (``rllib/multi_agent.py``) and
contextual bandits (``rllib/bandit.py``) against the JAX package's.

``sample_multi_agent`` over ``make_multi_agent`` of a one-env CartPole
(three agents, two policies), with ``TorchPolicy`` on the JAX policies'
weights and seeds: each policy's batch holds the JAX run's actions,
observations, rewards and dones bit for bit, log-probabilities and values
within 1e-5 (the tolerance tests/test_torch_rllib_algos.py holds sampled
fragments to). ``run_bandit`` with LinUCB and LinTS on the same seeds
pulls the same arms and gets the same rewards and regrets, exactly (numpy
on both sides).
"""

import numpy as np
import pytest

import ray_tpu.rllib.bandit as jbandit
import ray_tpu.rllib.env as jenv
import ray_tpu.rllib.multi_agent as jma
import ray_tpu_torch.rllib.bandit as tbandit
import ray_tpu_torch.rllib.env as tenv
import ray_tpu_torch.rllib.multi_agent as tma
from ray_tpu.rllib.policy import JaxPolicy
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, DONES, LOGPS, OBS,
                                              REWARDS, VF_PREDS)

TOL = 1e-5  # log-probabilities and values of sampled fragments


@pytest.fixture(autouse=True)
def _full_fp32():
    with tdevice.full_fp32():
        yield


class OneCartPole:
    """One FastCartPole as a single-agent env (``reset``/``step``)."""

    def __init__(self, env_module, seed=0):
        self._env = env_module.FastCartPole(num_envs=1, seed=seed)

    def reset(self, seed=None):
        return self._env.vector_reset(seed=seed)[0]

    def step(self, action):
        obs, rew, done, _ = self._env.vector_step(np.array([action]))
        return obs[0], float(rew[0]), bool(done[0]), {}


def mapping(aid):
    return "a" if aid in ("agent_0", "agent_1") else "b"


def test_sample_multi_agent_matches_jax():
    jpol = {"a": JaxPolicy((4,), 2, seed=5), "b": JaxPolicy((4,), 2, seed=6)}
    tpol = {}
    for pid, jp in jpol.items():
        tp = TorchPolicy((4,), 2, seed=5 if pid == "a" else 6, device="cpu")
        tp.set_weights(jp.get_weights())
        tpol[pid] = tp
    out = []
    for ma, env_mod, pols in ((jma, jenv, jpol), (tma, tenv, tpol)):
        env_cls = ma.make_multi_agent(lambda: OneCartPole(env_mod),
                                      num_agents=3)
        out.append(ma.sample_multi_agent(env_cls(), pols, mapping,
                                         num_steps=150, seed=3))
    want, got = out
    assert set(got) == set(want) == {"a", "b"}
    for pid in want:
        assert set(got[pid]) == set(want[pid])
        for k in (ACTIONS, OBS, REWARDS, DONES):
            np.testing.assert_array_equal(got[pid][k], want[pid][k],
                                          err_msg=f"{pid} {k}")
        for k in (LOGPS, VF_PREDS):
            np.testing.assert_allclose(got[pid][k], want[pid][k], rtol=TOL,
                                       atol=TOL, err_msg=f"{pid} {k}")
    # Policy "a" serves two agents, "b" one; episodes ended and reset.
    assert len(got["a"][OBS]) > len(got["b"][OBS]) > 0
    assert got["a"][DONES].any()


class Recorder:
    """A bandit policy's arms and rewards, as run_bandit drives it."""

    def __init__(self, policy):
        self.policy, self.arms, self.rewards = policy, [], []

    def select_arm(self, context):
        arm = self.policy.select_arm(context)
        self.arms.append(arm)
        return arm

    def update(self, context, arm, reward):
        self.rewards.append(reward)
        self.policy.update(context, arm, reward)


@pytest.mark.parametrize("algo", ["LinUCB", "LinTS"])
def test_run_bandit_matches_jax(algo):
    kw = dict(alpha=1.0) if algo == "LinUCB" else dict(nu=0.3, seed=1)
    runs = []
    for mod in (jbandit, tbandit):
        rec = Recorder(getattr(mod, algo)(4, 8, **kw))
        env = mod.BanditEnv(num_arms=4, context_dim=8, noise=0.1, seed=1)
        runs.append((rec, mod.run_bandit(rec, env, steps=500)))
    (jrec, jout), (trec, tout) = runs
    assert trec.arms == jrec.arms and trec.rewards == jrec.rewards
    np.testing.assert_array_equal(tout["regret_curve"], jout["regret_curve"])
    assert tout["cumulative_regret"] == jout["cumulative_regret"]
    assert tout["final_window_regret"] == jout["final_window_regret"]
    # It learns: the last tenth's regret far below the first tenth's.
    curve = np.diff(tout["regret_curve"], prepend=0.0)
    assert curve[-50:].mean() < curve[:50].mean() / 2
