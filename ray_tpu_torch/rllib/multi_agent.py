"""A copy of the JAX package's ``rllib/multi_agent.py`` (numpy only),
kept here because the port imports nothing of that package. Its
docstring:

Multi-agent environments + sampling.

Reference analog: ``rllib/env/multi_agent_env.py`` — dict-keyed
observations/actions per agent id, episode end via ``done["__all__"]``,
``make_multi_agent`` turning any single-agent env into an N-agent one,
and per-POLICY sample collection with a ``policy_mapping_fn``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .sample_batch import (
    ACTIONS,
    DONES,
    LOGPS,
    OBS,
    REWARDS,
    VF_PREDS,
    SampleBatch,
)


class MultiAgentEnv:
    """Agents step together; each carries its own obs/reward stream."""

    def reset(self, seed: Optional[int] = None) -> Dict[str, Any]:
        raise NotImplementedError

    def step(self, actions: Dict[str, Any]):
        """-> (obs, rewards, dones, infos) dicts; dones["__all__"] ends
        the episode."""
        raise NotImplementedError


def make_multi_agent(env_maker: Callable[[], Any], num_agents: int = 2):
    """Wrap independent copies of a single-agent env as one multi-agent
    env (reference: ``make_multi_agent``, multi_agent_env.py)."""

    class _IndependentAgents(MultiAgentEnv):
        def __init__(self):
            self.agents = {f"agent_{i}": env_maker()
                           for i in range(num_agents)}
            self._done = {aid: False for aid in self.agents}

        def reset(self, seed=None):
            self._done = {aid: False for aid in self.agents}
            out = {}
            for i, (aid, env) in enumerate(self.agents.items()):
                obs = env.reset(seed=None if seed is None else seed + i)
                out[aid] = obs[0] if isinstance(obs, tuple) else obs
            return out

        def step(self, actions):
            obs, rews, dones, infos = {}, {}, {}, {}
            for aid, act in actions.items():
                if self._done[aid]:
                    continue
                o, r, d, info = self._step_one(self.agents[aid], act)
                obs[aid], rews[aid], dones[aid], infos[aid] = o, r, d, info
                self._done[aid] = d
            dones["__all__"] = all(self._done.values())
            return obs, rews, dones, infos

        @staticmethod
        def _step_one(env, act):
            out = env.step(act)
            if len(out) == 5:  # gymnasium: obs, r, terminated, trunc, info
                o, r, term, trunc, info = out
                return o, r, bool(term or trunc), info
            return out

    return _IndependentAgents


def sample_multi_agent(env: MultiAgentEnv,
                       policies: Dict[str, Any],
                       policy_mapping_fn: Callable[[str], str],
                       num_steps: int = 128,
                       seed: Optional[int] = None
                       ) -> Dict[str, SampleBatch]:
    """Collect per-POLICY batches from a multi-agent episode stream.

    Each agent's transitions route to ``policies[policy_mapping_fn(
    agent_id)]`` (reference: MultiAgentSampleBatchBuilder); auto-resets
    when ``done["__all__"]``. Policies expose ``compute_actions(obs) ->
    (actions, logps, values)`` over a batch (``TorchPolicy``'s interface).
    """
    buffers: Dict[str, Dict[str, list]] = {
        pid: {OBS: [], ACTIONS: [], LOGPS: [], VF_PREDS: [], REWARDS: [],
              DONES: []}
        for pid in policies
    }
    obs = env.reset(seed=seed)
    for _ in range(num_steps):
        actions: Dict[str, Any] = {}
        step_meta: Dict[str, tuple] = {}
        # Group live agents by policy for one batched forward per policy.
        by_policy: Dict[str, List[str]] = {}
        for aid in obs:
            by_policy.setdefault(policy_mapping_fn(aid), []).append(aid)
        for pid, aids in by_policy.items():
            stacked = np.stack([np.asarray(obs[a]) for a in aids])
            acts, logps, values = policies[pid].compute_actions(stacked)
            for i, aid in enumerate(aids):
                actions[aid] = acts[i]
                step_meta[aid] = (pid, obs[aid], acts[i], logps[i],
                                  values[i])
        next_obs, rewards, dones, _ = env.step(actions)
        for aid, (pid, o, a, lp, v) in step_meta.items():
            if aid not in rewards:
                continue
            buf = buffers[pid]
            buf[OBS].append(np.asarray(o))
            buf[ACTIONS].append(a)
            buf[LOGPS].append(lp)
            buf[VF_PREDS].append(v)
            buf[REWARDS].append(rewards[aid])
            buf[DONES].append(dones.get(aid, False))
        if dones.get("__all__"):
            obs = env.reset()
        else:
            obs = {aid: o for aid, o in next_obs.items()
                   if not dones.get(aid, False)}
    return {
        pid: SampleBatch({k: np.asarray(v) for k, v in buf.items()})
        for pid, buf in buffers.items() if buf[OBS]
    }
