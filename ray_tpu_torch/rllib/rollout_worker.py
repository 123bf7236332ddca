"""RolloutWorker: counterpart of the JAX package's
``rllib/rollout_worker.py``.

Collects fixed-length time-major fragments from a vector env with the
current policy weights, which the learner syncs to it each iteration. The
worker's policy runs on the CPU, asked for explicitly: the learner owns
the card, as the JAX package's workers pin their JAX to the CPU.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional

import numpy as np

from .connectors import (ConnectorContext, create_connectors_for_policy,
                         restore_connectors_for_policy)
from .env import make_env
from .policy import TorchPolicy
from .sample_batch import (ACTIONS, DONES, LOGPS, OBS, REWARDS, STATE_IN,
                           VF_PREDS, SampleBatch)


class RolloutWorker:
    """Actor body, also used inline as the local worker."""

    def __init__(self, env_spec: Any, num_envs: int = 1,
                 policy_config: Optional[Dict] = None, seed: int = 0,
                 worker_index: int = 0):
        self.env = make_env(env_spec, num_envs, seed + worker_index * 1000)
        cfg = policy_config or {}
        # Connectors sit between env and policy: the policy is built for
        # the transformed observations, and the batch stores those (what
        # the policy saw).
        ctx = ConnectorContext.from_env(self.env, cfg)
        self._policy_cfg = cfg
        self.agent_connectors, self.action_connectors = \
            create_connectors_for_policy(ctx, cfg.get("connectors"))
        raw = self.env.vector_reset(seed=seed + worker_index * 1000)
        self._obs = self.agent_connectors(raw)
        self._connected_obs_shape = tuple(np.asarray(self._obs).shape[1:])
        self.policy = self._make_policy(cfg, seed + worker_index)
        self._episode_rewards = np.zeros(self.env.num_envs, np.float32)
        self._completed: list = []
        self.worker_index = worker_index

    def _make_policy(self, cfg: Dict, seed: int):
        """Subclass hook: the policy for this worker's env, on the CPU."""
        return TorchPolicy(
            self._connected_obs_shape, self.env.num_actions,
            hidden=cfg.get("hidden", (64, 64)), seed=seed,
            network=cfg.get("network", "auto"),
            model_config=cfg.get("model"), device="cpu")

    def apply(self, fn) -> Any:
        """Run ``fn(self)`` in the worker."""
        return fn(self)

    def _step_env(self, actions: np.ndarray):
        """One connected env step: action pipeline, env step, agent
        pipeline on (obs, rewards), episode bookkeeping. Returns
        (next_obs, rewards, dones, infos), transformed."""
        env_actions = self.action_connectors(actions)
        next_obs, rewards, dones, infos = self.env.vector_step(env_actions)
        self._episode_rewards += rewards
        for i in np.nonzero(dones)[0]:
            self._completed.append(float(self._episode_rewards[i]))
            self._episode_rewards[i] = 0.0
        self.agent_connectors.on_episode_done(dones)
        return (self.agent_connectors(next_obs),
                self.agent_connectors.transform_reward(rewards),
                dones, infos)

    def connector_state(self) -> Dict:
        """The pipelines, serialised, running statistics included, so that
        a restored run preprocesses as the saved one. A connector that
        cannot be serialised (a lambda) is left out with a warning."""
        state: Dict = {"agent": [], "action": []}
        for key, pipe in (("agent", self.agent_connectors),
                          ("action", self.action_connectors)):
            for c in pipe.connectors:
                try:
                    state[key].append(c.to_state())
                except Exception:
                    warnings.warn(
                        f"connector {type(c).__name__} is not "
                        "serializable; omitted from checkpoint — "
                        "re-add it in the config on restore")
        return state

    def restore_connector_state(self, state: Dict) -> None:
        ctx = ConnectorContext.from_env(self.env, self._policy_cfg)
        self.agent_connectors, self.action_connectors = \
            restore_connectors_for_policy(ctx, state)

    def set_weights(self, weights: Dict) -> None:
        self.policy.set_weights(weights)

    def get_weights(self) -> Dict:
        return self.policy.get_weights()

    def sample(self, rollout_length: int = 128) -> SampleBatch:
        """A [T, N, ...] fragment from the auto-resetting envs, with
        ``last_values`` [N], ``final_obs`` [N, ...] and, for recurrent
        policies, ``STATE_IN`` [S, N, cell]."""
        n = self.env.num_envs
        state_in = None
        if getattr(getattr(self.policy, "net", None), "is_recurrent",
                   False):
            # The behaviour policy's state at the fragment's start, so
            # that the learner's scan starts from the same state.
            state = self.policy.recurrent_state(n)
            state_in = np.stack([s.cpu().numpy() for s in state])
        # The env's observation dtype is kept: the conv policy divides
        # uint8 frames by 255, so float frames would be another function.
        obs_buf = np.empty((rollout_length, n) + self._connected_obs_shape,
                           np.asarray(self._obs).dtype)
        act_buf = np.empty((rollout_length, n), np.int32)
        logp_buf = np.empty((rollout_length, n), np.float32)
        vf_buf = np.empty((rollout_length, n), np.float32)
        rew_buf = np.empty((rollout_length, n), np.float32)
        done_buf = np.empty((rollout_length, n), bool)
        for t in range(rollout_length):
            actions, logp, values = self.policy.compute_actions(self._obs)
            obs_buf[t] = self._obs
            act_buf[t] = actions
            logp_buf[t] = logp
            vf_buf[t] = values
            next_obs, rewards, dones, _ = self._step_env(actions)
            rew_buf[t] = rewards
            done_buf[t] = dones
            observe = getattr(self.policy, "observe_dones", None)
            if observe is not None:
                observe(dones)
            self._obs = next_obs
        # The bootstrap values leave a recurrent state as it was: the next
        # fragment feeds this observation again.
        saved_state = (self.policy.recurrent_state(n)
                       if state_in is not None else None)
        _, _, last_values = self.policy.compute_actions(self._obs)
        if saved_state is not None:
            self.policy.set_recurrent_state(n, saved_state)
        batch = SampleBatch({
            OBS: obs_buf, ACTIONS: act_buf, LOGPS: logp_buf,
            VF_PREDS: vf_buf, REWARDS: rew_buf, DONES: done_buf,
        })
        if state_in is not None:
            batch[STATE_IN] = state_in
        batch["last_values"] = np.asarray(last_values, np.float32)
        # V-trace bootstraps V(x_T) under the learner's policy, so the
        # observation itself ships, not only the behaviour value.
        batch["final_obs"] = np.asarray(self._obs)
        return batch

    def episode_stats(self, clear: bool = True) -> Dict:
        eps = list(self._completed)
        if clear:
            self._completed = []
        return {
            "episodes": len(eps),
            "episode_reward_mean": float(np.mean(eps)) if eps else None,
            "episode_reward_max": float(np.max(eps)) if eps else None,
        }
