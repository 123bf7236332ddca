"""DQN: counterpart of the JAX package's ``rllib/dqn.py``.

Double DQN with a Huber TD loss, prioritized replay and a target network.
Rollout workers act ε-greedily on the CPU (the ε draws and the replay
sampling are numpy generators seeded as the JAX package seeds them); the
update runs on the learner's device, and its |TD errors| go back to the
sum-tree's priorities.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import default_device
from ..models.common import truncated_normal
from ..models.convert import ppo_params_from_numpy, ppo_tree_to_numpy
from ..train.optim import adam
from .algorithm import (Algorithm, AlgorithmConfig, batch_to, copy_into,
                        sgd_step, to_learner)
from .policy import Params
from .replay_buffers import PrioritizedReplayBuffer, ReplayBuffer
from .rollout_worker import RolloutWorker
from .sample_batch import (ACTIONS, DONES, NEXT_OBS, OBS, REWARDS,
                           SampleBatch)


def init_q_net(generator: Optional[torch.Generator], obs_dim: int,
               num_actions: int, hidden: Sequence[int] = (256, 256)
               ) -> Params:
    """ReLU MLP ``t<i>_w``/``t<i>_b`` to a Q head ``q_w``/``q_b``."""
    params: Params = {}
    sizes = [obs_dim] + list(hidden)
    for i in range(len(sizes) - 1):
        std = float(np.sqrt(2.0 / sizes[i]))
        params[f"t{i}_w"] = truncated_normal((sizes[i], sizes[i + 1]),
                                             generator, stddev=std)
        params[f"t{i}_b"] = torch.zeros(sizes[i + 1])
    params["q_w"] = truncated_normal((sizes[-1], num_actions), generator,
                                     stddev=0.01)
    params["q_b"] = torch.zeros(num_actions)
    return params


def q_values(params: Params, obs: torch.Tensor) -> torch.Tensor:
    x = obs.float()
    i = 0
    while f"t{i}_w" in params:
        x = torch.relu(x @ params[f"t{i}_w"] + params[f"t{i}_b"])
        i += 1
    return x @ params["q_w"] + params["q_b"]


class QPolicy:
    """ε-greedy policy over a Q-MLP on ``device`` (rollout workers ask
    for the CPU); ε's draws come from ``default_rng(seed + 1)``."""

    def __init__(self, obs_shape: Tuple[int, ...], num_actions: int,
                 hidden: Sequence[int] = (256, 256), seed: int = 0,
                 device=None):
        self.device = default_device(device)
        self.obs_dim = int(np.prod(obs_shape))
        self.num_actions = num_actions
        self.params = {k: v.to(self.device) for k, v in init_q_net(
            torch.Generator().manual_seed(seed), self.obs_dim, num_actions,
            hidden).items()}
        self.epsilon = 1.0
        self._rng = np.random.default_rng(seed + 1)

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray, deterministic: bool = False):
        obs = np.asarray(obs, np.float32).reshape(len(obs), -1)
        greedy = torch.argmax(q_values(self.params, torch.as_tensor(
            obs, device=self.device)), dim=-1).cpu().numpy()
        if deterministic or self.epsilon <= 0:
            actions = greedy
        else:
            explore = self._rng.random(len(obs)) < self.epsilon
            randoms = self._rng.integers(0, self.num_actions, len(obs))
            actions = np.where(explore, randoms, greedy)
        zeros = np.zeros(len(obs), np.float32)
        return actions.astype(np.int32), zeros, zeros

    def get_weights(self) -> Dict[str, np.ndarray]:
        return ppo_tree_to_numpy(self.params)

    def set_weights(self, weights: Dict[str, np.ndarray]) -> None:
        self.params = {k: v.to(self.device) for k, v in
                       ppo_params_from_numpy(weights).items()}


class DQNRolloutWorker(RolloutWorker):
    """Collects flat (s, a, r, s', done) transitions, [T * N] rows in
    time-major order, for replay."""

    def _make_policy(self, cfg: Dict, seed: int):
        return QPolicy(self._connected_obs_shape, self.env.num_actions,
                       hidden=cfg.get("hidden", (256, 256)), seed=seed,
                       device="cpu")

    def set_epsilon(self, epsilon: float) -> None:
        self.policy.epsilon = float(epsilon)

    def sample(self, rollout_length: int = 64) -> SampleBatch:
        n = self.env.num_envs
        shape = self._connected_obs_shape
        obs_buf = np.empty((rollout_length, n) + shape, np.float32)
        nobs_buf = np.empty((rollout_length, n) + shape, np.float32)
        act_buf = np.empty((rollout_length, n), np.int32)
        rew_buf = np.empty((rollout_length, n), np.float32)
        done_buf = np.empty((rollout_length, n), bool)
        for t in range(rollout_length):
            actions, _, _ = self.policy.compute_actions(self._obs)
            obs_buf[t] = self._obs
            act_buf[t] = actions
            # At a done, next_obs is the reset observation; the target's
            # (1 - done) mask ignores it.
            next_obs, rewards, dones, _ = self._step_env(actions)
            nobs_buf[t] = next_obs
            rew_buf[t] = rewards
            done_buf[t] = dones
            self._obs = next_obs
        flat = lambda a: a.reshape((-1,) + a.shape[2:])
        return SampleBatch({
            OBS: flat(obs_buf), ACTIONS: flat(act_buf),
            REWARDS: flat(rew_buf), DONES: flat(done_buf),
            NEXT_OBS: flat(nobs_buf)})


def dqn_loss(params: Params, target_params: Params, batch,
             gamma: float, double_q: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Double-)DQN Huber TD loss, weighted by ``batch["weights"]`` where
    the replay gives importance weights; returns (loss, |td error|)."""
    q = q_values(params, batch[OBS])
    q_taken = q.gather(-1, batch[ACTIONS].long()[:, None])[:, 0]
    with torch.no_grad():
        next_target = q_values(target_params, batch[NEXT_OBS])
        if double_q:  # the online net picks, the target net values
            next_a = torch.argmax(q_values(params, batch[NEXT_OBS]), dim=-1)
        else:  # the target net picks and values
            next_a = torch.argmax(next_target, dim=-1)
        next_q = next_target.gather(-1, next_a[:, None])[:, 0]
        not_done = 1.0 - batch[DONES].float()
        target = batch[REWARDS] + gamma * not_done * next_q
    td = q_taken - target
    huber = torch.where(td.abs() < 1.0, 0.5 * td ** 2, td.abs() - 0.5)
    weights = batch.get("weights")
    loss = huber.mean() if weights is None else (weights * huber).mean()
    return loss, td.abs()


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self._algo_class = DQN
        self.lr = 5e-4
        self.rollout_fragment_length = 32
        self.train_batch_size = 64
        self.buffer_capacity = 100_000
        self.prioritized_replay = True
        self.prioritized_alpha = 0.6
        self.prioritized_beta = 0.4
        self.learning_starts = 1_000
        self.target_network_update_freq = 500  # in learner updates
        self.num_updates_per_iter = 16
        self.epsilon_timesteps = 10_000  # linear 1.0 -> final_epsilon
        self.final_epsilon = 0.02
        self.double_q = True
        self.policy_hidden = (256, 256)

    def training(self, **kwargs) -> "DQNConfig":
        for k in ("buffer_capacity", "prioritized_replay",
                  "prioritized_alpha", "prioritized_beta", "learning_starts",
                  "target_network_update_freq", "num_updates_per_iter",
                  "epsilon_timesteps", "final_epsilon", "double_q"):
            if k in kwargs:
                setattr(self, k, kwargs.pop(k))
        super().training(**kwargs)
        return self


class DQN(Algorithm):
    """``training_step``: sample, add to replay, K learner updates (each
    feeding its |TD errors| back as priorities), the target network copied
    every ``target_network_update_freq`` updates, weights out."""

    _worker_cls = DQNRolloutWorker

    def setup(self, config: DQNConfig) -> None:
        super().setup(config)
        if config.prioritized_replay:
            self.buffer: ReplayBuffer = PrioritizedReplayBuffer(
                config.buffer_capacity, alpha=config.prioritized_alpha,
                seed=config.seed)
        else:
            self.buffer = ReplayBuffer(config.buffer_capacity,
                                       seed=config.seed)
        self.params = to_learner(self.workers.local_worker.get_weights(),
                                 self.device)
        self.target_params = self._copy(self.params)
        self.optimizer = adam(config.lr)
        self.opt_state = self.optimizer.init(
            [p.detach() for p in self.params.values()])
        self._num_updates = 0
        gamma, double_q = config.gamma, config.double_q

        def update(params, target_params, opt_state, batch):
            loss, td, opt_state = sgd_step(
                params, opt_state, self.optimizer,
                lambda p: dqn_loss(p, target_params, batch, gamma, double_q))
            return params, opt_state, loss, td

        self._update = update

    @staticmethod
    def _copy(params: Params) -> Params:
        return {k: v.detach().clone() for k, v in params.items()}

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._timesteps_total / max(cfg.epsilon_timesteps, 1))
        return 1.0 + frac * (cfg.final_epsilon - 1.0)

    def training_step(self) -> Dict:
        cfg = self.config
        eps = self._epsilon()
        self.workers.foreach_worker(lambda w: w.set_epsilon(eps))
        new_steps = 0
        for b in self.workers.sample(cfg.rollout_fragment_length):
            self.buffer.add(b)
            new_steps += b.count
        self._timesteps_total += new_steps
        prioritized = isinstance(self.buffer, PrioritizedReplayBuffer)
        losses = []
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.num_updates_per_iter):
                if prioritized:
                    batch = self.buffer.sample(cfg.train_batch_size,
                                               beta=cfg.prioritized_beta)
                else:
                    batch = self.buffer.sample(cfg.train_batch_size)
                device_batch = batch_to({k: v for k, v in batch.items()
                                         if k != "batch_indexes"},
                                        self.device)
                self.params, self.opt_state, loss, td = self._update(
                    self.params, self.target_params, self.opt_state,
                    device_batch)
                if prioritized:
                    self.buffer.update_priorities(batch["batch_indexes"],
                                                  td.cpu().numpy())
                self._num_updates += 1
                if self._num_updates % cfg.target_network_update_freq == 0:
                    self.target_params = self._copy(self.params)
                losses.append(float(loss))
            weights = ppo_tree_to_numpy(self.params)
            self.workers.local_worker.set_weights(weights)
            self.workers.sync_weights(weights)
        return {
            "timesteps_this_iter": new_steps,
            "num_learner_updates": self._num_updates,
            "epsilon": eps,
            "replay_buffer_size": len(self.buffer),
            "loss": float(np.mean(losses)) if losses else None,
        }

    def get_state(self) -> Dict:
        state = super().get_state()
        state.update({"params": ppo_tree_to_numpy(self.params),
                      "target_params": ppo_tree_to_numpy(self.target_params),
                      "num_updates": self._num_updates})
        return state

    def set_state(self, state: Dict) -> None:
        super().set_state(state)
        if "params" in state:
            self._set_learner_params(state["params"])
            copy_into(self.target_params, state["target_params"])
            self._num_updates = state.get("num_updates", 0)
