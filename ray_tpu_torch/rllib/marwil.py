"""MARWIL and BC: counterpart of the JAX package's ``rllib/marwil.py``.

Offline policy learning from logged JSONL data (``JsonReader``). MARWIL
weights the policy's log-likelihood of the logged actions by
exp(beta * advantage / sqrt(running mean of advantage²)), with a learned
value baseline; BC is MARWIL with beta = 0. The update runs on the
learner's device; the worker set's env and CPU policy serve only
``evaluate``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.convert import ppo_tree_to_numpy
from ..train.optim import adam
from .algorithm import (Algorithm, AlgorithmConfig, batch_to, sgd_step,
                        to_learner, tree_map)
from .offline import JsonReader
from .sample_batch import ACTIONS, DONES, OBS, REWARDS, SampleBatch


def _monte_carlo_returns(batch: SampleBatch, gamma: float) -> np.ndarray:
    """Discounted return-to-go per step; DONES bound episodes.

    Accepts flat episode-sequential [T] columns or time-major [T, N]
    columns from vectorized rollout logs (each env column scanned on its
    own: flattening [T, N] first would interleave episodes). Returns match
    the column's shape."""
    rewards = np.asarray(batch[REWARDS], np.float32)
    dones = np.asarray(batch[DONES], bool)
    flat = rewards.ndim == 1
    if flat:
        rewards = rewards[:, None]
        dones = dones.reshape(-1)[:, None]
    out = np.zeros_like(rewards)
    acc = np.zeros(rewards.shape[1], np.float32)
    for t in range(rewards.shape[0] - 1, -1, -1):
        acc = np.where(dones[t], 0.0, acc)
        acc = rewards[t] + gamma * acc
        out[t] = acc
    return out[:, 0] if flat else out


class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self._algo_class = MARWIL
        self.beta = 1.0  # 0.0 => pure behaviour cloning
        self.vf_coeff = 1.0
        self.lr = 1e-3
        self.train_batch_size = 256
        self.num_updates_per_iter = 32
        self.input_path: str = ""
        self.moving_average_sqd_adv_norm_update_rate = 1e-2

    def offline_data(self, input_path: str) -> "MARWILConfig":
        self.input_path = input_path
        return self

    def training(self, **kwargs) -> "MARWILConfig":
        for k in ("beta", "vf_coeff", "num_updates_per_iter",
                  "moving_average_sqd_adv_norm_update_rate"):
            if k in kwargs:
                setattr(self, k, kwargs.pop(k))
        super().training(**kwargs)
        return self


class BCConfig(MARWILConfig):
    """Behaviour cloning: MARWIL with beta = 0."""

    def __init__(self):
        super().__init__()
        self._algo_class = BC
        self.beta = 0.0


def marwil_loss(params, batch, adv_norm: torch.Tensor, apply_fn,
                beta: float, vf_coeff: float, ma_rate: float):
    """(policy loss + vf_coeff * value loss, metrics with the updated
    running ``adv_norm``). The advantage takes the values detached; the
    weights, exp(beta * clip(adv / sqrt(adv_norm + 1e-8), -10, 10)) capped
    at 20, are constants of the gradient."""
    logits, values = apply_fn(params, batch[OBS])
    logp_all = torch.log_softmax(logits, dim=-1)
    actions = batch[ACTIONS].long()
    logp = logp_all.gather(-1, actions[:, None])[:, 0]
    adv = batch["returns"] - values.detach()
    if beta > 0:
        weights = torch.exp(beta * torch.clamp(
            adv / torch.sqrt(adv_norm + 1e-8), -10.0, 10.0))
        weights = torch.clamp_max(weights, 20.0)
    else:
        weights = torch.ones_like(logp)
    policy_loss = -torch.mean(weights.detach() * logp)
    vf_loss = torch.mean((values - batch["returns"]) ** 2)
    total = policy_loss + vf_coeff * vf_loss
    new_norm = adv_norm + ma_rate * (torch.mean(adv ** 2) - adv_norm)
    return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                   "adv_norm": new_norm}


class MARWIL(Algorithm):
    """``training_step``: K offline minibatches, one update each
    (advantage-weighted NLL and value regression). The worker set's env
    is used only by ``evaluate``."""

    def setup(self, config: MARWILConfig) -> None:
        super().setup(config)
        if not config.input_path:
            raise ValueError("MARWIL/BC needs config.offline_data(path)")
        data = JsonReader(config.input_path).read_all()
        # Returns at the logged shape (flat [T] or time-major [T, N])
        # before flattening.
        returns = _monte_carlo_returns(data, config.gamma).reshape(-1)
        obs = np.asarray(data[OBS], np.float32)
        self._data = {
            OBS: obs.reshape(len(returns), -1),
            ACTIONS: np.asarray(data[ACTIONS]).reshape(-1),
            "returns": returns,
        }
        self._rng_np = np.random.default_rng(config.seed)
        policy = self.workers.local_worker.policy
        self.params = to_learner(policy.get_weights(), self.device)
        apply_fn = policy.net.apply
        self.optimizer = adam(config.lr)
        self.opt_state = self.optimizer.init(
            [p.detach() for p in self.params.values()])
        beta, vfc = config.beta, config.vf_coeff
        ma_rate = config.moving_average_sqd_adv_norm_update_rate

        def update(params, opt_state, batch, adv_norm):
            total, aux, opt_state = sgd_step(
                params, opt_state, self.optimizer,
                lambda p: marwil_loss(p, batch, adv_norm, apply_fn, beta,
                                      vfc, ma_rate))
            return params, opt_state, total, aux

        self._update = update
        self._adv_norm = torch.ones((), device=self.device)

    def training_step(self) -> Dict:
        cfg = self.config
        n = len(self._data["returns"])
        total = aux = None
        for _ in range(cfg.num_updates_per_iter):
            idx = self._rng_np.integers(0, n, cfg.train_batch_size)
            batch = batch_to({k: v[idx] for k, v in self._data.items()},
                             self.device)
            self.params, self.opt_state, total, aux = self._update(
                self.params, self.opt_state, batch, self._adv_norm)
            self._adv_norm = aux["adv_norm"]
        steps = cfg.num_updates_per_iter * cfg.train_batch_size
        self._timesteps_total += steps
        weights = ppo_tree_to_numpy(self.params)
        self.workers.local_worker.set_weights(weights)
        self.workers.sync_weights(weights)
        return {
            "timesteps_this_iter": steps,
            "total_loss": float(total),
            "policy_loss": float(aux["policy_loss"]),
            "vf_loss": float(aux["vf_loss"]),
        }

    def evaluate(self, episodes: int = 5) -> Dict:
        """Roll the learned policy out through the worker's connector
        pipelines (eval mode: running statistics frozen)."""
        worker = self.workers.local_worker
        env = worker.env
        rewards = []
        worker.agent_connectors.in_eval()
        worker.agent_connectors.reset()
        try:
            obs = worker.agent_connectors(
                env.vector_reset(seed=self.config.seed + 99))
            ep_rew = np.zeros(env.num_envs, np.float32)
            while len(rewards) < episodes:
                actions, _, _ = worker.policy.compute_actions(
                    obs, deterministic=True)
                nobs, r, dones, _ = env.vector_step(
                    worker.action_connectors(actions))
                worker.agent_connectors.on_episode_done(dones)
                obs = worker.agent_connectors(nobs)
                ep_rew += r
                for i in np.nonzero(dones)[0]:
                    rewards.append(float(ep_rew[i]))
                    ep_rew[i] = 0.0
        finally:
            worker.agent_connectors.in_training()
            worker.agent_connectors.reset()
            # Re-align the worker's stepping state with its env, which
            # this loop advanced out from under sample().
            worker._obs = worker.agent_connectors(
                env.vector_reset(seed=self.config.seed + 100))
        return {"episode_reward_mean": float(np.mean(rewards)),
                "episodes": len(rewards)}

    def get_state(self) -> Dict:
        state = super().get_state()
        state["params"] = ppo_tree_to_numpy(self.params)
        state["adv_norm"] = float(self._adv_norm)
        state["opt_state"] = tree_map(lambda t: t.cpu().numpy(),
                                      self.opt_state)
        return state

    def set_state(self, state: Dict) -> None:
        """Parameters copied in place (a JAX state's too), the running
        advantage norm, and the optimizer state (this port's own)."""
        super().set_state(state)
        if "params" in state:
            self._set_learner_params(state["params"])
        if "adv_norm" in state:
            # A reset normalizer would inflate the exp advantage weights
            # after every resume.
            self._adv_norm = torch.tensor(float(state["adv_norm"]),
                                          device=self.device)
        if "opt_state" in state:
            self.opt_state = tree_map(
                lambda a: torch.from_numpy(np.array(a)).to(self.device),
                state["opt_state"], np.ndarray)


class BC(MARWIL):
    """Behaviour cloning."""
