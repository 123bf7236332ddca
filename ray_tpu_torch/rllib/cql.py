"""CQL: counterpart of the JAX package's ``rllib/cql.py``.

Conservative Q-learning for offline continuous control: SAC's twin-Q
learner trained from logged data only (``JsonReader``), with the CQL(H)
penalty pushing Q down on out-of-distribution actions (a logsumexp over
uniform and policy actions) and up on the dataset's. The actor clones the
data's actions for ``bc_iters`` updates, then takes SAC's objective; the
JAX ``jnp.where`` between the two is a Python branch. Three Adams
(critics, actor, temperature), then the polyak targets; all on the
learner's device (``default_device``: the card unless the caller asks
for the CPU). No rollout workers.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import random as trandom
from ..models.convert import rl_tree_to_numpy
from ..train.optim import adam
from .algorithm import (Algorithm, AlgorithmConfig, batch_to,
                        copy_tree_into, learner_tree, opt_step, tree_leaves)
from .offline import JsonReader
from .sac import (_q, actor_dist, detached, init_sac_params, polyak,
                  sample_action)
from .sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS


class CQLConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self._algo_class = CQL
        self.input_path: Optional[str] = None  # a JsonWriter directory
        self.action_dim = 1
        self.action_low = -2.0
        self.action_high = 2.0
        self.lr = 3e-4
        self.train_batch_size = 256
        self.num_updates_per_iter = 64
        self.tau = 0.005
        self.min_q_weight = 5.0     # conservative penalty scale
        self.num_penalty_actions = 10
        self.bc_iters = 200         # actor warm-up: pure behaviour cloning
        self.initial_alpha = 0.2
        self.target_entropy: Optional[float] = None
        self.policy_hidden = (256, 256)

    def offline_data(self, input_path: str) -> "CQLConfig":
        self.input_path = input_path
        return self

    def training(self, **kwargs) -> "CQLConfig":
        for k in ("min_q_weight", "num_penalty_actions", "bc_iters",
                  "tau", "num_updates_per_iter", "initial_alpha",
                  "target_entropy"):
            if k in kwargs:
                setattr(self, k, kwargs.pop(k))
        super().training(**kwargs)
        return self


def cql_critic_loss(params, batch, key: trandom.Key, cfg_static):
    """Twin-Q TD loss + CQL(H) penalty -> (loss, metrics).

    penalty = logsumexp over {uniform, pi(s), pi(s')} actions of Q(s, a)
    (each importance-corrected) minus Q(s, a_data). Only the critics
    ``params["q1"]``/``["q2"]`` take gradients: the target and every
    sampled action and log-probability are detached."""
    (adim, low, high, gamma, n_pen, min_q_w) = cfg_static
    obs, acts = batch[OBS], batch[ACTIONS]
    b = obs.shape[0]
    keys = trandom.split(key, 4)
    k_next, k_rand, k_pi, k_pin = (trandom.take(keys, i) for i in range(4))

    def tiled(o):
        return torch.repeat_interleave(o, n_pen, dim=0)  # [B*N, d]

    with torch.no_grad():
        actor = detached(params["actor"])
        next_a, next_logp = sample_action(actor, batch[NEXT_OBS], k_next,
                                          adim, low, high)
        tq = torch.minimum(_q(params["target_q1"], batch[NEXT_OBS], next_a),
                           _q(params["target_q2"], batch[NEXT_OBS], next_a))
        alpha = torch.exp(params["log_alpha"])
        not_done = 1.0 - batch[DONES].float()
        target = batch[REWARDS] + gamma * not_done * (tq - alpha * next_logp)
        rand_a = trandom.uniform(k_rand, (b * n_pen, adim), minval=low,
                                 maxval=high)
        # log density of the uniform proposal (importance correction)
        log_unif = float(-adim * np.log(np.float32(high - low),
                                        dtype=np.float32))
        pi_a, pi_logp = sample_action(actor, tiled(obs), k_pi, adim, low,
                                      high)
        pin_a, pin_logp = sample_action(actor, tiled(batch[NEXT_OBS]),
                                        k_pin, adim, low, high)
    q1_data = _q(params["q1"], obs, acts)
    q2_data = _q(params["q2"], obs, acts)
    td_loss = torch.mean((q1_data - target) ** 2) + torch.mean(
        (q2_data - target) ** 2)

    def penalty(qp):
        q_rand = _q(qp, tiled(obs), rand_a).reshape(b, n_pen) - log_unif
        q_pi = (_q(qp, tiled(obs), pi_a).reshape(b, n_pen)
                - pi_logp.reshape(b, n_pen))
        q_pin = (_q(qp, tiled(obs), pin_a).reshape(b, n_pen)
                 - pin_logp.reshape(b, n_pen))
        cat = torch.cat([q_rand, q_pi, q_pin], dim=1)
        return torch.mean(torch.logsumexp(cat, dim=1))

    cql1 = penalty(params["q1"]) - torch.mean(q1_data)
    cql2 = penalty(params["q2"]) - torch.mean(q2_data)
    total = td_loss + min_q_w * (cql1 + cql2)
    return total, {"td_loss": td_loss, "cql_penalty": cql1 + cql2,
                   "q_data_mean": torch.mean(q1_data)}


def cql_actor_loss(actor, params, batch, key: trandom.Key, bc_phase: bool,
                   cfg_static):
    """Before ``bc_iters``: the squared distance of the squashed mean to
    the data's action (behaviour cloning); after: SAC's objective
    mean(alpha * logp - min Q), alpha and the critics detached. Returns
    (loss, logp of the sampled actions), the sample drawn in both
    phases."""
    (adim, low, high, *_rest) = cfg_static
    a_pi, logp = sample_action(actor, batch[OBS], key, adim, low, high)
    if bc_phase:
        mean, _ = actor_dist(actor, batch[OBS], adim)
        scale = (high - low) / 2.0
        mean_act = low + (torch.tanh(mean) + 1.0) * scale
        return torch.mean((mean_act - batch[ACTIONS]) ** 2), logp
    alpha = torch.exp(params["log_alpha"]).detach()
    q = torch.minimum(_q(detached(params["q1"]), batch[OBS], a_pi),
                      _q(detached(params["q2"]), batch[OBS], a_pi))
    return torch.mean(alpha * logp - q), logp


class CQL(Algorithm):
    """Fully offline: no rollout workers (``setup`` builds no
    ``WorkerSet``); the data comes from ``JsonReader``."""

    def setup(self, config: CQLConfig) -> None:
        if not config.input_path:
            raise ValueError("CQL needs config.offline_data(input_path)")
        batch = JsonReader(config.input_path).read_all()
        self._data = {
            OBS: np.asarray(batch[OBS], np.float32),
            ACTIONS: np.asarray(batch[ACTIONS], np.float32),
            REWARDS: np.asarray(batch[REWARDS], np.float32),
            NEXT_OBS: np.asarray(batch[NEXT_OBS], np.float32),
            DONES: np.asarray(batch[DONES]),
        }
        if self._data[ACTIONS].ndim == 1:
            self._data[ACTIONS] = self._data[ACTIONS][:, None]
        self._n = len(self._data[OBS])
        obs_dim = int(np.prod(self._data[OBS].shape[1:]))
        adim = config.action_dim
        params = init_sac_params(torch.Generator().manual_seed(config.seed),
                                 obs_dim, adim, config.policy_hidden)
        params["log_alpha"].fill_(float(np.float32(
            np.log(config.initial_alpha))))
        self.params = learner_tree(rl_tree_to_numpy(params), self.device)
        self._rng = trandom.prng_key(config.seed + 1, self.device)
        self._np_rng = np.random.default_rng(config.seed + 2)
        self.critic_opt = adam(config.lr)
        self.actor_opt = adam(config.lr)
        self.alpha_opt = adam(config.lr)
        self.critic_state = self.critic_opt.init(
            [p.detach() for p in tree_leaves(self._critics(self.params))])
        self.actor_state = self.actor_opt.init(
            [p.detach() for p in tree_leaves(self.params["actor"])])
        self.alpha_state = self.alpha_opt.init(
            [self.params["log_alpha"].detach()])
        target_entropy = (config.target_entropy
                          if config.target_entropy is not None
                          else -float(adim))
        cfg_static = (adim, config.action_low, config.action_high,
                      config.gamma, config.num_penalty_actions,
                      config.min_q_weight)
        tau = config.tau

        def update(params, copt, aopt, lopt, batch, key, bc_phase: bool):
            keys = trandom.split(key, 3)
            k1, k2 = trandom.take(keys, 0), trandom.take(keys, 1)
            critics = self._critics(params)
            leaves = tree_leaves(critics)
            with torch.enable_grad():
                closs, caux = cql_critic_loss(params, batch, k1, cfg_static)
                grads = torch.autograd.grad(closs, leaves)
            copt = opt_step(leaves, grads, self.critic_opt, copt)

            leaves = tree_leaves(params["actor"])
            with torch.enable_grad():
                aloss, logp = cql_actor_loss(params["actor"], params, batch,
                                             k2, bc_phase, cfg_static)
                grads = torch.autograd.grad(aloss, leaves)
            aopt = opt_step(leaves, grads, self.actor_opt, aopt)

            log_alpha = params["log_alpha"]
            with torch.enable_grad():
                alpha_loss = -torch.mean(torch.exp(log_alpha) * (
                    logp + target_entropy).detach())
                grads = torch.autograd.grad(alpha_loss, [log_alpha])
            lopt = opt_step([log_alpha], grads, self.alpha_opt, lopt)

            for q in ("q1", "q2"):
                polyak(params[f"target_{q}"], params[q], tau)
            metrics = {"critic_loss": closs, "actor_loss": aloss, **caux}
            return params, copt, aopt, lopt, {k: v.detach()
                                              for k, v in metrics.items()}

        self._update = update
        self._num_updates = 0

    @staticmethod
    def _critics(params):
        return {"q1": params["q1"], "q2": params["q2"]}

    def _sample_batch(self) -> Dict[str, torch.Tensor]:
        idx = self._np_rng.integers(0, self._n,
                                    self.config.train_batch_size)
        return batch_to({k: v[idx] for k, v in self._data.items()},
                        self.device)

    def training_step(self) -> Dict:
        cfg: CQLConfig = self.config
        metrics = {}
        for _ in range(cfg.num_updates_per_iter):
            keys = trandom.split(self._rng)
            self._rng, sub = trandom.take(keys, 0), trandom.take(keys, 1)
            bc = self._num_updates < cfg.bc_iters
            (self.params, self.critic_state, self.actor_state,
             self.alpha_state, metrics) = self._update(
                self.params, self.critic_state, self.actor_state,
                self.alpha_state, self._sample_batch(), sub, bc)
            self._num_updates += 1
        steps = cfg.num_updates_per_iter * cfg.train_batch_size
        self._timesteps_total += steps
        return {k: float(v) for k, v in metrics.items()} | {
            "timesteps_this_iter": steps,
            "num_updates": self._num_updates,
        }

    def train(self) -> Dict:
        t0 = time.perf_counter()
        result = self.training_step()
        self.iteration += 1
        result.update({"training_iteration": self.iteration,
                       "timesteps_total": self._timesteps_total,
                       "time_this_iter_s": time.perf_counter() - t0})
        return result

    @torch.no_grad()
    def q_values(self, obs: np.ndarray, actions: np.ndarray) -> np.ndarray:
        """min(Q1, Q2), for conservatism checks and evaluation."""
        obs = torch.as_tensor(np.asarray(obs, np.float32),
                              device=self.device)
        actions = torch.as_tensor(np.asarray(actions, np.float32),
                                  device=self.device)
        return torch.minimum(_q(self.params["q1"], obs, actions),
                             _q(self.params["q2"], obs, actions)
                             ).cpu().numpy()

    @torch.no_grad()
    def compute_single_action(self, obs: np.ndarray) -> np.ndarray:
        obs = torch.as_tensor(np.asarray(obs, np.float32),
                              device=self.device)[None]
        mean, _ = actor_dist(self.params["actor"], obs,
                             self.config.action_dim)
        scale = (self.config.action_high - self.config.action_low) / 2.0
        act = self.config.action_low + (torch.tanh(mean) + 1.0) * scale
        return act.cpu().numpy()[0]

    def get_state(self) -> Dict:
        return {"iteration": self.iteration,
                "timesteps_total": self._timesteps_total,
                "num_updates": self._num_updates,
                "params": rl_tree_to_numpy(self.params)}

    def set_state(self, state: Dict) -> None:
        """Counters and parameters (copied in place; a JAX state's too)."""
        self.iteration = state.get("iteration", 0)
        self._timesteps_total = state.get("timesteps_total", 0)
        self._num_updates = state.get("num_updates", 0)
        if "params" in state:
            copy_tree_into(self.params, state["params"])

    def stop(self) -> None:
        pass
