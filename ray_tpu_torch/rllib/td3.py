"""TD3: counterpart of the JAX package's ``rllib/td3.py``.

Twin-delayed deterministic policy gradients: a deterministic tanh actor,
twin Q critics, clipped Gaussian target-policy smoothing, delayed actor
and target updates, polyak targets. The parameters are one nested tree
(``actor``, ``q1``, ``q2`` and their ``target_*``; the JAX package's names
and ``[in, out]`` weights) on the learner's device, with two Adams (the
critics', and the actor's, which advances only on actor steps). The JAX
``lax.cond`` on the update count is a Python branch on the same count.
The rollout workers' ``TD3Policy`` runs on the CPU; its exploration noise
and uniform warm-up draw from numpy generators seeded as the JAX
package's, so warm-up actions are JAX's bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import random as trandom
from ..device import default_device
from ..models.convert import rl_tree_from_numpy, rl_tree_to_numpy
from ..train.optim import adam
from .algorithm import (Algorithm, AlgorithmConfig, batch_to,
                        copy_tree_into, key_from_numpy, key_to_numpy,
                        learner_tree, opt_step, tree_leaves, tree_map)
from .replay_buffers import ReplayBuffer
from .sac import (SACRolloutWorker, _copy, _init_mlp, _mlp, _q, detached,
                  polyak)
from .sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS


def init_td3_params(generator: Optional[torch.Generator], obs_dim: int,
                    action_dim: int, hidden: Sequence[int] = (256, 256)
                    ) -> Dict:
    sizes = [obs_dim] + list(hidden)
    qsizes = [obs_dim + action_dim] + list(hidden)
    actor = _init_mlp(generator, sizes, action_dim, out_std=0.01)
    q1 = _init_mlp(generator, qsizes, 1, out_std=0.1)
    q2 = _init_mlp(generator, qsizes, 1, out_std=0.1)
    return {"actor": actor, "q1": q1, "q2": q2,
            "target_actor": _copy(actor), "target_q1": _copy(q1),
            "target_q2": _copy(q2)}


def deterministic_action(actor: Dict[str, torch.Tensor], obs: torch.Tensor,
                         low: float, high: float) -> torch.Tensor:
    scale = (high - low) / 2.0
    return low + (torch.tanh(_mlp(actor, obs.float())) + 1.0) * scale


class TD3Policy:
    """Deterministic actor plus Gaussian exploration noise for rollouts, on
    ``device`` (rollout workers ask for the CPU). Uniform-random actions
    until the learner ends the warm-up (``random_phase``)."""

    def __init__(self, obs_shape: Tuple[int, ...], action_dim: int,
                 low: float, high: float, hidden=(256, 256),
                 seed: int = 0, explore_sigma: float = 0.1, device=None):
        self.device = default_device(device)
        self.obs_dim = int(np.prod(obs_shape))
        self.action_dim = action_dim
        self.low, self.high = float(low), float(high)
        self.explore_sigma = explore_sigma
        # An untrained tanh actor emits ~zero actions and never explores;
        # the learner turns this off once the buffer holds learning_starts
        # transitions.
        self.random_phase = True
        params = init_td3_params(torch.Generator().manual_seed(seed),
                                 self.obs_dim, action_dim, hidden)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self._rng = np.random.default_rng(seed + 1)

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray, deterministic: bool = False):
        obs = np.asarray(obs, np.float32).reshape(len(obs), -1)
        zeros = np.zeros(len(obs), np.float32)
        if self.random_phase and not deterministic:
            actions = self._rng.uniform(
                self.low, self.high, (len(obs), self.action_dim))
            return actions.astype(np.float32), zeros, zeros
        actions = deterministic_action(
            self.params["actor"], torch.as_tensor(obs, device=self.device),
            self.low, self.high).cpu().numpy()
        if not deterministic:
            scale = (self.high - self.low) / 2.0
            noise = self._rng.normal(
                0.0, self.explore_sigma * scale, actions.shape)
            actions = np.clip(actions + noise, self.low, self.high)
        return actions.astype(np.float32), zeros, zeros

    def get_weights(self) -> Dict:
        return rl_tree_to_numpy(self.params)

    def set_weights(self, weights: Dict) -> None:
        # Merged: the learner sends only the actor; a whole tree (a
        # restored checkpoint) lands too.
        self.params = {**self.params, **tree_map(
            lambda t: t.to(self.device), rl_tree_from_numpy(weights))}


class TD3RolloutWorker(SACRolloutWorker):
    def _make_policy(self, cfg: Dict, seed: int):
        return TD3Policy(self._connected_obs_shape, self.env.action_dim,
                         self.env.action_low, self.env.action_high,
                         hidden=cfg.get("hidden", (256, 256)), seed=seed,
                         explore_sigma=cfg.get("explore_sigma", 0.1),
                         device="cpu")


class TD3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self._algo_class = TD3
        self.env = "FastPendulum"
        self.lr = 1e-3
        self.rollout_fragment_length = 8
        self.train_batch_size = 128
        self.buffer_capacity = 100_000
        self.learning_starts = 500
        self.tau = 0.005
        self.num_updates_per_iter = 32
        self.policy_delay = 2  # delayed actor updates (the "TD" in TD3)
        self.target_noise = 0.2  # target-policy smoothing sigma
        self.target_noise_clip = 0.5
        self.explore_sigma = 0.1
        self.policy_config_extra["explore_sigma"] = self.explore_sigma
        self.policy_hidden = (256, 256)

    def training(self, **kwargs) -> "TD3Config":
        for k in ("buffer_capacity", "learning_starts", "tau",
                  "num_updates_per_iter", "policy_delay", "target_noise",
                  "target_noise_clip", "explore_sigma"):
            if k in kwargs:
                setattr(self, k, kwargs.pop(k))
        # Rollout policies take the exploration sigma when built.
        self.policy_config_extra["explore_sigma"] = self.explore_sigma
        super().training(**kwargs)
        return self


def td3_critic_loss(critics, params, batch, key: trandom.Key, low: float,
                    high: float, gamma: float, tn: float, tn_clip: float
                    ) -> torch.Tensor:
    """The twin-Q TD loss toward the smoothed target: the target actor's
    action plus ``tn``-scaled normal noise clipped to ``tn_clip``, then to
    the action range."""
    with torch.no_grad():
        target_a = deterministic_action(params["target_actor"],
                                        batch[NEXT_OBS], low, high)
        noise = torch.clamp(tn * trandom.normal(key, target_a.shape),
                            -tn_clip, tn_clip)
        target_a = torch.clamp(target_a + noise, low, high)
        tq = torch.minimum(
            _q(params["target_q1"], batch[NEXT_OBS], target_a),
            _q(params["target_q2"], batch[NEXT_OBS], target_a))
        not_done = 1.0 - batch[DONES].float()
        target = batch[REWARDS] + gamma * not_done * tq
    q1 = _q(critics["q1"], batch[OBS], batch[ACTIONS])
    q2 = _q(critics["q2"], batch[OBS], batch[ACTIONS])
    return torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2)


def td3_actor_loss(actor, critics, batch, low: float, high: float
                   ) -> torch.Tensor:
    """-mean Q1(s, actor(s)), the critic detached."""
    a = deterministic_action(actor, batch[OBS], low, high)
    return -torch.mean(_q(detached(critics["q1"]), batch[OBS], a))


class TD3(Algorithm):
    """``training_step``: sample, add to replay, K updates (the critics
    every step; the actor and every target every ``policy_delay`` steps),
    the actor's weights out."""

    _worker_cls = TD3RolloutWorker

    def setup(self, config: TD3Config) -> None:
        # The attribute may have been set after .training() copied it.
        config.policy_config_extra["explore_sigma"] = config.explore_sigma
        super().setup(config)
        env = self.workers.local_worker.env
        low, high = float(env.action_low), float(env.action_high)
        scale = (high - low) / 2.0
        self.buffer = ReplayBuffer(config.buffer_capacity, seed=config.seed)
        self.params = learner_tree(self.workers.local_worker.get_weights(),
                                   self.device)
        # Separate optimizers: a shared one fed zero actor gradients on
        # critic-only steps would still move the actor by its momentum.
        self.critic_opt = adam(config.lr)
        self.actor_opt = adam(config.lr)
        self.opt_state = {
            "critic": self.critic_opt.init([p.detach() for p in tree_leaves(
                self._critics(self.params))]),
            "actor": self.actor_opt.init(
                [p.detach() for p in tree_leaves(self.params["actor"])]),
        }
        self._num_updates = 0
        self._warmup_done = False
        gamma, tau = config.gamma, config.tau
        tn = config.target_noise * scale
        tn_clip = config.target_noise_clip * scale

        def update(params, opt_state, batch, key, do_actor: bool):
            critics = self._critics(params)
            leaves = tree_leaves(critics)
            with torch.enable_grad():
                c_loss = td3_critic_loss(critics, params, batch, key, low,
                                         high, gamma, tn, tn_clip)
                grads = torch.autograd.grad(c_loss, leaves)
            critic_state = opt_step(leaves, grads, self.critic_opt,
                                    opt_state["critic"])
            actor_state = opt_state["actor"]
            a_loss = torch.zeros((), device=c_loss.device)
            if do_actor:
                actor = tree_leaves(params["actor"])
                with torch.enable_grad():
                    a_loss = td3_actor_loss(params["actor"], critics, batch,
                                            low, high)
                    grads = torch.autograd.grad(a_loss, actor)
                actor_state = opt_step(actor, grads, self.actor_opt,
                                       actor_state)
                for name in ("q1", "q2", "actor"):
                    polyak(params[f"target_{name}"], params[name], tau)
            return (params, {"critic": critic_state, "actor": actor_state},
                    {"critic_loss": c_loss.detach(),
                     "actor_loss": a_loss.detach()})

        self._update = update
        self._key = trandom.prng_key(config.seed + 23, self.device)

    @staticmethod
    def _critics(params):
        return {"q1": params["q1"], "q2": params["q2"]}

    def _end_warmup(self) -> None:
        self._warmup_done = True
        self.workers.foreach_worker(
            lambda w: setattr(w.policy, "random_phase", False))

    def training_step(self) -> Dict:
        cfg = self.config
        new_steps = 0
        for b in self.workers.sample(cfg.rollout_fragment_length):
            self.buffer.add(b)
            new_steps += b.count
        self._timesteps_total += new_steps
        aux_out = {}
        if len(self.buffer) >= cfg.learning_starts:
            if not self._warmup_done:
                self._end_warmup()
            actor_loss = None
            for _ in range(cfg.num_updates_per_iter):
                batch = self.buffer.sample(cfg.train_batch_size)
                device_batch = batch_to({k: v for k, v in batch.items()
                                         if k != "batch_indexes"},
                                        self.device)
                keys = trandom.split(self._key)
                self._key, sub = trandom.take(keys, 0), trandom.take(keys, 1)
                is_actor_step = self._num_updates % cfg.policy_delay == 0
                self.params, self.opt_state, aux = self._update(
                    self.params, self.opt_state, device_batch, sub,
                    is_actor_step)
                if is_actor_step:
                    actor_loss = aux["actor_loss"]
                self._num_updates += 1
            aux_out = {"critic_loss": float(aux["critic_loss"])}
            if actor_loss is not None:
                aux_out["actor_loss"] = float(actor_loss)
            # Workers only evaluate the actor.
            weights = {"actor": rl_tree_to_numpy(self.params["actor"])}
            self.workers.local_worker.set_weights(weights)
            self.workers.sync_weights(weights)
        return {
            "timesteps_this_iter": new_steps,
            "num_learner_updates": self._num_updates,
            "replay_buffer_size": len(self.buffer),
            **aux_out,
        }

    def get_state(self) -> Dict:
        state = super().get_state()
        state.update({
            "params": rl_tree_to_numpy(self.params),
            "num_updates": self._num_updates,
            "opt_state": tree_map(lambda t: t.cpu().numpy(), self.opt_state),
            "warmup_done": self._warmup_done,
            "rng_key": key_to_numpy(self._key),
        })
        return state

    def set_state(self, state: Dict) -> None:
        """Parameters copied in place (a JAX state's ``params`` too); the
        optimizer state is this port's own; the key as JAX saves it."""
        super().set_state(state)
        if "params" in state:
            copy_tree_into(self.params, state["params"])
            self._num_updates = state.get("num_updates", 0)
            weights = rl_tree_to_numpy(self.params)
            self.workers.local_worker.set_weights(weights)
            self.workers.sync_weights(weights)
        if "opt_state" in state:
            self.opt_state = tree_map(
                lambda a: torch.from_numpy(np.array(a)).to(self.device),
                state["opt_state"], np.ndarray)
        if "rng_key" in state:
            self._key = key_from_numpy(state["rng_key"], self.device)
        if state.get("warmup_done"):
            # A trained policy must not go back to uniform warm-up actions.
            self._end_warmup()
