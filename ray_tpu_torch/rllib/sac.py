"""SAC: counterpart of the JAX package's ``rllib/sac.py``.

Soft actor-critic for continuous actions: a tanh-squashed Gaussian actor,
twin Q critics, their polyak targets and ``log_alpha`` in one nested
parameter tree (``{"actor": {...}, "q1": {...}, "q2": {...},
"target_q1": ..., "target_q2": ..., "log_alpha": ()}``, the JAX package's
names and ``[in, out]`` weights). The update (critic, actor and
temperature losses summed under one Adam, then the polyak targets) runs
on the learner's device; the rollout workers' ``SACPolicy`` runs on the
CPU. Gaussian draws come from ``random.normal`` with JAX's key sequence:
its uniforms are JAX's bit for bit, its normals within 6e-6 of each
draw's size, so actions and log-probabilities match JAX's within a
tolerance, not bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import random as trandom
from ..device import default_device
from ..models.common import truncated_normal
from ..models.convert import rl_tree_from_numpy, rl_tree_to_numpy
from ..train.optim import adam
from .algorithm import (Algorithm, AlgorithmConfig, batch_to,
                        copy_tree_into, key_from_numpy, key_to_numpy,
                        learner_tree, opt_step, tree_leaves, tree_map)
from .replay_buffers import ReplayBuffer
from .rollout_worker import RolloutWorker
from .sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
Tree = Dict[str, object]


def _init_mlp(generator: Optional[torch.Generator], sizes: Sequence[int],
              out_dim: int, out_std: float = 0.01) -> Dict[str, torch.Tensor]:
    """ReLU MLP ``t<i>_w``/``t<i>_b`` to ``out_w``/``out_b``: He-scaled
    truncated normals, the output layer at ``out_std``."""
    params = {}
    for i in range(len(sizes) - 1):
        std = float(np.sqrt(2.0 / sizes[i]))
        params[f"t{i}_w"] = truncated_normal((sizes[i], sizes[i + 1]),
                                             generator, stddev=std)
        params[f"t{i}_b"] = torch.zeros(sizes[i + 1])
    params["out_w"] = truncated_normal((sizes[-1], out_dim), generator,
                                       stddev=out_std)
    params["out_b"] = torch.zeros(out_dim)
    return params


def _mlp(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    i = 0
    while f"t{i}_w" in params:
        x = torch.relu(x @ params[f"t{i}_w"] + params[f"t{i}_b"])
        i += 1
    return x @ params["out_w"] + params["out_b"]


def _copy(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in tree.items()}


def detached(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``jax.lax.stop_gradient`` of a dict of tensors."""
    return {k: v.detach() for k, v in tree.items()}


def init_sac_params(generator: Optional[torch.Generator], obs_dim: int,
                    action_dim: int, hidden: Sequence[int] = (256, 256)
                    ) -> Tree:
    """Actor + twin critics + their polyak targets + log_alpha (0)."""
    sizes = [obs_dim] + list(hidden)
    qsizes = [obs_dim + action_dim] + list(hidden)
    actor = _init_mlp(generator, sizes, 2 * action_dim)
    q1 = _init_mlp(generator, qsizes, 1, out_std=0.1)
    q2 = _init_mlp(generator, qsizes, 1, out_std=0.1)
    return {"actor": actor, "q1": q1, "q2": q2,
            "target_q1": _copy(q1), "target_q2": _copy(q2),
            "log_alpha": torch.zeros(())}


def actor_dist(actor: Dict[str, torch.Tensor], obs: torch.Tensor,
               action_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, log_std clipped to [-20, 2]) of the pre-tanh Gaussian."""
    out = _mlp(actor, obs.float())
    mean, log_std = out[..., :action_dim], out[..., action_dim:]
    return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)


def sample_action(actor: Dict[str, torch.Tensor], obs: torch.Tensor,
                  key: trandom.Key, action_dim: int, low: float, high: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reparameterized tanh-squashed Gaussian sample -> (action, logp).

    logp is the Gaussian's log-density of the pre-tanh sample, less the
    tanh correction in its softplus form, less the affine rescale's
    sum(log scale)."""
    mean, log_std = actor_dist(actor, obs, action_dim)
    std = torch.exp(log_std)
    eps = trandom.normal(key, mean.shape)
    pre_tanh = mean + std * eps
    tanh_a = torch.tanh(pre_tanh)
    logp = -0.5 * (eps ** 2 + 2 * log_std
                   + float(np.float32(np.log(2 * np.pi))))
    logp = logp - 2.0 * (float(np.float32(np.log(2.0))) - pre_tanh
                         - F.softplus(-2.0 * pre_tanh))
    logp = torch.sum(logp, dim=-1)
    scale = (high - low) / 2.0
    action = low + (tanh_a + 1.0) * scale
    log_scale = float(np.float32(np.log(np.float32(scale))))
    logp = logp - log_scale * tanh_a.shape[-1]
    return action, logp


def mean_action(actor: Dict[str, torch.Tensor], obs: torch.Tensor,
                action_dim: int, low: float, high: float) -> torch.Tensor:
    """The squashed mean: the deterministic action."""
    mean, _ = actor_dist(actor, obs, action_dim)
    return low + (torch.tanh(mean) + 1.0) * ((high - low) / 2.0)


def _q(params: Dict[str, torch.Tensor], obs: torch.Tensor,
       act: torch.Tensor) -> torch.Tensor:
    x = torch.cat([obs.float(), act.float()], dim=-1)
    return _mlp(params, x)[..., 0]


@torch.no_grad()
def polyak(target: Dict[str, torch.Tensor], online: Dict[str, torch.Tensor],
           tau: float) -> None:
    """target <- (1 - tau) * target + tau * online, in place."""
    for k, t in target.items():
        t.copy_((1 - tau) * t + tau * online[k])


class SACPolicy:
    """Stochastic tanh-Gaussian policy for rollouts, on ``device`` (the
    rollout workers ask for the CPU). Its parameters are the whole tree
    (critics too, as the JAX policy's), initialised from
    ``torch.Generator`` seed ``seed``; its key is ``PRNGKey(seed + 1)``,
    split once a stochastic ``compute_actions`` call as there."""

    def __init__(self, obs_shape: Tuple[int, ...], action_dim: int,
                 low: float, high: float, hidden=(256, 256), seed: int = 0,
                 device=None):
        self.device = default_device(device)
        self.obs_dim = int(np.prod(obs_shape))
        self.action_dim = action_dim
        self.low, self.high = float(low), float(high)
        params = init_sac_params(torch.Generator().manual_seed(seed),
                                 self.obs_dim, action_dim, hidden)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self._key = trandom.prng_key(seed + 1, self.device)

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray, deterministic: bool = False):
        obs = torch.as_tensor(np.asarray(obs, np.float32).reshape(
            len(obs), -1), device=self.device)
        if deterministic:
            actions = mean_action(self.params["actor"], obs,
                                  self.action_dim, self.low, self.high)
            logp = np.zeros(len(obs), np.float32)
        else:
            keys = trandom.split(self._key)
            self._key, sub = trandom.take(keys, 0), trandom.take(keys, 1)
            actions, lp = sample_action(self.params["actor"], obs, sub,
                                        self.action_dim, self.low,
                                        self.high)
            logp = lp.cpu().numpy().astype(np.float32)
        zeros = np.zeros(len(obs), np.float32)
        return actions.cpu().numpy().astype(np.float32), logp, zeros

    def get_weights(self) -> Dict:
        return rl_tree_to_numpy(self.params)

    def set_weights(self, weights: Dict) -> None:
        self.params = tree_map(lambda t: t.to(self.device),
                               rl_tree_from_numpy(weights))


class SACRolloutWorker(RolloutWorker):
    """Collects flat (s, a, r, s', done) transitions with float actions,
    [T * N] rows in time-major order."""

    def _make_policy(self, cfg: Dict, seed: int):
        return SACPolicy(self._connected_obs_shape, self.env.action_dim,
                         self.env.action_low, self.env.action_high,
                         hidden=cfg.get("hidden", (256, 256)), seed=seed,
                         device="cpu")

    def sample(self, rollout_length: int = 64) -> SampleBatch:
        n = self.env.num_envs
        shape = self._connected_obs_shape
        adim = self.env.action_dim
        obs_buf = np.empty((rollout_length, n) + shape, np.float32)
        nobs_buf = np.empty((rollout_length, n) + shape, np.float32)
        act_buf = np.empty((rollout_length, n, adim), np.float32)
        rew_buf = np.empty((rollout_length, n), np.float32)
        done_buf = np.empty((rollout_length, n), bool)
        for t in range(rollout_length):
            actions, _, _ = self.policy.compute_actions(self._obs)
            obs_buf[t] = self._obs
            act_buf[t] = actions.reshape(n, adim)
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


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self._algo_class = SAC
        self.env = "FastPendulum"
        self.lr = 3e-4
        self.rollout_fragment_length = 8
        self.train_batch_size = 256
        self.buffer_capacity = 100_000
        self.learning_starts = 1_000
        self.tau = 0.005  # polyak target rate
        self.num_updates_per_iter = 32
        self.initial_alpha = 1.0
        self.target_entropy: float = None  # default: -action_dim
        self.policy_hidden = (256, 256)

    def training(self, **kwargs) -> "SACConfig":
        for k in ("buffer_capacity", "learning_starts", "tau",
                  "num_updates_per_iter", "initial_alpha",
                  "target_entropy"):
            if k in kwargs:
                setattr(self, k, kwargs.pop(k))
        super().training(**kwargs)
        return self


def sac_losses(train: Tree, target_q1, target_q2, batch, key: trandom.Key,
               adim: int, low: float, high: float, gamma: float,
               target_entropy: float):
    """The three SAC losses at ``train`` = {actor, q1, q2, log_alpha}:
    (their sum, metrics). Stop-gradients as the JAX package's: the soft
    Bellman target (drawn from the current actor) takes none; the actor
    loss's critics are detached, the gradient flows through its sampled
    action; alpha is detached in the critic and actor losses, and
    ``log_alpha`` takes only its own loss."""
    actor = train["actor"]
    alpha = torch.exp(train["log_alpha"]).detach()
    keys = trandom.split(key)
    k1, k2 = trandom.take(keys, 0), trandom.take(keys, 1)
    with torch.no_grad():
        next_a, next_logp = sample_action(actor, batch[NEXT_OBS], k1, adim,
                                          low, high)
        tq = torch.minimum(_q(target_q1, batch[NEXT_OBS], next_a),
                           _q(target_q2, batch[NEXT_OBS], next_a))
        not_done = 1.0 - batch[DONES].float()
        target = batch[REWARDS] + gamma * not_done * (tq - alpha * next_logp)
    q1 = _q(train["q1"], batch[OBS], batch[ACTIONS])
    q2 = _q(train["q2"], batch[OBS], batch[ACTIONS])
    critic_loss = torch.mean((q1 - target) ** 2) + torch.mean(
        (q2 - target) ** 2)
    a, logp = sample_action(actor, batch[OBS], k2, adim, low, high)
    q_pi = torch.minimum(_q(detached(train["q1"]), batch[OBS], a),
                         _q(detached(train["q2"]), batch[OBS], a))
    actor_loss = torch.mean(alpha * logp - q_pi)
    alpha_loss = -torch.mean(train["log_alpha"]
                             * (logp + target_entropy).detach())
    total = critic_loss + actor_loss + alpha_loss
    return total, {"critic_loss": critic_loss, "actor_loss": actor_loss,
                   "alpha": alpha, "entropy": -torch.mean(logp)}


class SAC(Algorithm):
    """``training_step``: sample, add to replay, K updates, weights out.

    One update: the critic, actor and temperature losses summed, one Adam
    step over {actor, q1, q2, log_alpha}, then the polyak targets."""

    _worker_cls = SACRolloutWorker

    def setup(self, config: SACConfig) -> None:
        super().setup(config)
        env = self.workers.local_worker.env
        self.action_dim = env.action_dim
        low, high = float(env.action_low), float(env.action_high)
        self.buffer = ReplayBuffer(config.buffer_capacity, seed=config.seed)
        self.params = learner_tree(self.workers.local_worker.get_weights(),
                                   self.device)
        if config.initial_alpha != 1.0:
            with torch.no_grad():
                self.params["log_alpha"].fill_(
                    float(np.float32(np.log(config.initial_alpha))))
        target_entropy = (config.target_entropy
                          if config.target_entropy is not None
                          else -float(self.action_dim))
        self.optimizer = adam(config.lr)
        self.opt_state = self.optimizer.init(
            [p.detach() for p in tree_leaves(self._train(self.params))])
        self._num_updates = 0
        gamma, tau, adim = config.gamma, config.tau, self.action_dim

        def update(params, opt_state, batch, key):
            train = self._train(params)
            leaves = tree_leaves(train)
            with torch.enable_grad():
                total, aux = sac_losses(train, params["target_q1"],
                                        params["target_q2"], batch, key,
                                        adim, low, high, gamma,
                                        target_entropy)
                grads = torch.autograd.grad(total, leaves)
            opt_state = opt_step(leaves, grads, self.optimizer, opt_state)
            polyak(params["target_q1"], params["q1"], tau)
            polyak(params["target_q2"], params["q2"], tau)
            return params, opt_state, {k: v.detach() for k, v in aux.items()}

        self._update = update
        self._key = trandom.prng_key(config.seed + 17, self.device)

    @staticmethod
    def _train(params: Tree) -> Tree:
        return {k: params[k] for k in ("actor", "q1", "q2", "log_alpha")}

    def _next_key(self) -> trandom.Key:
        keys = trandom.split(self._key)
        self._key = trandom.take(keys, 0)
        return trandom.take(keys, 1)

    def _sync_weights(self, weights: Dict) -> None:
        self.workers.local_worker.set_weights(weights)
        self.workers.sync_weights(weights)

    def training_step(self) -> Dict:
        cfg = self.config
        new_steps = 0
        for b in self.workers.sample(cfg.rollout_fragment_length):
            self.buffer.add(b)
            new_steps += b.count
        self._timesteps_total += new_steps
        aux_out = {}
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.num_updates_per_iter):
                batch = self.buffer.sample(cfg.train_batch_size)
                device_batch = batch_to({k: v for k, v in batch.items()
                                         if k != "batch_indexes"},
                                        self.device)
                self.params, self.opt_state, aux = self._update(
                    self.params, self.opt_state, device_batch,
                    self._next_key())
                self._num_updates += 1
            aux_out = {k: float(v) for k, v in aux.items()}
            self._sync_weights(rl_tree_to_numpy(self.params))
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
            self._sync_weights(rl_tree_to_numpy(self.params))
        if "opt_state" in state:
            # A zeroed Adam state after resume causes a loss spike.
            self.opt_state = tree_map(
                lambda a: torch.from_numpy(np.array(a)).to(self.device),
                state["opt_state"], np.ndarray)
        if "rng_key" in state:
            self._key = key_from_numpy(state["rng_key"], self.device)

