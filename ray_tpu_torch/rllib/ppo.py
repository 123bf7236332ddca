"""PPO: counterpart of the JAX package's ``rllib/ppo.py``.

``training_step`` samples from the rollout workers (CPU), computes GAE on
the host, runs the SGD phase on the learner's device and sends the new
weights back. The JAX package compiles the SGD phase as ``lax.scan`` over
minibatches inside ``lax.scan`` over epochs; here they are plain loops on
the device, over the same minibatches: each epoch's permutation is
``jax.random.permutation`` of the epoch's key (``ray_tpu_torch.random``),
the keys split as there.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import random as trandom
from ..models.convert import ppo_tree_to_numpy
from ..train.optim import adam, chain, clip_by_global_norm
from .algorithm import (Algorithm, AlgorithmConfig, batch_to, sgd_step,
                        to_learner)
from .catalog import scan_sequence
from .policy import Params, forward_mlp
from .sample_batch import (ACTIONS, ADVANTAGES, DONES, LOGPS, OBS, STATE_IN,
                           VALUE_TARGETS, SampleBatch, compute_gae,
                           flatten_time_major)


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self._algo_class = PPO
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.num_sgd_iter = 8
        self.sgd_minibatch_size = 256
        self.lambda_ = 0.95
        self.grad_clip = 0.5

    def training(self, clip_param=None, vf_loss_coeff=None,
                 entropy_coeff=None, num_sgd_iter=None,
                 sgd_minibatch_size=None, lambda_=None, **kwargs
                 ) -> "PPOConfig":
        super().training(**kwargs)
        for name, val in [("clip_param", clip_param),
                          ("vf_loss_coeff", vf_loss_coeff),
                          ("entropy_coeff", entropy_coeff),
                          ("num_sgd_iter", num_sgd_iter),
                          ("sgd_minibatch_size", sgd_minibatch_size),
                          ("lambda_", lambda_)]:
            if val is not None:
                setattr(self, name, val)
        return self


def ppo_loss(params: Params, batch: Dict[str, torch.Tensor],
             clip_param: float, vf_clip: float, vf_coeff: float,
             ent_coeff: float, apply_fn: Callable = forward_mlp,
             batch_apply: Optional[Callable] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped surrogate plus clipped value loss minus the entropy bonus,
    with the minibatch's advantages normalised by their mean and
    population std; returns (total, {policy_loss, vf_loss, entropy, kl}).
    ``batch_apply(params, batch) -> (logits, values)`` replaces
    ``apply_fn`` where set (recurrent networks read DONES and STATE_IN);
    the columns may have any leading dimensions."""
    if batch_apply is not None:
        logits, values = batch_apply(params, batch)
    else:
        logits, values = apply_fn(params, batch[OBS])
    logp_all = torch.log_softmax(logits, dim=-1)
    actions = batch[ACTIONS].long()
    logp = logp_all.gather(-1, actions[..., None])[..., 0]
    ratio = torch.exp(logp - batch[LOGPS])
    adv = batch[ADVANTAGES]
    adv = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
    surrogate = torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv)
    policy_loss = -surrogate.mean()
    vf_err = torch.clamp(values - batch[VALUE_TARGETS], -vf_clip, vf_clip)
    vf_loss = (vf_err ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    total = policy_loss + vf_coeff * vf_loss - ent_coeff * entropy
    return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                   "entropy": entropy, "kl": (batch[LOGPS] - logp).mean()}


def _build_sgd_loop(config: PPOConfig, optimizer, num_items: Callable,
                    minibatches: Callable, loss_kwargs: Dict) -> Callable:
    """The SGD phase shared by the flat and the recurrent update: epochs
    over a fresh permutation each (``jax.random.permutation`` of
    ``split(key, epochs)[e]``), minibatches of it (``minibatches(batch,
    perm)``), one optimizer step each. ``update(params, opt_state, batch,
    key) -> (params, opt_state, metrics)``: the parameters updated in
    place, the metrics the last minibatch's loss and aux as device
    scalars."""
    coeffs = (config.clip_param, config.vf_clip_param, config.vf_loss_coeff,
              config.entropy_coeff)
    epochs = config.num_sgd_iter

    def update(params, opt_state, batch, key):
        perms = trandom.permutation(trandom.split(key, epochs),
                                    num_items(batch))
        for e in range(epochs):
            for mb in minibatches(batch, perms[e]):
                loss, aux, opt_state = sgd_step(
                    params, opt_state, optimizer,
                    lambda p: ppo_loss(p, mb, *coeffs, **loss_kwargs))
        return params, opt_state, {"total_loss": loss, **aux}

    return update


def build_ppo_update(config: PPOConfig, optimizer,
                     apply_fn: Callable = forward_mlp) -> Callable:
    """Flat-batch PPO update: minibatches are rows of [B, ...], the first
    ``B // sgd_minibatch_size`` whole minibatches of each permutation."""
    size = config.sgd_minibatch_size

    def minibatches(batch, perm):
        for m in range(max(1, perm.shape[0] // size)):
            idx = perm[m * size:(m + 1) * size]
            yield {k: v[idx] for k, v in batch.items()}

    return _build_sgd_loop(config, optimizer, lambda b: b[OBS].shape[0],
                           minibatches, {"apply_fn": apply_fn})


def build_ppo_update_recurrent(config: PPOConfig, optimizer, net
                               ) -> Callable:
    """Recurrent PPO: the columns are sequence-major [T, N, ...], plus
    STATE_IN [S, N, cell]; a minibatch is whole sequences (columns of
    N), ``max(1, sgd_minibatch_size // T)`` of them, and the loss runs
    the cell over T from the state the behaviour policy had at the
    fragment's start, zeroing it where an episode ended."""
    size = config.sgd_minibatch_size

    def seq_apply(params, batch):
        state = tuple(batch[STATE_IN])
        logits, values, _ = scan_sequence(net.apply_state, params,
                                          batch[OBS], batch[DONES], state)
        return logits, values

    def minibatches(batch, perm):
        t, n = batch[OBS].shape[:2]
        mb = max(1, min(max(1, size // t), n))
        for m in range(max(1, n // mb)):
            idx = perm[m * mb:(m + 1) * mb]
            yield {k: v[:, idx] for k, v in batch.items()}

    return _build_sgd_loop(config, optimizer, lambda b: b[OBS].shape[1],
                           minibatches, {"apply_fn": None,
                                         "batch_apply": seq_apply})


class PPO(Algorithm):
    def setup(self, config: PPOConfig) -> None:
        super().setup(config)
        self.optimizer = chain(clip_by_global_norm(config.grad_clip),
                               adam(config.lr))
        # The learner's copy of the policy's parameters, on its device.
        self.params = to_learner(self.workers.local_worker.get_weights(),
                                 self.device)
        self.opt_state = self.optimizer.init(
            [p.detach() for p in self.params.values()])
        net = self.workers.local_worker.policy.net
        self._recurrent = net.is_recurrent
        if self._recurrent:
            self._update = build_ppo_update_recurrent(config, self.optimizer,
                                                      net)
        else:
            self._update = build_ppo_update(config, self.optimizer,
                                            net.apply)
        self._rng = trandom.prng_key(config.seed, self.device)
        self.workers.sync_weights(ppo_tree_to_numpy(self.params))

    def training_step(self) -> Dict:
        """Sample, GAE, the SGD phase on the learner, weights out."""
        cfg: PPOConfig = self.config
        processed = []
        for frag in self.workers.sample(cfg.rollout_fragment_length):
            last_values = frag.pop("last_values")
            frag.pop("final_obs", None)  # IMPALA's bootstrap column
            frag = compute_gae(frag, last_values, cfg.gamma, cfg.lambda_)
            if not self._recurrent:
                frag = flatten_time_major(frag)
            processed.append(frag)
        if self._recurrent:
            # Sequence-major [T, N] (and STATE_IN [S, N, cell]): fragments
            # join on the env axis.
            host = {k: np.concatenate([f[k] for f in processed], axis=1)
                    for k in (OBS, ACTIONS, LOGPS, ADVANTAGES, VALUE_TARGETS,
                              DONES, STATE_IN)}
            steps = int(host[OBS].shape[0] * host[OBS].shape[1])
        else:
            train_batch = SampleBatch.concat_samples(processed)
            steps = train_batch.count
            host = {k: train_batch[k] for k in (OBS, ACTIONS, LOGPS,
                                                ADVANTAGES, VALUE_TARGETS)}
        batch = batch_to(host, self.device)
        self._timesteps_total += steps
        keys = trandom.split(self._rng)
        self._rng, sub = trandom.take(keys, 0), trandom.take(keys, 1)
        self.params, self.opt_state, metrics = self._update(
            self.params, self.opt_state, batch, sub)
        weights = ppo_tree_to_numpy(self.params)
        self.workers.local_worker.set_weights(weights)
        self.workers.sync_weights(weights)
        out = {k: float(v) for k, v in metrics.items()}
        out["timesteps_this_iter"] = steps
        return out

    def get_state(self) -> Dict:
        state = super().get_state()
        state["params"] = ppo_tree_to_numpy(self.params)
        return state

    def set_state(self, state: Dict) -> None:
        super().set_state(state)
        if "params" in state:
            self._set_learner_params(state["params"])

    def compute_single_action(self, obs, deterministic: bool = True) -> int:
        actions, _, _ = self.workers.local_worker.policy.compute_actions(
            np.asarray(obs)[None], deterministic=deterministic)
        return int(actions[0])
