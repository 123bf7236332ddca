"""A2C: counterpart of the JAX package's ``rllib/a2c.py``.

Synchronous advantage actor-critic: sample, then ONE gradient step on the
plain policy-gradient surrogate (no ratio clipping, no SGD epochs) on the
learner's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..models.convert import ppo_tree_to_numpy
from ..train.optim import adam, chain, clip_by_global_norm
from .algorithm import (Algorithm, AlgorithmConfig, batch_to, sgd_step,
                        to_learner, tree_map)
from .policy import Params
from .sample_batch import (ACTIONS, ADVANTAGES, OBS, VALUE_TARGETS,
                           SampleBatch, compute_gae, flatten_time_major)


class A2CConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self._algo_class = A2C
        self.lr = 1e-3
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.lambda_ = 1.0  # plain n-step returns
        self.grad_clip = 0.5
        self.rollout_fragment_length = 20
        self.num_envs_per_worker = 16

    def training(self, vf_loss_coeff=None, entropy_coeff=None,
                 lambda_=None, grad_clip=None, **kwargs) -> "A2CConfig":
        super().training(**kwargs)
        for name, val in [("vf_loss_coeff", vf_loss_coeff),
                          ("entropy_coeff", entropy_coeff),
                          ("lambda_", lambda_), ("grad_clip", grad_clip)]:
            if val is not None:
                setattr(self, name, val)
        return self


def a2c_loss(params: Params, batch: Dict[str, torch.Tensor],
             vf_coeff: float, ent_coeff: float, apply_fn: Callable
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-mean(logp * normalised advantage) + vf_coeff * value MSE -
    ent_coeff * entropy; no importance ratio (the batch is on-policy)."""
    logits, values = apply_fn(params, batch[OBS])
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, batch[ACTIONS].long()[..., None])[..., 0]
    adv = batch[ADVANTAGES]
    adv = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
    policy_loss = -(logp * adv).mean()
    vf_loss = ((values - batch[VALUE_TARGETS]) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    total = policy_loss + vf_coeff * vf_loss - ent_coeff * entropy
    return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                   "entropy": entropy}


class A2C(Algorithm):
    def setup(self, config: A2CConfig) -> None:
        super().setup(config)
        self.optimizer = chain(clip_by_global_norm(config.grad_clip),
                               adam(config.lr))
        self.params = to_learner(self.workers.local_worker.get_weights(),
                                 self.device)
        self.opt_state = self.optimizer.init(
            [p.detach() for p in self.params.values()])
        apply_fn = self.workers.local_worker.policy.net.apply
        vfc, eco = config.vf_loss_coeff, config.entropy_coeff

        def update(params, opt_state, batch):
            loss, aux, opt_state = sgd_step(
                params, opt_state, self.optimizer,
                lambda p: a2c_loss(p, batch, vfc, eco, apply_fn))
            return params, opt_state, {"total_loss": loss, **aux}

        self._update = update
        self.workers.sync_weights(ppo_tree_to_numpy(self.params))

    def training_step(self) -> Dict:
        cfg: A2CConfig = self.config
        processed = []
        for frag in self.workers.sample(cfg.rollout_fragment_length):
            last_values = frag.pop("last_values")
            frag.pop("final_obs", None)
            frag = compute_gae(frag, last_values, cfg.gamma, cfg.lambda_)
            processed.append(flatten_time_major(frag))
        batch = SampleBatch.concat_samples(processed)
        steps = batch.count
        self._timesteps_total += steps
        device_batch = batch_to({k: batch[k] for k in (
            OBS, ACTIONS, ADVANTAGES, VALUE_TARGETS)}, self.device)
        self.params, self.opt_state, metrics = self._update(
            self.params, self.opt_state, device_batch)
        weights = ppo_tree_to_numpy(self.params)
        self.workers.local_worker.set_weights(weights)
        self.workers.sync_weights(weights)
        out = {k: float(v) for k, v in metrics.items()}
        out["timesteps_this_iter"] = steps
        return out

    def get_state(self) -> Dict:
        state = super().get_state()
        state["params"] = ppo_tree_to_numpy(self.params)
        state["opt_state"] = tree_map(lambda t: t.cpu().numpy(),
                                      self.opt_state)
        return state

    def set_state(self, state: Dict) -> None:
        super().set_state(state)
        if "params" in state:
            self._set_learner_params(state["params"])
        if "opt_state" in state:
            self.opt_state = tree_map(
                lambda a: torch.from_numpy(a.copy()).to(self.device),
                state["opt_state"], np.ndarray)

