"""PPO's loss: counterpart of ``ppo_loss`` in the JAX package's
``rllib/ppo.py``. ``PPOConfig`` and the actor-based ``PPO`` come with the
rollout workers."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from .policy import Params, forward_mlp
from .sample_batch import ACTIONS, ADVANTAGES, LOGPS, OBS, VALUE_TARGETS


def ppo_loss(params: Params, batch: Dict[str, torch.Tensor],
             clip_param: float, vf_clip: float, vf_coeff: float,
             ent_coeff: float, apply_fn: Callable = forward_mlp
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped surrogate plus clipped value loss minus the entropy bonus,
    with the minibatch's advantages normalised by their mean and
    population std; returns (total, {policy_loss, vf_loss, entropy, kl})."""
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
