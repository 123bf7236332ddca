"""APPO: counterpart of the JAX package's ``rllib/appo.py``.

IMPALA's actor-learner loop with PPO's clipped surrogate over the V-trace
advantages, so that lagged rollouts cannot push the policy arbitrarily
far. Only the loss differs from ``Impala``.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import torch

from .impala import Impala, ImpalaConfig, _target, vtrace
from .policy import Params, forward_mlp
from .sample_batch import DONES, LOGPS, REWARDS


def appo_loss(params: Params, batch, gamma: float, vf_coeff: float,
              ent_coeff: float, clip_param: float,
              apply_fn: Callable = forward_mlp, forward: Callable = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """IMPALA's loss with the clipped surrogate on V-trace advantages."""
    logp_all, values, bootstrap, target_logp = _target(params, batch,
                                                       apply_fn, forward)
    vs, pg_adv = vtrace(batch[LOGPS], target_logp, batch[REWARDS],
                        batch[DONES], values, bootstrap, gamma)
    ratio = torch.exp(target_logp - batch[LOGPS])
    surr = torch.minimum(
        ratio * pg_adv,
        torch.clamp(ratio, 1.0 - clip_param, 1.0 + clip_param) * pg_adv)
    pg_loss = -surr.mean()
    vf_loss = 0.5 * ((values - vs) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    loss = pg_loss + vf_coeff * vf_loss - ent_coeff * entropy
    return loss, {"pg_loss": pg_loss, "vf_loss": vf_loss,
                  "entropy": entropy}


class APPOConfig(ImpalaConfig):
    def __init__(self):
        super().__init__()
        self._algo_class = APPO
        self.clip_param = 0.2

    def training(self, **kwargs) -> "APPOConfig":
        if "clip_param" in kwargs:
            self.clip_param = kwargs.pop("clip_param")
        super().training(**kwargs)
        return self


class APPO(Impala):
    """Impala's loop and learner; the clipped loss."""

    def _make_loss(self) -> Callable:
        cfg = self.config
        return functools.partial(
            appo_loss, gamma=cfg.gamma, vf_coeff=cfg.vf_coeff,
            ent_coeff=cfg.entropy_coeff, clip_param=cfg.clip_param,
            forward=self._make_forward())
