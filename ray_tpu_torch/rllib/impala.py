"""IMPALA: counterpart of the JAX package's ``rllib/impala.py``.

Rollout workers sample on; the learner corrects for their policy lag with
V-trace (Espeholt et al. 2018) and sends each worker fresh weights as its
fragment is consumed. With remote workers the loop waits on whichever
fragment is ready first through the injected runtime's ``wait``; with none
it samples synchronously from the local worker. The learner's parameters
are a copy on its device; the local worker keeps its CPU copy.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..models.convert import ppo_tree_to_numpy
from ..train.optim import adam, chain, clip_by_global_norm
from .algorithm import (Algorithm, AlgorithmConfig, batch_to, sgd_step,
                        to_learner)
from .catalog import scan_sequence
from .policy import Params, forward_mlp
from .sample_batch import (ACTIONS, DONES, LOGPS, OBS, REWARDS, STATE_IN,
                           SampleBatch)


@torch.no_grad()
def vtrace(behavior_logp, target_logp, rewards, dones, values, bootstrap,
           gamma: float, rho_clip: float = 1.0, c_clip: float = 1.0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """V-trace targets and policy-gradient advantages, detached.

    Inputs time-major [T, B]; ``bootstrap`` [B] is V(x_T) under the target
    policy. ``rho`` and ``c`` are clipped separately; the reverse
    recursion ``acc_t = delta_t + gamma * not_done_t * c_t * acc_{t+1}``
    is a loop over T. Returns (vs, pg_advantages), both [T, B]."""
    rho = torch.exp(target_logp - behavior_logp)
    rho_c = torch.clamp_max(rho, rho_clip)
    c = torch.clamp_max(rho, c_clip)
    not_done = 1.0 - dones.float()
    next_values = torch.cat([values[1:], bootstrap[None]])
    deltas = rho_c * (rewards + gamma * not_done * next_values - values)
    vs_minus_v = torch.empty_like(deltas)
    acc = torch.zeros_like(bootstrap)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + gamma * not_done[t] * c[t] * acc
        vs_minus_v[t] = acc
    vs = values + vs_minus_v
    vs_next = torch.cat([vs[1:], bootstrap[None]])
    pg_adv = rho_c * (rewards + gamma * not_done * vs_next - values)
    return vs, pg_adv


def forward_feedforward(params: Params, batch, apply_fn: Callable):
    """The target policy over a time-major [T, B] batch: (log-softmax
    [T, B, A], values [T, B], bootstrap values of ``final_obs`` [B])."""
    obs = batch[OBS]
    t_len, n = obs.shape[:2]
    logits, values = apply_fn(params, obs.reshape((t_len * n,)
                                                  + obs.shape[2:]))
    logits = logits.reshape(t_len, n, -1)
    values = values.reshape(t_len, n)
    _, bootstrap = apply_fn(params, batch["final_obs"])
    return torch.log_softmax(logits, dim=-1), values, bootstrap


def forward_recurrent(params: Params, batch, apply_state: Callable):
    """The recurrent target policy (recurrent V-trace): the cell over T
    from STATE_IN, the behaviour policy's state at the fragment's start,
    zeroed at episode ends; the bootstrap value runs ``final_obs`` through
    the state after the last step."""
    logits, values, state = scan_sequence(apply_state, params, batch[OBS],
                                          batch[DONES],
                                          tuple(batch[STATE_IN]))
    _, bootstrap, _ = apply_state(params, batch["final_obs"], state)
    return torch.log_softmax(logits, dim=-1), values, bootstrap


def _target(params, batch, apply_fn, forward):
    """(logp_all, values, bootstrap, the taken actions' logp)."""
    if forward is None:
        forward = functools.partial(forward_feedforward, apply_fn=apply_fn)
    logp_all, values, bootstrap = forward(params, batch)
    target_logp = logp_all.gather(
        -1, batch[ACTIONS].long()[..., None])[..., 0]
    return logp_all, values, bootstrap, target_logp


def impala_loss(params: Params, batch, gamma: float, vf_coeff: float,
                ent_coeff: float, apply_fn: Callable = forward_mlp,
                forward: Callable = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: time-major [T, B] columns and ``final_obs`` [B, ...] (and
    STATE_IN [S, B, cell] on the recurrent path)."""
    logp_all, values, bootstrap, target_logp = _target(params, batch,
                                                       apply_fn, forward)
    vs, pg_adv = vtrace(batch[LOGPS], target_logp, batch[REWARDS],
                        batch[DONES], values, bootstrap, gamma)
    pg_loss = -(target_logp * pg_adv).mean()
    vf_loss = 0.5 * ((values - vs) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    loss = pg_loss + vf_coeff * vf_loss - ent_coeff * entropy
    return loss, {"pg_loss": pg_loss, "vf_loss": vf_loss,
                  "entropy": entropy}


class ImpalaConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self._algo_class = Impala
        self.lr = 5e-4
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.01
        self.rollout_fragment_length = 64
        self.num_batches_per_iter = 8  # learner updates per train() call
        self.grad_clip = 40.0

    def training(self, **kwargs) -> "ImpalaConfig":
        for k in ("vf_coeff", "entropy_coeff", "num_batches_per_iter",
                  "grad_clip"):
            if k in kwargs:
                setattr(self, k, kwargs.pop(k))
        super().training(**kwargs)
        return self


class Impala(Algorithm):
    """The actor-learner loop: one ``sample`` in flight per remote worker;
    the first ready is consumed (``runtime.wait(num_returns=1)``), learned
    on, its worker sent fresh weights and set sampling again."""

    def setup(self, config: ImpalaConfig) -> None:
        super().setup(config)
        self.params = to_learner(self.workers.local_worker.get_weights(),
                                 self.device)
        self.optimizer = chain(clip_by_global_norm(config.grad_clip),
                               adam(config.lr))
        self.opt_state = self.optimizer.init(
            [p.detach() for p in self.params.values()])
        self._num_updates = 0
        self._in_flight: Dict = {}  # ref -> worker
        loss_fn = self._make_loss()

        def update(params, opt_state, batch):
            loss, aux, opt_state = sgd_step(
                params, opt_state, self.optimizer,
                lambda p: loss_fn(p, batch))
            return params, opt_state, loss, aux

        self._update = update

    def _make_forward(self) -> Callable:
        """The target-policy forward for the model: recurrent models scan
        (recurrent V-trace)."""
        net = self.workers.local_worker.policy.net
        if net.is_recurrent:
            return functools.partial(forward_recurrent,
                                     apply_state=net.apply_state)
        return functools.partial(forward_feedforward, apply_fn=net.apply)

    def _make_loss(self) -> Callable:
        """``loss(params, batch) -> (loss, aux)``; APPO swaps it."""
        cfg = self.config
        return functools.partial(
            impala_loss, gamma=cfg.gamma, vf_coeff=cfg.vf_coeff,
            ent_coeff=cfg.entropy_coeff, forward=self._make_forward())

    def _learn_on(self, batch: SampleBatch) -> Tuple[float, Dict]:
        device_batch = batch_to({k: v for k, v in batch.items()
                                 if k != "last_values"}, self.device)
        self.params, self.opt_state, loss, metrics = self._update(
            self.params, self.opt_state, device_batch)
        self._num_updates += 1
        return float(loss), metrics

    def training_step(self) -> Dict:
        cfg = self.config
        new_steps = 0
        losses: List[float] = []
        if not self.workers.remote_workers:
            # Synchronous: the V-trace learner on the local worker's
            # fragments.
            for _ in range(cfg.num_batches_per_iter):
                batch = self.workers.local_worker.sample(
                    cfg.rollout_fragment_length)
                new_steps += batch[OBS].shape[0] * batch[OBS].shape[1]
                loss, _ = self._learn_on(batch)
                losses.append(loss)
                self.workers.local_worker.set_weights(
                    ppo_tree_to_numpy(self.params))
        else:
            rt = self.runtime
            for w in self.workers.remote_workers:
                if not any(worker is w for worker in
                           self._in_flight.values()):
                    self._in_flight[w.sample.remote(
                        cfg.rollout_fragment_length)] = w
            for _ in range(cfg.num_batches_per_iter):
                ready, _ = rt.wait(list(self._in_flight), num_returns=1,
                                   timeout=60)
                if not ready:
                    break
                ref = ready[0]
                worker = self._in_flight.pop(ref)
                batch = rt.get(ref)
                new_steps += batch[OBS].shape[0] * batch[OBS].shape[1]
                loss, _ = self._learn_on(batch)
                losses.append(loss)
                # Fresh weights to this worker only, which samples on;
                # the others never wait on the update.
                worker.set_weights.remote(rt.put(ppo_tree_to_numpy(
                    self.params)))
                self._in_flight[worker.sample.remote(
                    cfg.rollout_fragment_length)] = worker
            self.workers.local_worker.set_weights(
                ppo_tree_to_numpy(self.params))
        self._timesteps_total += new_steps
        return {
            "timesteps_this_iter": new_steps,
            "num_learner_updates": self._num_updates,
            "loss": float(np.mean(losses)) if losses else None,
        }

    def get_state(self) -> Dict:
        state = super().get_state()
        state.update({"params": ppo_tree_to_numpy(self.params),
                      "num_updates": self._num_updates})
        return state

    def set_state(self, state: Dict) -> None:
        super().set_state(state)
        if "params" in state:
            self._set_learner_params(state["params"])
            self._num_updates = state.get("num_updates", 0)

    def stop(self) -> None:
        self._in_flight.clear()
        super().stop()
