"""Offline RL I/O and off-policy estimation: counterpart of the JAX
package's ``rllib/offline.py``.

``JsonWriter``/``JsonReader`` keep that module's on-disk format (one JSON
line a batch: ``{"columns": {name: nested lists}, "dtypes": {name: numpy
dtype}}``), so either package reads what the other wrote. The importance
sampling estimators are numpy and copied as they are. ``FittedQModel``,
the model of the direct-method and doubly-robust estimators, is a tanh
MLP trained with the port's Adam on ``default_device(device)``: the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Callable, Dict, Iterator, List

import numpy as np
import torch

from .. import random as trandom
from ..device import default_device
from ..models.convert import rl_tree_from_numpy, rl_tree_to_numpy
from ..train.optim import adam
from .algorithm import opt_step
from .sample_batch import (ACTIONS, DONES, LOGPS, NEXT_OBS, OBS, REWARDS,
                           SampleBatch)


class JsonWriter:
    """Appends SampleBatches to JSONL files (reference: JsonWriter)."""

    def __init__(self, path: str, max_file_size: int = 64 * 1024 * 1024):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._max = max_file_size
        self._index = 0
        self._file = None

    def _ensure_file(self):
        if self._file is None or self._file.tell() > self._max:
            if self._file is not None:
                self._file.close()
            self._index += 1
            self._file = open(os.path.join(
                self.path, f"output-{self._index:05d}.jsonl"), "a")
        return self._file

    def write(self, batch: SampleBatch) -> None:
        row = {k: np.asarray(v).tolist() for k, v in batch.items()}
        dtypes = {k: str(np.asarray(v).dtype) for k, v in batch.items()}
        f = self._ensure_file()
        f.write(json.dumps({"columns": row, "dtypes": dtypes}) + "\n")
        f.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class JsonReader:
    """Reads SampleBatches back from a JsonWriter directory (reference:
    JsonReader) — for offline training and off-policy evaluation."""

    def __init__(self, path: str):
        self.path = path

    def _files(self) -> List[str]:
        if os.path.isfile(self.path):
            return [self.path]
        return sorted(glob.glob(os.path.join(self.path, "*.jsonl")))

    def iter_batches(self) -> Iterator[SampleBatch]:
        for file in self._files():
            with open(file) as f:
                for line in f:
                    if not line.strip():
                        continue
                    entry = json.loads(line)
                    cols = entry["columns"]
                    dtypes = entry.get("dtypes", {})
                    yield SampleBatch({
                        k: np.asarray(v, dtype=dtypes.get(k))
                        for k, v in cols.items()
                    })

    def read_all(self) -> SampleBatch:
        batches = list(self.iter_batches())
        if not batches:
            raise ValueError(f"no batches under {self.path!r}")
        return SampleBatch.concat_samples(batches)


class OffPolicyEstimator:
    """Scores a TARGET policy on BEHAVIOR data (reference:
    ``offline/estimators/off_policy_estimator.py``).

    ``target_logp_fn(obs, actions) -> logp`` gives the target policy's
    log-prob of the logged actions; the batch's LOGPS column holds the
    behavior policy's. Batches are episode fragments: DONES splits
    episodes.
    """

    def __init__(self, target_logp_fn: Callable, gamma: float = 0.99):
        self._logp = target_logp_fn
        self.gamma = gamma

    def _episodes(self, batch: SampleBatch):
        """Split time-flat [T, ...] columns into per-episode slices
        (DONES marks episode ends)."""
        dones = np.asarray(batch[DONES]).reshape(-1)
        bounds = list(np.nonzero(dones)[0] + 1)
        if not bounds or bounds[-1] != len(dones):
            bounds.append(len(dones))
        start = 0
        for end in bounds:
            yield {k: np.asarray(v)[start:end] for k, v in batch.items()}
            start = end

    def _behavior_return(self, ep) -> float:
        rewards = np.asarray(ep[REWARDS], np.float64)
        return float(np.sum(self.gamma ** np.arange(len(rewards))
                            * rewards))

    def _episode_terms(self, ep) -> Dict[str, float]:
        rewards = ep[REWARDS].astype(np.float64)
        discounts = self.gamma ** np.arange(len(rewards))
        behavior_return = self._behavior_return(ep)
        target_logp = np.asarray(self._logp(ep[OBS], ep[ACTIONS]),
                                 np.float64)
        log_ratio = np.cumsum(target_logp - ep[LOGPS].astype(np.float64))
        weights = np.exp(np.clip(log_ratio, -30, 30))
        return {
            "behavior_return": behavior_return,
            "per_step_weights": weights,
            "discounted_rewards": discounts * rewards,
        }

    def estimate(self, batch: SampleBatch) -> Dict[str, float]:
        raise NotImplementedError


class ImportanceSampling(OffPolicyEstimator):
    """Ordinary per-decision IS (reference:
    ``offline/estimators/importance_sampling.py``): V_target =
    mean over episodes of sum_t w_t * gamma^t * r_t."""

    def estimate(self, batch: SampleBatch) -> Dict[str, float]:
        v_b, v_t, n = 0.0, 0.0, 0
        for ep in self._episodes(batch):
            terms = self._episode_terms(ep)
            v_b += terms["behavior_return"]
            v_t += float(np.sum(terms["per_step_weights"]
                                * terms["discounted_rewards"]))
            n += 1
        n = max(n, 1)
        v_b, v_t = v_b / n, v_t / n
        return {"v_behavior": v_b, "v_target": v_t,
                "v_gain": v_t / v_b if v_b else float("nan")}


class WeightedImportanceSampling(OffPolicyEstimator):
    """WIS (reference: ``weighted_importance_sampling.py``): per-step
    weights are normalized by their mean across episodes at each t —
    biased but far lower variance than ordinary IS."""

    def estimate(self, batch: SampleBatch) -> Dict[str, float]:
        episodes = [self._episode_terms(ep)
                    for ep in self._episodes(batch)]
        if not episodes:
            return {"v_behavior": 0.0, "v_target": 0.0,
                    "v_gain": float("nan")}
        max_t = max(len(e["per_step_weights"]) for e in episodes)
        # Mean weight per timestep across episodes (0-padded).
        sums = np.zeros(max_t)
        counts = np.zeros(max_t)
        for e in episodes:
            w = e["per_step_weights"]
            sums[:len(w)] += w
            counts[:len(w)] += 1
        mean_w = sums / np.maximum(counts, 1)
        v_b = v_t = 0.0
        for e in episodes:
            w = e["per_step_weights"]
            norm = w / np.maximum(mean_w[:len(w)], 1e-12)
            v_b += e["behavior_return"]
            v_t += float(np.sum(norm * e["discounted_rewards"]))
        n = len(episodes)
        v_b, v_t = v_b / n, v_t / n
        return {"v_behavior": v_b, "v_target": v_t,
                "v_gain": v_t / v_b if v_b else float("nan")}


class FittedQModel:
    """Fitted-Q evaluation (FQE): a small Q-network trained by Bellman
    backups under the TARGET policy's action distribution, the model of
    the direct-method and doubly-robust estimators (discrete actions).

    Its parameters are a list of ``{"w": [in, out], "b": [out]}`` layers
    on ``default_device(device)``, tanh between them. The weights are
    drawn as the JAX package draws them, ``normal(key) / sqrt(fan_in)``
    with a key split a layer from ``PRNGKey(seed)``, through
    ``random.normal`` (JAX's within its tolerance, not bit for bit)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden=(32, 32), lr: float = 5e-3, seed: int = 0,
                 device=None):
        self.device = default_device(device)
        self.num_actions = num_actions
        key = trandom.prng_key(seed)
        sizes = (obs_dim, *hidden, num_actions)
        params = []
        for i in range(len(sizes) - 1):
            keys = trandom.split(key)
            key, sub = trandom.take(keys, 0), trandom.take(keys, 1)
            w = trandom.normal(sub, (sizes[i], sizes[i + 1]))
            w = w / float(np.float32(np.sqrt(sizes[i])))
            params.append({"w": w, "b": torch.zeros(sizes[i + 1])})
        self.params = [{k: v.to(self.device).requires_grad_()
                        for k, v in layer.items()} for layer in params]
        self._opt = adam(lr)
        self._opt_state = self._opt.init(self._leaves())

    def _leaves(self):
        return [layer[k] for layer in self.params for k in ("b", "w")]

    @staticmethod
    def _q(params, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for layer in params[:-1]:
            x = torch.tanh(x @ layer["w"] + layer["b"])
        return x @ params[-1]["w"] + params[-1]["b"]  # [T, A]

    def _sgd(self, obs, act, y) -> torch.Tensor:
        leaves = self._leaves()
        with torch.enable_grad():
            q = self._q(self.params, obs)
            qa = q.gather(1, act[:, None])[:, 0]
            loss = torch.mean((qa - y) ** 2)
            grads = torch.autograd.grad(loss, leaves)
        self._opt_state = opt_step(leaves, grads, self._opt, self._opt_state)
        return loss.detach()

    @torch.no_grad()
    def fit(self, obs, actions, rewards, next_obs, dones, next_probs,
            gamma: float, backups: int = 20, sgd_per_backup: int = 25
            ) -> float:
        """Iterate Bellman backups: y = r + gamma*(1-d)*E_{a'~pi}Q(s',a')
        with Q frozen per backup, then regress. Returns final loss."""
        dev = self.device

        def on_dev(x, dtype):
            return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

        obs = on_dev(obs, torch.float32)
        actions = on_dev(actions, torch.int64)
        rewards = on_dev(rewards, torch.float32)
        next_obs = on_dev(next_obs, torch.float32)
        not_done = 1.0 - on_dev(dones, torch.float32)
        next_probs = on_dev(next_probs, torch.float32)
        loss = None
        for _ in range(backups):
            next_q = self._q(self.params, next_obs)
            next_v = torch.sum(next_probs * next_q, dim=1)
            y = rewards + gamma * not_done * next_v
            for _ in range(sgd_per_backup):
                loss = self._sgd(obs, actions, y)
        return float("nan") if loss is None else float(loss)

    @torch.no_grad()
    def q_values(self, obs) -> np.ndarray:
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        return self._q(self.params, obs).cpu().numpy()

    def v_values(self, obs, probs) -> np.ndarray:
        return np.sum(np.asarray(probs) * self.q_values(obs), axis=1)

    def get_weights(self) -> List[Dict[str, np.ndarray]]:
        """The layers as numpy, the JAX package's list of ``{"w", "b"}``."""
        return rl_tree_to_numpy(self.params)

    @torch.no_grad()
    def set_weights(self, layers: List[Dict[str, np.ndarray]]) -> None:
        """Numpy layers in the JAX layout copied into the parameters in
        place (the optimizer state stays theirs)."""
        new = rl_tree_from_numpy(layers)
        if len(new) != len(self.params):
            raise ValueError(f"{len(new)} layers for {len(self.params)}")
        for mine, theirs in zip(self.params, new):
            for k, p in mine.items():
                p.copy_(theirs[k])


class _ModelBasedEstimator(OffPolicyEstimator):
    """Shared FQE plumbing for DM/DR. ``target_probs_fn(obs) -> [T, A]``
    gives the target policy's full action distribution (needed both for
    Bellman backups and for E_{a~pi} Q(s, a)). The model is fitted on
    ``default_device(device)``."""

    def __init__(self, target_logp_fn: Callable, target_probs_fn: Callable,
                 num_actions: int, gamma: float = 0.99,
                 q_hidden=(32, 32), q_lr: float = 5e-3,
                 q_backups: int = 20, seed: int = 0, device=None):
        super().__init__(target_logp_fn, gamma)
        self._probs = target_probs_fn
        self.num_actions = num_actions
        self._q_hidden = q_hidden
        self._q_lr = q_lr
        self._q_backups = q_backups
        self._seed = seed
        self._device = device

    def _fit_q(self, batch: SampleBatch) -> FittedQModel:
        obs = np.asarray(batch[OBS], np.float32)
        next_obs = np.asarray(batch[NEXT_OBS], np.float32)
        model = FittedQModel(obs.shape[-1], self.num_actions,
                             hidden=self._q_hidden, lr=self._q_lr,
                             seed=self._seed, device=self._device)
        model.fit(obs, np.asarray(batch[ACTIONS]),
                  np.asarray(batch[REWARDS]), next_obs,
                  np.asarray(batch[DONES]),
                  np.asarray(self._probs(next_obs)), self.gamma,
                  backups=self._q_backups)
        return model


class DirectMethod(_ModelBasedEstimator):
    """DM (reference: ``offline/estimators/direct_method.py``):
    V_target = mean over episodes of E_{a~pi} Q_fqe(s0, a) — pure model
    extrapolation, zero variance from importance weights, biased by
    whatever the Q-model gets wrong."""

    def estimate(self, batch: SampleBatch) -> Dict[str, float]:
        model = self._fit_q(batch)
        v_b = v_t = 0.0
        n = 0
        for ep in self._episodes(batch):
            v_b += self._behavior_return(ep)
            s0 = np.asarray(ep[OBS][:1], np.float32)
            v_t += float(model.v_values(s0, self._probs(s0))[0])
            n += 1
        n = max(n, 1)
        v_b, v_t = v_b / n, v_t / n
        return {"v_behavior": v_b, "v_target": v_t,
                "v_gain": v_t / v_b if v_b else float("nan")}


class DoublyRobust(_ModelBasedEstimator):
    """DR (reference: ``offline/estimators/doubly_robust.py``; Jiang &
    Li 2016): the backward recursion
    ``v_t = V(s_t) + rho_t * (r_t + gamma * v_{t+1} - Q(s_t, a_t))``
    uses the FQE model as a control variate on importance sampling —
    unbiased when the behavior logps are correct, with variance bounded
    by the model's residuals instead of the raw returns."""

    def estimate(self, batch: SampleBatch) -> Dict[str, float]:
        model = self._fit_q(batch)
        v_b = v_t = 0.0
        n = 0
        for ep in self._episodes(batch):
            obs = np.asarray(ep[OBS], np.float32)
            acts = np.asarray(ep[ACTIONS]).astype(np.int64)
            rewards = np.asarray(ep[REWARDS], np.float64)
            probs = np.asarray(self._probs(obs), np.float64)
            q = model.q_values(obs).astype(np.float64)
            v_model = np.sum(probs * q, axis=1)
            q_taken = q[np.arange(len(acts)), acts]
            pi_a = probs[np.arange(len(acts)), acts]
            rho = pi_a / np.maximum(
                np.exp(np.asarray(ep[LOGPS], np.float64)), 1e-12)
            v = 0.0
            for t in range(len(rewards) - 1, -1, -1):
                v = v_model[t] + rho[t] * (
                    rewards[t] + self.gamma * v - q_taken[t])
            v_b += self._behavior_return(ep)
            v_t += float(v)
            n += 1
        n = max(n, 1)
        v_b, v_t = v_b / n, v_t / n
        return {"v_behavior": v_b, "v_target": v_t,
                "v_gain": v_t / v_b if v_b else float("nan")}
