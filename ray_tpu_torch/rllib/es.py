"""Evolution Strategies and Augmented Random Search: counterpart of the JAX
package's ``rllib/es.py``.

Antithetic Gaussian perturbations of one flat parameter vector, drawn as
slices of a noise table every process regenerates from one seed, so only
(index, return) pairs travel. ES shapes the returns by centered rank and
takes a numpy Adam step; ARS keeps the top-k directions and scales by the
returns' std. All of it runs on the CPU, as the JAX package pins its ES
workers to the CPU: the evaluation policy is a ``TorchPolicy`` on the CPU,
the update numpy. Evaluation workers are actors of the injected
``runtime`` when ``num_rollout_workers > 0``.

The flat vector is ordered as ``jax.flatten_util.ravel_pytree`` orders the
JAX policy's parameters (``models.convert.ravel_tree``: keys sorted, each
leaf row-major in the JAX layout), so a noise slice perturbs the same
parameters in both packages.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np

from ..models.convert import ravel_tree, unravel_tree
from .algorithm import _NO_RUNTIME, Algorithm, AlgorithmConfig
from .env import make_env
from .policy import TorchPolicy


class SharedNoiseTable:
    """Deterministic noise pool every process regenerates from one seed.
    Slices are perturbation vectors; only indices travel."""

    def __init__(self, size: int = 2_000_000, seed: int = 42):
        self.noise = np.random.default_rng(seed).standard_normal(
            size, dtype=np.float32)

    def get(self, idx: int, dim: int) -> np.ndarray:
        return self.noise[idx:idx + dim]

    def sample_index(self, rng: np.random.Generator, dim: int) -> int:
        return int(rng.integers(0, len(self.noise) - dim + 1))


def centered_ranks(x: np.ndarray) -> np.ndarray:
    """Fitness shaping: returns -> ranks in [-0.5, 0.5]."""
    ranks = np.empty(len(x), dtype=np.float32)
    ranks[x.argsort()] = np.arange(len(x), dtype=np.float32)
    if len(x) > 1:
        ranks = ranks / (len(x) - 1) - 0.5
    else:
        ranks[:] = 0.0
    return ranks


class ESEvalWorker:
    """Actor body: evaluates perturbed policies by whole-episode rollouts
    on the CPU."""

    def __init__(self, env_spec, policy_config: Optional[Dict] = None,
                 seed: int = 0, worker_index: int = 0,
                 noise_size: int = 2_000_000, noise_seed: int = 42):
        cfg = policy_config or {}
        self.env = make_env(env_spec, 1, seed + worker_index * 1000)
        self.policy = TorchPolicy(
            self.env.observation_space_shape, self.env.num_actions,
            hidden=cfg.get("hidden", (32, 32)), seed=seed, device="cpu")
        self._like = self.policy.get_weights()
        self.dim = int(ravel_tree(self._like).size)
        self.noise = SharedNoiseTable(noise_size, noise_seed)
        self.rng = np.random.default_rng(seed + worker_index * 7919 + 1)
        self._max_steps = cfg.get("max_episode_steps", 500)

    def param_dim(self) -> int:
        return self.dim

    def flat_params(self) -> np.ndarray:
        return ravel_tree(self.policy.get_weights())

    def _episode_return(self, flat: np.ndarray) -> Tuple[float, int]:
        self.policy.set_weights(unravel_tree(flat, self._like))
        obs = self.env.vector_reset(
            seed=int(self.rng.integers(0, 2 ** 31)))
        total, steps = 0.0, 0
        while steps < self._max_steps:
            a, _, _ = self.policy.compute_actions(obs, deterministic=True)
            obs, r, done, _ = self.env.vector_step(a)
            total += float(r[0])
            steps += 1
            if bool(done[0]):
                break
        return total, steps

    def do_rollouts(self, flat_params: np.ndarray, num_pairs: int,
                    sigma: float) -> Dict:
        """Antithetic pairs: evaluate theta +/- sigma * noise[idx]."""
        flat_params = np.asarray(flat_params, np.float32)
        indices, pos, neg, steps = [], [], [], 0
        for _ in range(num_pairs):
            idx = self.noise.sample_index(self.rng, self.dim)
            eps = self.noise.get(idx, self.dim)
            r_pos, s1 = self._episode_return(flat_params + sigma * eps)
            r_neg, s2 = self._episode_return(flat_params - sigma * eps)
            indices.append(idx)
            pos.append(r_pos)
            neg.append(r_neg)
            steps += s1 + s2
        return {"indices": indices, "pos": pos, "neg": neg,
                "steps": steps}

    def eval_policy(self, flat_params: np.ndarray,
                    episodes: int = 3) -> float:
        rets = [self._episode_return(np.asarray(flat_params,
                                                np.float32))[0]
                for _ in range(episodes)]
        return float(np.mean(rets))


class ESConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self._algo_class = ES
        self.num_rollout_workers = 2
        self.episodes_per_batch = 16  # antithetic pairs per iteration
        self.sigma = 0.05
        self.step_size = 0.02
        self.noise_size = 2_000_000
        self.policy_hidden = (32, 32)
        self.l2_coeff = 0.005

    def training(self, episodes_per_batch=None, sigma=None,
                 step_size=None, noise_size=None, l2_coeff=None,
                 **kwargs) -> "ESConfig":
        super().training(**kwargs)
        for name, val in [("episodes_per_batch", episodes_per_batch),
                          ("sigma", sigma), ("step_size", step_size),
                          ("noise_size", noise_size),
                          ("l2_coeff", l2_coeff)]:
            if val is not None:
                setattr(self, name, val)
        return self


class ES(Algorithm):
    """Learner: fan out rollout requests, combine the centered-rank
    weighted noise into one gradient, a numpy Adam step."""

    _is_ars = False

    def setup(self, config: ESConfig) -> None:
        # No WorkerSet: ES's workers evaluate a flat vector.
        policy_cfg = {"hidden": config.policy_hidden,
                      **config.policy_config_extra}
        n = max(0, config.num_rollout_workers)
        if n and self.runtime is None:
            raise ValueError(_NO_RUNTIME)
        self._local = ESEvalWorker(config.env, policy_cfg,
                                   seed=config.seed,
                                   noise_size=config.noise_size)
        self.dim = self._local.dim
        self.eval_workers = []
        if n:
            remote_cls = self.runtime.remote(ESEvalWorker)
            self.eval_workers = [
                remote_cls.options(num_cpus=1).remote(
                    config.env, policy_cfg, seed=config.seed,
                    worker_index=i + 1, noise_size=config.noise_size)
                for i in range(n)]
        self.flat_params = self._local.flat_params()
        self.noise = self._local.noise
        self._m = np.zeros(self.dim, np.float32)
        self._v = np.zeros(self.dim, np.float32)
        self._t = 0

    def _adam_step(self, grad: np.ndarray, lr: float) -> None:
        b1, b2, eps = 0.9, 0.999, 1e-8
        self._t += 1
        self._m = b1 * self._m + (1 - b1) * grad
        self._v = b2 * self._v + (1 - b2) * grad * grad
        mhat = self._m / (1 - b1 ** self._t)
        vhat = self._v / (1 - b2 ** self._t)
        self.flat_params = self.flat_params - lr * mhat / (
            np.sqrt(vhat) + eps)

    def _collect(self, num_pairs: int) -> Dict:
        cfg = self.config
        if self.eval_workers:
            rt = self.runtime
            per = max(1, num_pairs // len(self.eval_workers))
            ref = rt.put(self.flat_params)  # one copy, N readers
            results = rt.get([w.do_rollouts.remote(ref, per, cfg.sigma)
                              for w in self.eval_workers])
        else:
            results = [self._local.do_rollouts(self.flat_params,
                                               num_pairs, cfg.sigma)]
        out = {"indices": [], "pos": [], "neg": [], "steps": 0}
        for r in results:
            out["indices"].extend(r["indices"])
            out["pos"].extend(r["pos"])
            out["neg"].extend(r["neg"])
            out["steps"] += r["steps"]
        return out

    def training_step(self) -> Dict:
        cfg: ESConfig = self.config
        res = self._collect(cfg.episodes_per_batch)
        pos = np.asarray(res["pos"], np.float32)
        neg = np.asarray(res["neg"], np.float32)
        n = len(pos)
        # Centered ranks over all 2n returns, then the antithetic
        # difference per pair.
        shaped = centered_ranks(np.concatenate([pos, neg]))
        w = shaped[:n] - shaped[n:]
        grad = np.zeros(self.dim, np.float32)
        for wi, idx in zip(w, res["indices"]):
            grad += wi * self.noise.get(idx, self.dim)
        grad /= (n * cfg.sigma)
        grad -= cfg.l2_coeff * self.flat_params  # weight decay
        self._adam_step(-grad, cfg.step_size)  # ascend
        self._timesteps_total += res["steps"]
        return {
            "timesteps_this_iter": res["steps"],
            "episodes_this_iter": 2 * n,
            "episode_reward_mean": float(np.mean(
                np.concatenate([pos, neg]))),
            "grad_norm": float(np.linalg.norm(grad)),
        }

    def train(self) -> Dict:
        t0 = time.perf_counter()
        result = self.training_step()
        self.iteration += 1
        result.update({
            "training_iteration": self.iteration,
            "timesteps_total": self._timesteps_total,
            "time_this_iter_s": time.perf_counter() - t0,
        })
        return result

    def evaluate(self, episodes: int = 3) -> float:
        return self._local.eval_policy(self.flat_params, episodes)

    def get_state(self) -> Dict:
        return {"iteration": self.iteration,
                "timesteps_total": self._timesteps_total,
                "flat_params": self.flat_params,
                "m": self._m, "v": self._v, "t": self._t}

    def set_state(self, state: Dict) -> None:
        self.iteration = state.get("iteration", 0)
        self._timesteps_total = state.get("timesteps_total", 0)
        if "flat_params" in state:
            self.flat_params = np.asarray(state["flat_params"], np.float32)
        self._m = state.get("m", self._m)
        self._v = state.get("v", self._v)
        self._t = state.get("t", self._t)

    def stop(self) -> None:
        for w in self.eval_workers:
            try:
                self.runtime.kill(w)
            except Exception:  # an actor already gone is what stop wants
                pass


class ARSConfig(ESConfig):
    def __init__(self):
        super().__init__()
        self._algo_class = ARS
        self.top_k: Optional[int] = None  # default: every direction
        self.sigma = 0.05
        self.step_size = 0.05

    def training(self, top_k=None, **kwargs) -> "ARSConfig":
        if top_k is not None:
            self.top_k = top_k
        super().training(**kwargs)
        return self


class ARS(ES):
    """ARS V1-t: the top_k directions by max(r+, r-), weighted by the raw
    return difference, the step scaled by the std of the used returns."""

    _is_ars = True

    def training_step(self) -> Dict:
        cfg: ARSConfig = self.config
        res = self._collect(cfg.episodes_per_batch)
        pos = np.asarray(res["pos"], np.float32)
        neg = np.asarray(res["neg"], np.float32)
        n = len(pos)
        k = min(cfg.top_k or n, n)
        order = np.argsort(-np.maximum(pos, neg))[:k]
        used = np.concatenate([pos[order], neg[order]])
        sigma_r = float(used.std()) + 1e-8
        grad = np.zeros(self.dim, np.float32)
        for i in order:
            grad += (pos[i] - neg[i]) * self.noise.get(
                res["indices"][i], self.dim)
        grad /= (k * sigma_r)
        self._adam_step(-grad, cfg.step_size)
        self._timesteps_total += res["steps"]
        return {
            "timesteps_this_iter": res["steps"],
            "episodes_this_iter": 2 * n,
            "episode_reward_mean": float(np.mean(
                np.concatenate([pos, neg]))),
            "grad_norm": float(np.linalg.norm(grad)),
        }
