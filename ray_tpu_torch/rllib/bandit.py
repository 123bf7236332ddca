"""A copy of the JAX package's ``rllib/bandit.py`` (numpy only),
kept here because the port imports nothing of that package. Its
docstring:

Contextual bandits: LinUCB and linear Thompson sampling.

Reference analog: ``rllib/algorithms/bandit/bandit.py`` +
``bandit_torch_model.py`` (DiscreteLinearModelUCB /
DiscreteLinearModelThompsonSampling) — per-arm ridge regression
posteriors updated online; exploration via UCB bonus or posterior
sampling. Pure closed-form linear algebra (Sherman-Morrison rank-1
precision updates), no gradient loop.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class _LinearArm:
    """Ridge posterior for one arm: A = lam*I + sum(x x^T),
    b = sum(r x); theta = A^-1 b. A_inv maintained by Sherman-Morrison
    (reference: bandit_torch_model.py OnlineLinearRegression)."""

    def __init__(self, dim: int, lam: float = 1.0):
        self.dim = dim
        self.a_inv = np.eye(dim, dtype=np.float64) / lam
        self.b = np.zeros(dim, np.float64)
        self.theta = np.zeros(dim, np.float64)
        self.count = 0

    def update(self, x: np.ndarray, reward: float) -> None:
        x = np.asarray(x, np.float64)
        av = self.a_inv @ x
        self.a_inv -= np.outer(av, av) / (1.0 + x @ av)
        self.b += reward * x
        self.theta = self.a_inv @ self.b
        self.count += 1

    def ucb(self, x: np.ndarray, alpha: float) -> float:
        x = np.asarray(x, np.float64)
        return float(self.theta @ x
                     + alpha * np.sqrt(max(x @ self.a_inv @ x, 0.0)))

    def sample(self, x: np.ndarray, rng: np.random.Generator,
               nu: float) -> float:
        x = np.asarray(x, np.float64)
        theta_s = rng.multivariate_normal(
            self.theta, nu ** 2 * self.a_inv, method="cholesky")
        return float(theta_s @ x)


class LinUCB:
    """Disjoint LinUCB (Li et al. 2010): pick the arm maximizing
    theta_a^T x + alpha * sqrt(x^T A_a^-1 x)."""

    def __init__(self, num_arms: int, context_dim: int,
                 alpha: float = 1.0, lam: float = 1.0):
        self.arms = [_LinearArm(context_dim, lam)
                     for _ in range(num_arms)]
        self.alpha = alpha

    def select_arm(self, context: np.ndarray) -> int:
        scores = [arm.ucb(context, self.alpha) for arm in self.arms]
        return int(np.argmax(scores))

    def update(self, context: np.ndarray, arm: int,
               reward: float) -> None:
        self.arms[arm].update(context, reward)


class LinTS:
    """Linear Thompson sampling: sample theta_a ~ N(theta_a, nu^2
    A_a^-1), pick argmax theta_s^T x (Agrawal & Goyal 2013)."""

    def __init__(self, num_arms: int, context_dim: int, nu: float = 0.5,
                 lam: float = 1.0, seed: Optional[int] = None):
        self.arms = [_LinearArm(context_dim, lam)
                     for _ in range(num_arms)]
        self.nu = nu
        self.rng = np.random.default_rng(seed)

    def select_arm(self, context: np.ndarray) -> int:
        scores = [arm.sample(context, self.rng, self.nu)
                  for arm in self.arms]
        return int(np.argmax(scores))

    def update(self, context: np.ndarray, arm: int,
               reward: float) -> None:
        self.arms[arm].update(context, reward)


class BanditEnv:
    """Linear contextual bandit environment for tests/benchmarks
    (reference: rllib/examples/env/bandit_envs_discrete.py)."""

    def __init__(self, num_arms: int = 4, context_dim: int = 8,
                 noise: float = 0.1, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.theta = self.rng.normal(size=(num_arms, context_dim))
        self.theta /= np.linalg.norm(self.theta, axis=1, keepdims=True)
        self.noise = noise
        self.context_dim = context_dim
        self.num_arms = num_arms

    def observe(self) -> np.ndarray:
        x = self.rng.normal(size=self.context_dim)
        return x / np.linalg.norm(x)

    def pull(self, context: np.ndarray, arm: int) -> Tuple[float, float]:
        """-> (reward, regret vs best arm)."""
        means = self.theta @ context
        r = float(means[arm] + self.rng.normal() * self.noise)
        return r, float(means.max() - means[arm])


def run_bandit(policy, env: BanditEnv, steps: int) -> Dict:
    """Online loop: observe -> select -> reward -> update; returns
    cumulative regret curve (the bandit figure of merit)."""
    regrets = np.zeros(steps)
    for t in range(steps):
        x = env.observe()
        arm = policy.select_arm(x)
        r, regret = env.pull(x, arm)
        policy.update(x, arm, r)
        regrets[t] = regret
    return {"cumulative_regret": float(regrets.sum()),
            "regret_curve": np.cumsum(regrets),
            "final_window_regret": float(regrets[-steps // 10:].mean())}
