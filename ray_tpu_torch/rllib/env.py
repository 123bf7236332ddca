"""A copy of the JAX package's ``rllib/env.py`` (numpy only),
kept here because the port imports nothing of that package. Its
docstring:

Environment abstractions: vectorized env over gymnasium + native envs.

Reference analog: ``rllib/env/`` (BaseEnv/VectorEnv wrapping gym). A
``VectorEnv`` steps N env copies with batched numpy IO — the rollout hot
loop's interface. ``FastCartPole`` is a pure-numpy vectorized CartPole used
for throughput benchmarking without per-env python loops (the env analog of
the reference's Atari throughput configs).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np


class VectorEnv:
    """N synchronized env copies; batched reset/step."""

    num_envs: int
    observation_space_shape: Tuple[int, ...]
    num_actions: int

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def vector_step(self, actions: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
        """-> (obs [N, ...], rewards [N], dones [N], info). Auto-resets
        done sub-envs (returned obs is the fresh reset obs)."""
        raise NotImplementedError


class GymVectorEnv(VectorEnv):
    """Wraps ``gymnasium.make_vec``-style env batches."""

    def __init__(self, env_id: str, num_envs: int = 1, **kwargs):
        import gymnasium as gym

        self._envs = [gym.make(env_id, **kwargs) for _ in range(num_envs)]
        self.num_envs = num_envs
        space = self._envs[0].observation_space
        self.observation_space_shape = tuple(space.shape)
        self.num_actions = int(self._envs[0].action_space.n)

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        obs = []
        for i, e in enumerate(self._envs):
            o, _ = e.reset(seed=None if seed is None else seed + i)
            obs.append(o)
        return np.stack(obs)

    def vector_step(self, actions):
        obs, rewards, dones = [], [], []
        for e, a in zip(self._envs, actions):
            o, r, term, trunc, _ = e.step(int(a))
            done = bool(term or trunc)
            if done:
                o, _ = e.reset()
            obs.append(o)
            rewards.append(r)
            dones.append(done)
        return (np.stack(obs), np.asarray(rewards, np.float32),
                np.asarray(dones), {})


class FastCartPole(VectorEnv):
    """Vectorized numpy CartPole-v1 (identical dynamics/termination).

    One batched numpy update per step for all N envs — the high-throughput
    path for the env-steps/sec benchmark.
    """

    GRAVITY = 9.8
    MASS_CART = 1.0
    MASS_POLE = 0.1
    LENGTH = 0.5
    FORCE = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * np.pi / 360
    X_LIMIT = 2.4
    MAX_STEPS = 500

    def __init__(self, num_envs: int = 1, seed: int = 0):
        self.num_envs = num_envs
        self.observation_space_shape = (4,)
        self.num_actions = 2
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros((num_envs, 4), np.float32)
        self._steps = np.zeros(num_envs, np.int32)

    def _reset_some(self, mask: np.ndarray) -> None:
        n = int(mask.sum())
        if n:
            self._state[mask] = self._rng.uniform(
                -0.05, 0.05, (n, 4)
            ).astype(np.float32)
            self._steps[mask] = 0

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._reset_some(np.ones(self.num_envs, bool))
        return self._state.copy()

    def vector_step(self, actions):
        x, x_dot, theta, theta_dot = self._state.T
        force = np.where(actions == 1, self.FORCE, -self.FORCE)
        costh, sinth = np.cos(theta), np.sin(theta)
        total_mass = self.MASS_CART + self.MASS_POLE
        polemass_length = self.MASS_POLE * self.LENGTH
        temp = (force + polemass_length * theta_dot**2 * sinth) / total_mass
        theta_acc = (self.GRAVITY * sinth - costh * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASS_POLE * costh**2 / total_mass)
        )
        x_acc = temp - polemass_length * theta_acc * costh / total_mass
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * x_acc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * theta_acc
        self._state = np.stack([x, x_dot, theta, theta_dot], axis=1).astype(
            np.float32
        )
        self._steps += 1
        done = (
            (np.abs(x) > self.X_LIMIT)
            | (np.abs(theta) > self.THETA_LIMIT)
            | (self._steps >= self.MAX_STEPS)
        )
        rewards = np.ones(self.num_envs, np.float32)
        self._reset_some(done)
        return self._state.copy(), rewards, done, {}


class FastPendulum(VectorEnv):
    """Vectorized numpy Pendulum-v1 (identical dynamics/reward) — the
    continuous-action counterpart of FastCartPole; one batched numpy
    update per step for all N envs. Continuous envs expose
    ``action_dim`` + ``action_low/high`` instead of ``num_actions``."""

    G = 10.0
    M = 1.0
    L = 1.0
    DT = 0.05
    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    MAX_STEPS = 200

    num_actions = 0  # continuous
    action_dim = 1
    action_low = -2.0
    action_high = 2.0

    def __init__(self, num_envs: int = 1, seed: int = 0):
        self.num_envs = num_envs
        self.observation_space_shape = (3,)
        self._rng = np.random.default_rng(seed)
        self._theta = np.zeros(num_envs, np.float32)
        self._thetadot = np.zeros(num_envs, np.float32)
        self._steps = np.zeros(num_envs, np.int32)

    def _obs(self) -> np.ndarray:
        return np.stack([np.cos(self._theta), np.sin(self._theta),
                         self._thetadot], axis=1).astype(np.float32)

    def _reset_some(self, mask: np.ndarray) -> None:
        n = int(mask.sum())
        if n:
            self._theta[mask] = self._rng.uniform(-np.pi, np.pi, n)
            self._thetadot[mask] = self._rng.uniform(-1.0, 1.0, n)
            self._steps[mask] = 0

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._reset_some(np.ones(self.num_envs, bool))
        return self._obs()

    def vector_step(self, actions):
        u = np.clip(np.asarray(actions, np.float32).reshape(self.num_envs),
                    -self.MAX_TORQUE, self.MAX_TORQUE)
        th, thdot = self._theta, self._thetadot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        costs = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        newthdot = thdot + (
            3.0 * self.G / (2.0 * self.L) * np.sin(th)
            + 3.0 / (self.M * self.L ** 2) * u) * self.DT
        newthdot = np.clip(newthdot, -self.MAX_SPEED, self.MAX_SPEED)
        self._theta = (th + newthdot * self.DT).astype(np.float32)
        self._thetadot = newthdot.astype(np.float32)
        self._steps += 1
        done = self._steps >= self.MAX_STEPS
        self._reset_some(done)
        return (self._obs(), (-costs).astype(np.float32), done, {})


class RepeatPrevObs(VectorEnv):
    """Memory probe env: the reward at step t is 1 iff the action
    equals the SIGNAL SHOWN AT t-1. A feedforward policy sees only the
    current signal — independent of the correct answer — so its best
    possible mean reward is chance (1/num_signals); any policy with one
    step of memory can score ~1 per step. Used to prove recurrent
    V-trace actually trains the recurrent pathway."""

    NUM_SIGNALS = 3
    MAX_STEPS = 32

    def __init__(self, num_envs: int = 1, seed: int = 0):
        self.num_envs = num_envs
        self.observation_space_shape = (self.NUM_SIGNALS,)
        self.num_actions = self.NUM_SIGNALS
        self._rng = np.random.default_rng(seed)
        self._signal = np.zeros(num_envs, np.int64)
        self._prev = np.zeros(num_envs, np.int64)
        self._steps = np.zeros(num_envs, np.int32)

    def _obs(self) -> np.ndarray:
        out = np.zeros((self.num_envs, self.NUM_SIGNALS), np.float32)
        out[np.arange(self.num_envs), self._signal] = 1.0
        return out

    def _reset_some(self, mask) -> None:
        n = int(np.sum(mask))
        if not n:
            return
        self._signal[mask] = self._rng.integers(0, self.NUM_SIGNALS, n)
        self._prev[mask] = 0  # the known start token
        self._steps[mask] = 0

    def vector_reset(self, seed=None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._reset_some(np.ones(self.num_envs, bool))
        return self._obs()

    def vector_step(self, actions):
        actions = np.asarray(actions).reshape(self.num_envs)
        rewards = (actions == self._prev).astype(np.float32)
        self._prev = self._signal.copy()
        self._signal = self._rng.integers(0, self.NUM_SIGNALS,
                                          self.num_envs)
        self._steps += 1
        done = self._steps >= self.MAX_STEPS
        self._reset_some(done)
        return self._obs(), rewards, done, {}


class AtariSim(VectorEnv):
    """Synthetic Atari-SHAPED env: 84x84x4 uint8 frame-stack observations,
    6 actions, pong-like ball/paddle dynamics rendered with vectorized
    numpy — the workload shape of the reference's Atari throughput configs
    (frame tensors, conv policy) without ALE ROMs, which this image lacks.
    Rewards: +1 when the paddle tracks the ball row at frame events.
    """

    H = W = 84
    STACK = 4
    MAX_STEPS = 1000

    def __init__(self, num_envs: int = 1, seed: int = 0):
        self.num_envs = num_envs
        self.observation_space_shape = (self.H, self.W, self.STACK)
        self.num_actions = 6
        self._rng = np.random.default_rng(seed)
        n = num_envs
        self._ball = np.zeros((n, 2), np.float32)    # (y, x)
        self._vel = np.zeros((n, 2), np.float32)
        self._paddle = np.zeros(n, np.float32)       # y position
        self._steps = np.zeros(n, np.int32)
        self._frames = np.zeros((n, self.H, self.W, self.STACK), np.uint8)

    def _reset_some(self, mask: np.ndarray) -> None:
        n = int(mask.sum())
        if not n:
            return
        self._ball[mask] = self._rng.uniform(20, 60, (n, 2))
        self._vel[mask] = self._rng.choice([-2.0, -1.0, 1.0, 2.0], (n, 2))
        self._paddle[mask] = self.H / 2
        self._steps[mask] = 0
        self._frames[mask] = 0

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._reset_some(np.ones(self.num_envs, bool))
        self._render()
        return self._frames.copy()

    def _render(self) -> None:
        # Shift the stack and draw ball + paddle into the newest frame.
        self._frames[..., :-1] = self._frames[..., 1:]
        new = np.zeros((self.num_envs, self.H, self.W), np.uint8)
        idx = np.arange(self.num_envs)
        by = np.clip(self._ball[:, 0].astype(int), 1, self.H - 2)
        bx = np.clip(self._ball[:, 1].astype(int), 1, self.W - 2)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                new[idx, by + dy, bx + dx] = 255
        py = np.clip(self._paddle.astype(int), 4, self.H - 5)
        for dy in range(-4, 5):
            new[idx, py + dy, self.W - 3] = 200
        self._frames[..., -1] = new

    def vector_step(self, actions):
        # 0/1: stay, 2/4: up, 3/5: down (Atari Pong action semantics-ish)
        move = np.where(np.isin(actions, (2, 4)), -2.0,
                        np.where(np.isin(actions, (3, 5)), 2.0, 0.0))
        self._paddle = np.clip(self._paddle + move, 4, self.H - 5)
        self._ball += self._vel
        for axis, lim in ((0, self.H - 2), (1, self.W - 2)):
            low = self._ball[:, axis] < 1
            high = self._ball[:, axis] > lim
            self._vel[low | high, axis] *= -1
            self._ball[:, axis] = np.clip(self._ball[:, axis], 1, lim)
        hit = (self._ball[:, 1] > self.W - 6) & (
            np.abs(self._ball[:, 0] - self._paddle) < 5)
        rewards = hit.astype(np.float32)
        self._steps += 1
        done = self._steps >= self.MAX_STEPS
        self._reset_some(done)
        self._render()
        return self._frames.copy(), rewards, done, {}


def make_env(env: Any, num_envs: int, seed: int = 0) -> VectorEnv:
    """Resolve an env spec: VectorEnv instance, factory, or gym id."""
    if isinstance(env, VectorEnv):
        return env
    if callable(env):
        made = env(num_envs)
        if isinstance(made, VectorEnv):
            return made
        raise TypeError("env factory must return a VectorEnv")
    if env == "FastCartPole":
        return FastCartPole(num_envs, seed)
    if env == "FastPendulum":
        return FastPendulum(num_envs, seed)
    if env == "AtariSim":
        return AtariSim(num_envs, seed)
    if env == "RepeatPrevObs":
        return RepeatPrevObs(num_envs, seed)
    return GymVectorEnv(env, num_envs)
