"""On-device PPO: counterpart of the JAX package's ``rllib/ondevice.py``.

The env, the rollout, GAE and the SGD epochs all stay on the device; the
host reads only the metrics. The JAX package makes one iteration one
``jit`` program. Here, on the card, one iteration is one CUDA graph: the
first ``iterate`` runs eagerly (on a side stream, which also warms up the
libraries the graph needs) and then captures the same function; later
ones replay it. On the CPU the function runs eagerly.

Every tensor the graph reads or writes across iterations (parameters,
optimizer state, env state, observations, the PRNG key) is allocated
once and updated in place. Never rebind or reallocate them after the
first ``iterate`` (``.to()``, ``load_state_dict`` with new tensors): the
graph holds their addresses. ``snapshot``/``restore`` copy them.

Draws follow ``jax.random`` key for key (``ray_tpu_torch.random``), so
with the same parameters the port takes the JAX program's actions: the
Gumbel noise is XLA's bit for bit, so only logits that differ in their
last bits can split a near-tie. The
draws depend only on keys, so a rollout makes all of its noise and env
resets up front, in a few large draws instead of 128 small ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import random as trandom
from ..device import default_device
from ..models.convert import ppo_params_from_numpy
from ..train.optim import adam, chain, clip_by_global_norm
from .policy import make_network
from .ppo import ppo_loss
from .sample_batch import (ACTIONS, ADVANTAGES, DONES, LOGPS, OBS, REWARDS,
                           VALUE_TARGETS)

State = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class DeviceEnv:
    """A vectorized env as functions over a dict of device tensors (the
    JAX package's ``JaxEnv``).

    reset: key -> (state, obs [N, ...])
    draw:  key(s) -> the fresh draws one step may use, for each key (a
           batch of keys gives the draws of many steps at once)
    advance: (state, actions [N], draws) -> (state, obs, rewards [N],
           dones [N])
    ``step(state, actions, key)`` is ``advance`` on ``draw(key)``: the
    JAX env's step.
    """
    name: str
    num_envs: int
    obs_shape: Tuple[int, ...]
    num_actions: int
    device: torch.device
    reset: Callable
    draw: Callable
    advance: Callable

    def step(self, state: State, actions: torch.Tensor, key: trandom.Key):
        return self.advance(state, actions, self.draw(key))


def cartpole(num_envs: int, device=None) -> DeviceEnv:
    """CartPole-v1 dynamics (the JAX package's ``jax_cartpole``)."""
    dev = default_device(device)
    lim_theta = float(12 * 2 * np.pi / 360)
    max_steps = 500

    def draw(key):
        return {"s": trandom.uniform(key, (num_envs, 4), -0.05, 0.05)}

    def reset(key):
        s = draw(key)["s"]
        return {"s": s, "t": torch.zeros(num_envs, dtype=torch.int32,
                                         device=dev)}, s.clone()

    def advance(state, actions, draws):
        x, x_dot, th, th_dot = state["s"].unbind(1)
        force = torch.where(actions == 1, 10.0, -10.0)
        costh, sinth = torch.cos(th), torch.sin(th)
        temp = (force + 0.05 * th_dot ** 2 * sinth) / 1.1
        th_acc = (9.8 * sinth - costh * temp) / (
            0.5 * (4.0 / 3.0 - 0.1 * costh ** 2 / 1.1))
        x_acc = temp - 0.05 * th_acc * costh / 1.1
        x = x + 0.02 * x_dot
        x_dot = x_dot + 0.02 * x_acc
        th = th + 0.02 * th_dot
        th_dot = th_dot + 0.02 * th_acc
        t = state["t"] + 1
        done = ((x.abs() > 2.4) | (th.abs() > lim_theta) | (t >= max_steps))
        s = torch.stack([x, x_dot, th, th_dot], dim=1)
        s = torch.where(done[:, None], draws["s"], s)
        t = torch.where(done, 0, t)
        rewards = torch.ones(num_envs, device=dev)
        return {"s": s, "t": t}, s, rewards, done

    return DeviceEnv("JaxCartPole", num_envs, (4,), 2, dev, reset, draw,
                     advance)


def atari_sim(num_envs: int, device=None) -> DeviceEnv:
    """Atari-shaped env (the JAX package's ``jax_atari_sim``): 84x84x4
    uint8 frame stacks, 6 actions, pong-like ball and paddle dynamics
    rendered on the device. The game is synthetic; the observation's
    shape and dtype, and so the conv policy's work, are Atari's."""
    dev = default_device(device)
    H = W = 84
    max_steps = 1000
    velocities = torch.tensor([-2.0, -1.0, 1.0, 2.0], device=dev)
    rows = torch.arange(H, device=dev)[None, :, None]
    cols = torch.arange(W, device=dev)[None, None, :]

    def render(ball, paddle):
        """The newest frame: ball 3x3 at 255, paddle 9x1 at 200."""
        by = torch.clamp(ball[:, 0].to(torch.int32), 1, H - 2)
        bx = torch.clamp(ball[:, 1].to(torch.int32), 1, W - 2)
        py = torch.clamp(paddle.to(torch.int32), 4, H - 5)
        ball_px = (((rows - by[:, None, None]).abs() <= 1)
                   & ((cols - bx[:, None, None]).abs() <= 1))
        paddle_px = ((rows - py[:, None, None]).abs() <= 4) & (cols == W - 3)
        return torch.where(ball_px, 255, torch.where(paddle_px, 200, 0)
                           ).to(torch.uint8)

    def draw(key):
        keys = trandom.split(key)
        shape = (num_envs, 2)
        return {"ball": trandom.uniform(trandom.take(keys, 0), shape, 20.0,
                                        60.0),
                "vel": trandom.choice(trandom.take(keys, 1), velocities,
                                      shape)}

    def reset(key):
        fresh = draw(key)
        paddle = torch.full((num_envs,), H / 2, device=dev)
        frames = torch.zeros((num_envs, H, W, 4), dtype=torch.uint8,
                             device=dev)
        frames[..., -1] = render(fresh["ball"], paddle)
        state = {"ball": fresh["ball"], "vel": fresh["vel"],
                 "paddle": paddle,
                 "t": torch.zeros(num_envs, dtype=torch.int32, device=dev),
                 "frames": frames}
        return state, frames.clone()

    def advance(state, actions, draws):
        up = (actions == 2) | (actions == 4)
        down = (actions == 3) | (actions == 5)
        move = torch.where(up, -2.0, torch.where(down, 2.0, 0.0))
        paddle = torch.clamp(state["paddle"] + move, 4, H - 5)
        ball = state["ball"] + state["vel"]
        vel = state["vel"]
        axes = []
        for axis, lim in ((0, H - 2), (1, W - 2)):
            b, v = ball[:, axis], vel[:, axis]
            oob = (b < 1) | (b > lim)
            axes.append((torch.clamp(b, 1, lim), torch.where(oob, -v, v)))
        ball = torch.stack([a[0] for a in axes], dim=1)
        vel = torch.stack([a[1] for a in axes], dim=1)
        hit = (ball[:, 1] > W - 6) & ((ball[:, 0] - paddle).abs() < 5)
        rewards = hit.float()
        t = state["t"] + 1
        done = t >= max_steps
        ball = torch.where(done[:, None], draws["ball"], ball)
        vel = torch.where(done[:, None], draws["vel"], vel)
        paddle = torch.where(done, H / 2, paddle)
        t = torch.where(done, 0, t)
        # Shift the stack by one frame; a finished episode restarts from
        # blank frames (the JAX env renders onto zeros and selects).
        old = state["frames"][..., 1:]
        old = torch.where(done[:, None, None, None], 0, old)
        frames = torch.cat([old, render(ball, paddle)[..., None]], dim=-1)
        state = {"ball": ball, "vel": vel, "paddle": paddle, "t": t,
                 "frames": frames}
        return state, frames, rewards, done

    return DeviceEnv("JaxAtariSim", num_envs, (H, W, 4), 6, dev, reset,
                     draw, advance)


def gae(rewards, dones, values, last_values, gamma: float, lambda_: float):
    """Advantages and value targets over [T, N] rollouts, bootstrapped by
    ``last_values`` [N]: the reverse scan of the JAX package's ``gae``."""
    not_done = 1.0 - dones.float()
    next_values = torch.cat([values[1:], last_values[None]])
    delta = rewards + gamma * next_values * not_done - values
    adv = torch.zeros_like(last_values)
    advs = []
    for t in reversed(range(rewards.shape[0])):
        adv = delta[t] + gamma * lambda_ * not_done[t] * adv
        advs.append(adv)
    advs = torch.stack(advs[::-1])
    return advs, advs + values


# The registry keys are the JAX package's, which users know.
ENVS = {"JaxCartPole": cartpole, "JaxAtariSim": atari_sim}


class OnDevicePPO:
    """PPO whose whole iteration stays on the device (one CUDA graph on
    the card): rollout T steps, GAE over the trajectory, then epochs x
    minibatches of ``ppo_loss`` with clip + Adam. The math and the key
    splits are the JAX ``OnDevicePPO``'s.

    ``params`` is a JAX policy tree (numpy leaves) to start from, bridged
    by ``models/convert.py``; without it the network is initialised from
    ``torch.Generator`` seed ``seed``. The env must live on ``device``.
    """

    def __init__(self, env: DeviceEnv, rollout_length: int = 128,
                 num_sgd_iter: int = 4, minibatches: int = 8,
                 lr: float = 3e-4, gamma: float = 0.99,
                 lambda_: float = 0.95, clip_param: float = 0.2,
                 vf_loss_coeff: float = 0.5, entropy_coeff: float = 0.01,
                 grad_clip: float = 0.5, network: str = "auto",
                 seed: int = 0, params=None, device=None):
        dev = default_device(device)
        if env.device != dev:
            raise ValueError(f"env {env.name} is on {env.device}, the "
                             f"learner on {dev}")
        self.env = env
        self.device = dev
        self.rollout_length = rollout_length
        self.num_sgd_iter = num_sgd_iter
        self.minibatches = minibatches
        self.gamma, self.lambda_ = gamma, lambda_
        self.clip_param = clip_param
        self.vf_loss_coeff, self.entropy_coeff = vf_loss_coeff, entropy_coeff
        self.net = make_network(env.obs_shape, env.num_actions, network)
        if params is None:
            params = self.net.init(torch.Generator().manual_seed(seed))
        else:
            params = ppo_params_from_numpy(params)
        self.params = {k: v.to(dev, torch.float32).requires_grad_()
                       for k, v in params.items()}
        self.optimizer = chain(clip_by_global_norm(grad_clip), adam(lr))
        self.opt_state = self.optimizer.init(
            [p.detach() for p in self.params.values()])
        keys = trandom.split(trandom.prng_key(seed + 1, dev))
        self._rng = tuple(w.clone() for w in trandom.take(keys, 1))
        self.env_state, self._obs = env.reset(trandom.take(keys, 0))
        self._graph = None
        self._graph_out = None
        # The last iteration's trajectory ([T, N, ...] tensors; static
        # buffers under the graph).
        self.trajectory: Dict[str, torch.Tensor] = {}

    # -- the iteration --------------------------------------------------------

    def _rollout(self, key):
        """T env steps under the current policy; updates the env state and
        observations in place. Returns the trajectory and the values of
        the last observations."""
        env, T = self.env, self.rollout_length
        apply = self.net.apply
        step_keys = trandom.split(trandom.split(key, T))  # [T, 2]
        noise = trandom.gumbel(trandom.take(step_keys, 0),
                               (env.num_envs, env.num_actions))
        draws = env.draw(trandom.take(step_keys, 1))
        obs = self._obs
        traj = {OBS: torch.empty((T,) + tuple(obs.shape), dtype=obs.dtype,
                                 device=obs.device)}
        cols: Dict[str, List[torch.Tensor]] = {
            k: [] for k in (ACTIONS, LOGPS, "values", REWARDS, DONES)}
        state = self.env_state
        for t in range(T):
            logits, values = apply(self.params, obs)
            # jax.random.categorical(k_act, logits), its noise drawn above
            actions = torch.argmax(noise[t] + logits, dim=-1)
            logp = torch.log_softmax(logits, dim=-1).gather(
                -1, actions[:, None])[:, 0]
            traj[OBS][t].copy_(obs)
            state, obs, rewards, dones = env.advance(
                state, actions, {k: v[t] for k, v in draws.items()})
            for k, v in ((ACTIONS, actions), (LOGPS, logp),
                         ("values", values), (REWARDS, rewards),
                         (DONES, dones)):
                cols[k].append(v)
        _, last_values = apply(self.params, obs)
        for k, v in state.items():
            self.env_state[k].copy_(v)
        self._obs.copy_(obs)
        traj.update({k: torch.stack(v) for k, v in cols.items()})
        return traj, last_values

    def _sgd_step(self, batch):
        """One minibatch: loss, gradients, clip + Adam, parameters updated
        in place."""
        params = list(self.params.values())
        with torch.enable_grad():
            loss, aux = ppo_loss(self.params, batch, self.clip_param, 10.0,
                                 self.vf_loss_coeff, self.entropy_coeff,
                                 self.net.apply)
            grads = torch.autograd.grad(loss, params)
        updates, self.opt_state = self.optimizer.update(
            list(grads), self.opt_state, [p.detach() for p in params])
        for p, u in zip(params, updates):
            p.add_(u)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def _update(self, flat, key):
        """Epochs x minibatches over a fresh permutation each epoch
        (``jax.random.permutation`` of the epoch's key); the last
        minibatch's loss and aux."""
        total = self.rollout_length * self.env.num_envs
        mb = total // self.minibatches
        perms = trandom.permutation(trandom.split(key, self.num_sgd_iter),
                                    total)
        for e in range(self.num_sgd_iter):
            for m in range(self.minibatches):
                idx = perms[e, m * mb:(m + 1) * mb]
                loss, aux = self._sgd_step(
                    {k: v[idx] for k, v in flat.items()})
        return loss, aux

    @torch.no_grad()
    def _iteration(self) -> Tuple[State, State]:
        """One sample-and-learn cycle, the JAX ``train_iteration`` and its
        ``iterate``: every tensor state updated in place. Returns the
        metrics as device scalars, and the trajectory."""
        T, N = self.rollout_length, self.env.num_envs
        keys = trandom.split(self._rng)
        for w, new in zip(self._rng, trandom.take(keys, 0)):
            w.copy_(new)
        keys = trandom.split(trandom.take(keys, 1))
        traj, last_values = self._rollout(trandom.take(keys, 0))
        advs, targets = gae(traj[REWARDS], traj[DONES], traj["values"],
                            last_values, self.gamma, self.lambda_)
        flatten = lambda a: a.reshape((T * N,) + a.shape[2:])
        flat = {OBS: flatten(traj[OBS]), ACTIONS: flatten(traj[ACTIONS]),
                LOGPS: flatten(traj[LOGPS]), ADVANTAGES: flatten(advs),
                VALUE_TARGETS: flatten(targets)}
        loss, aux = self._update(flat, trandom.take(keys, 1))
        dones_per_env = traj[DONES].sum(0).float().mean()
        metrics = {"total_loss": loss,
                   "mean_reward": traj[REWARDS].mean(),
                   # episode terminations per env this rollout; the
                   # episode-length estimate divides T by it (clamped:
                   # 0 dones means episodes outlast the rollout).
                   "dones_per_env": dones_per_env,
                   "mean_episode_len": T / torch.clamp_min(dones_per_env,
                                                           1.0)}
        metrics.update(aux)
        return metrics, traj

    # -- driving it -----------------------------------------------------------

    def iterate(self, graph: Optional[bool] = None
                ) -> Dict[str, torch.Tensor]:
        """One iteration; metrics as device scalars (no host sync). On the
        card it replays the iteration's CUDA graph (``graph=False`` runs it
        eagerly); the first call runs eagerly on a side stream and then
        captures the graph."""
        if not (self.device.type == "cuda" if graph is None else graph):
            metrics, self.trajectory = self._iteration()
            return metrics
        if self.device.type != "cuda":
            raise ValueError("CUDA graphs need the learner on a CUDA device")
        if self._graph is not None:
            self._graph.replay()
            metrics, self.trajectory = self._graph_out
            return metrics
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            metrics, self.trajectory = self._iteration()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._iteration()
        self._graph, self._graph_out = graph, out
        return metrics

    def train_iteration(self) -> Dict[str, float]:
        """One fused sample+learn cycle; returns host metrics."""
        out = {k: float(v) for k, v in self.iterate().items()}
        out["timesteps_this_iter"] = self.rollout_length * self.env.num_envs
        return out

    # -- state ----------------------------------------------------------------

    def _state_tensors(self) -> List[torch.Tensor]:
        """Every tensor an iteration reads and updates in place."""
        adam_state = self.opt_state[1][0]  # chain(clip, chain(adam, lr))
        return ([p.detach() for p in self.params.values()]
                + [adam_state["count"]] + adam_state["mu"] + adam_state["nu"]
                + list(self.env_state.values()) + [self._obs]
                + list(self._rng))

    def snapshot(self) -> List[torch.Tensor]:
        """Copies of the learner's whole state (parameters, optimizer,
        env, observations, key)."""
        return [t.clone() for t in self._state_tensors()]

    def restore(self, snapshot: List[torch.Tensor]) -> None:
        """Copies ``snapshot`` back in place (the graph's addresses
        stay)."""
        with torch.no_grad():
            for t, s in zip(self._state_tensors(), snapshot):
                t.copy_(s)
