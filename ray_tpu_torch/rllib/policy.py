"""Actor-critic networks: counterpart of the network half of the JAX
package's ``rllib/policy.py``.

A network is a dict of parameter tensors under the JAX package's names
plus pure functions over it, as there: ``init`` from a
``torch.Generator`` (the same truncated-normal stddevs; other numbers, the
generators differ) and ``apply(params, obs) -> (logits [B, A], values
[B])``. ``models/convert.py`` carries a JAX tree across.

The conv network keeps the JAX package's observation layout, [B, H, W, C]
frames, and its dense rows in (h, w, c) order. Its conv weights are
PyTorch's OIHW (JAX: HWIO); the frames enter the convs as a permuted view,
which is PyTorch's channels-last layout, so the trunk runs channels-last
and its output flattens in (h, w, c) order without a copy. The frames'
channels are padded with zeros to a multiple of 8, and the first conv's
weights with zero input channels: cuDNN's bf16 channels-last kernels take
channels in multiples of 8, and with Atari's 4 it converts to fp32 NCHW
and back around every call of the first conv.

``TorchPolicy`` is the counterpart of ``JaxPolicy``: a network's
parameters on one device (the CPU on rollout workers, where the caller
asks for it), actions drawn with ``ray_tpu_torch.random`` from a key split
once a call as there, so that for the same parameters, key and
observations its actions are the JAX policy's. Recurrent networks (the
catalog's LSTMs) keep their state per batch size.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import random as trandom
from ..device import default_device
from ..models.common import truncated_normal
from ..models.convert import ppo_params_from_numpy, ppo_tree_to_numpy

Params = Dict[str, torch.Tensor]
State = Tuple[torch.Tensor, ...]


def init_mlp_policy(generator: Optional[torch.Generator], obs_dim: int,
                    num_actions: int,
                    hidden: Sequence[int] = (64, 64)) -> Params:
    """Separate actor and critic MLPs (shared trunks let large value
    targets swamp policy gradients)."""
    params: Params = {}
    sizes = [obs_dim] + list(hidden)
    for i in range(len(sizes) - 1):
        std = float(np.sqrt(2.0 / sizes[i]))
        for head in ("pi", "vf"):
            params[f"{head}_t{i}_w"] = truncated_normal(
                (sizes[i], sizes[i + 1]), generator, stddev=std)
            params[f"{head}_t{i}_b"] = torch.zeros(sizes[i + 1])
    params.update(init_heads(generator, sizes[-1], num_actions))
    return params


def forward_mlp(params: Params, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits [B, A], values [B]), in fp32."""
    pi = vf = obs.float()
    i = 0
    while f"pi_t{i}_w" in params:
        pi = torch.tanh(pi @ params[f"pi_t{i}_w"] + params[f"pi_t{i}_b"])
        vf = torch.tanh(vf @ params[f"vf_t{i}_w"] + params[f"vf_t{i}_b"])
        i += 1
    logits = pi @ params["pi_w"] + params["pi_b"]
    values = (vf @ params["vf_w"] + params["vf_b"])[..., 0]
    return logits, values


# Nature-DQN conv trunk as (out_channels, kernel, stride): one source for
# init (shape math) and apply (strides).
_CONV_SPEC = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


def init_conv_trunk(generator: Optional[torch.Generator],
                    obs_shape: Tuple[int, ...], dense: int) -> Params:
    """The Nature-CNN trunk's parameters for [H, W, C] frames: filters
    32x8x8/4, 64x4x4/2, 64x3x3/1, then a dense layer of ``dense``. Conv
    weights OIHW."""
    h, w, cin = obs_shape
    params: Params = {}
    for i, (cout, k, stride) in enumerate(_CONV_SPEC):
        std = float(np.sqrt(2.0 / (k * k * cin)))
        params[f"conv{i}_w"] = truncated_normal((cout, cin, k, k), generator,
                                                stddev=std)
        params[f"conv{i}_b"] = torch.zeros(cout)
        h = (h - k) // stride + 1
        w = (w - k) // stride + 1
        cin = cout
    flat = h * w * cin
    params["dense_w"] = truncated_normal(
        (flat, dense), generator, stddev=float(np.sqrt(2.0 / flat)))
    params["dense_b"] = torch.zeros(dense)
    return params


def init_heads(generator: Optional[torch.Generator], width: int,
               num_actions: int) -> Params:
    """Policy and value heads off a ``width``-wide feature."""
    return {"pi_w": truncated_normal((width, num_actions), generator,
                                     stddev=0.01),
            "pi_b": torch.zeros(num_actions),
            "vf_w": truncated_normal((width, 1), generator, stddev=1.0),
            "vf_b": torch.zeros(1)}


def init_conv_policy(generator: Optional[torch.Generator],
                     obs_shape: Tuple[int, ...], num_actions: int,
                     dense: int = 512) -> Params:
    """Nature-CNN actor-critic for [H, W, C] frames: the trunk with dense
    512, policy and value heads off it."""
    params = init_conv_trunk(generator, obs_shape, dense)
    params.update(init_heads(generator, dense, num_actions))
    return params


def conv_trunk(params: Params, obs: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] (uint8 or float) -> the dense layer's fp32 features.

    As the JAX package: uint8 frames become fp32 / 255, the conv and dense
    trunk runs in bf16 (each bias added after its product, in bf16)."""
    x = obs.float()
    if obs.dtype == torch.uint8:
        x = x / 255.0
    pad = -x.shape[-1] % 8
    x = F.pad(x.to(torch.bfloat16), (0, pad))
    x = x.permute(0, 3, 1, 2)  # channels-last NCHW view
    for i, (_cout, _k, stride) in enumerate(_CONV_SPEC):
        w = params[f"conv{i}_w"].to(x.dtype)
        if i == 0 and pad:
            w = F.pad(w, (0, 0, 0, 0, 0, pad))
        x = F.conv2d(x, w, stride=stride)
        x = torch.relu(x + params[f"conv{i}_b"].to(x.dtype)[:, None, None])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c) order
    x = torch.relu(x @ params["dense_w"].to(x.dtype)
                   + params["dense_b"].to(x.dtype))
    return x.float()


def heads(params: Params, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 policy and value heads: (logits [B, A], values [B])."""
    logits = x @ params["pi_w"] + params["pi_b"]
    values = (x @ params["vf_w"] + params["vf_b"])[..., 0]
    return logits, values


def forward_conv(params: Params, obs: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W, C] (uint8 or float) -> (logits [B, A], values [B]): the
    bf16 trunk, then the fp32 heads."""
    return heads(params, conv_trunk(params, obs))


@dataclass(frozen=True)
class Network:
    """A policy network: ``init(generator) -> params`` (fp32, on the CPU)
    and ``apply(params, obs) -> (logits, values)``. Recurrent networks
    leave ``apply`` None and give ``initial_state(batch, device)`` and
    ``apply_state(params, obs, state) -> (logits, values, new_state)``
    instead (the catalog's LSTMs)."""
    kind: str
    init: Callable[[Optional[torch.Generator]], Params]
    apply: Optional[Callable[[Params, torch.Tensor],
                             Tuple[torch.Tensor, torch.Tensor]]] = None
    initial_state: Optional[Callable[..., State]] = None
    apply_state: Optional[Callable] = None

    @property
    def is_recurrent(self) -> bool:
        return self.apply_state is not None


def make_network(obs_shape: Tuple[int, ...], num_actions: int,
                 kind: str = "auto",
                 hidden: Sequence[int] = (64, 64)) -> Network:
    """'mlp' for vector observations, 'conv' (Nature CNN) for [H, W, C]
    frames; 'auto' picks by the observation's rank."""
    if kind == "auto":
        kind = "conv" if len(obs_shape) == 3 else "mlp"
    if kind == "conv":
        return Network("conv", lambda g: init_conv_policy(
            g, obs_shape, num_actions), forward_conv)
    if kind != "mlp":
        raise ValueError(f"unknown network kind {kind!r}")
    obs_dim = int(np.prod(obs_shape))

    def apply_flat(params, obs):
        return forward_mlp(params, obs.reshape(obs.shape[0], -1))

    return Network("mlp", lambda g: init_mlp_policy(
        g, obs_dim, num_actions, hidden), apply_flat)


def choose(logits: torch.Tensor, key: trandom.Key, deterministic: bool
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sampling head: the argmax or ``jax.random.categorical``'s draw,
    and its log-probability."""
    if deterministic:
        actions = torch.argmax(logits, dim=-1)
    else:
        actions = trandom.categorical(key, logits)
    logp = torch.log_softmax(logits, dim=-1).gather(
        -1, actions[:, None])[:, 0]
    return actions, logp


def sample_actions(apply_fn, params: Params, obs: torch.Tensor,
                   key: trandom.Key, deterministic: bool):
    """The sampling head of host policies and the on-device rollout:
    (actions, their log-probabilities, values)."""
    logits, values = apply_fn(params, obs)
    actions, logp = choose(logits, key, deterministic)
    return actions, logp, values


class TorchPolicy:
    """Discrete-action actor-critic policy: counterpart of the JAX
    package's ``JaxPolicy``.

    ``model_config`` goes through the catalog (conv, mlp, lstm, custom);
    ``network``/``hidden`` are the shorthand without it. The parameters
    live on ``device`` (``default_device``: the card unless the caller
    asks for the CPU, as rollout workers do), initialised from
    ``torch.Generator`` seed ``seed``; the action key is
    ``PRNGKey(seed + 1)``, split once a ``compute_actions`` call as the JAX
    policy splits its own. Recurrent networks keep their state per batch
    size, so that an evaluation call of batch 1 leaves the rollout's state
    of batch N alone; rollout workers call ``observe_dones`` so that
    finished sub-envs start again from zeros."""

    def __init__(self, obs_shape: Tuple[int, ...], num_actions: int,
                 hidden: Sequence[int] = (64, 64), seed: int = 0,
                 network: str = "auto",
                 model_config: Optional[Dict] = None, device=None):
        self.device = default_device(device)
        self.obs_dim = int(np.prod(obs_shape))
        self.num_actions = num_actions
        if model_config is not None:
            from .catalog import get_network

            self.net = get_network(obs_shape, num_actions, model_config)
        else:
            self.net = make_network(obs_shape, num_actions, network, hidden)
        params = self.net.init(torch.Generator().manual_seed(seed))
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self._key = trandom.prng_key(seed + 1, self.device)
        self._states: Dict[int, State] = {}

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray, deterministic: bool = False):
        """(actions int32, log-probabilities, values) as numpy."""
        obs = torch.as_tensor(np.asarray(obs), device=self.device)
        keys = trandom.split(self._key)
        self._key, sub = trandom.take(keys, 0), trandom.take(keys, 1)
        if self.net.is_recurrent:
            b = len(obs)
            logits, values, self._states[b] = self.net.apply_state(
                self.params, obs, self.recurrent_state(b))
            actions, logp = choose(logits, sub, deterministic)
        else:
            actions, logp, values = sample_actions(
                self.net.apply, self.params, obs, sub, deterministic)
        return (actions.to(torch.int32).cpu().numpy(), logp.cpu().numpy(),
                values.cpu().numpy())

    def recurrent_state(self, batch: int) -> Optional[State]:
        """The carried state for this batch size (zeros if fresh); None
        for feedforward networks."""
        if not self.net.is_recurrent:
            return None
        state = self._states.get(batch)
        return state if state is not None \
            else self.net.initial_state(batch, self.device)

    def set_recurrent_state(self, batch: int, state: State) -> None:
        if self.net.is_recurrent:
            self._states[batch] = state

    def observe_dones(self, dones: np.ndarray) -> None:
        """Zero the recurrent state of finished sub-envs (nothing for
        feedforward networks)."""
        state = self._states.get(len(dones))
        if state is None or not np.any(dones):
            return
        mask = torch.as_tensor(~np.asarray(dones, bool), dtype=torch.float32,
                               device=self.device)[:, None]
        self._states[len(dones)] = tuple(s * mask for s in state)

    def get_weights(self) -> Dict[str, np.ndarray]:
        """The parameters as numpy in the JAX package's layout (conv
        weights HWIO), which checkpoints and the object plane carry."""
        return ppo_tree_to_numpy(self.params)

    def set_weights(self, weights: Dict[str, np.ndarray]) -> None:
        self.params = {k: v.to(self.device) for k, v in
                       ppo_params_from_numpy(weights).items()}
