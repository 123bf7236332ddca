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

``JaxPolicy`` (the host rollout-worker policy) and the catalog's LSTM
networks are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import random as trandom
from ..models.common import truncated_normal

Params = Dict[str, torch.Tensor]


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
    params["pi_w"] = truncated_normal((sizes[-1], num_actions), generator,
                                      stddev=0.01)
    params["pi_b"] = torch.zeros(num_actions)
    params["vf_w"] = truncated_normal((sizes[-1], 1), generator, stddev=1.0)
    params["vf_b"] = torch.zeros(1)
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


def init_conv_policy(generator: Optional[torch.Generator],
                     obs_shape: Tuple[int, ...], num_actions: int,
                     dense: int = 512) -> Params:
    """Nature-CNN actor-critic for [H, W, C] frames: filters 32x8x8/4,
    64x4x4/2, 64x3x3/1, dense 512, policy and value heads off the shared
    trunk. Conv weights OIHW."""
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
    params["pi_w"] = truncated_normal((dense, num_actions), generator,
                                      stddev=0.01)
    params["pi_b"] = torch.zeros(num_actions)
    params["vf_w"] = truncated_normal((dense, 1), generator, stddev=1.0)
    params["vf_b"] = torch.zeros(1)
    return params


def forward_conv(params: Params, obs: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W, C] (uint8 or float) -> (logits [B, A], values [B]).

    As the JAX package: uint8 frames become fp32 / 255, the conv and dense
    trunk runs in bf16 (each bias added after its product, in bf16), the
    policy and value heads in fp32."""
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
    x = x.float()
    logits = x @ params["pi_w"] + params["pi_b"]
    values = (x @ params["vf_w"] + params["vf_b"])[..., 0]
    return logits, values


@dataclass(frozen=True)
class Network:
    """A policy network: ``init(generator) -> params`` (fp32, on the CPU)
    and ``apply(params, obs) -> (logits, values)``."""
    kind: str
    init: Callable[[Optional[torch.Generator]], Params]
    apply: Callable[[Params, torch.Tensor],
                    Tuple[torch.Tensor, torch.Tensor]]


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


def sample_actions(apply_fn, params: Params, obs: torch.Tensor,
                   key: trandom.Key, deterministic: bool):
    """The sampling head of host policies and the on-device rollout:
    (actions, their log-probabilities, values)."""
    logits, values = apply_fn(params, obs)
    if deterministic:
        actions = torch.argmax(logits, dim=-1)
    else:
        actions = trandom.categorical(key, logits)
    logp = torch.log_softmax(logits, dim=-1).gather(
        -1, actions[:, None])[:, 0]
    return actions, logp, values
