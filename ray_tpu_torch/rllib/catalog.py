"""Model catalog: counterpart of the JAX package's ``rllib/catalog.py``.

Turns (observation shape, number of actions, model config) into a
``policy.Network``: a custom model from the registry, an LSTM wrapper when
``use_lstm`` is set (a Nature-CNN trunk under it for [H, W, C] frames, an
MLP trunk otherwise), else conv or MLP by the observation's rank.

The LSTM cell is plain tensor code with the JAX package's parameters and
their layout: one fused ``lstm_w`` of ``[feat + cell, 4 * cell]`` over
``[x, h]``, one bias ``lstm_b``, the gates split in the order i, f, g, o,
and 1.0 added to the forget gate before its sigmoid. (``torch.nn.LSTM``
orders its gates i, f, g, o too, but keeps two biases and adds no forget
bias, so its parameters are not these.) ``models/convert.py`` carries the
trees across as they are.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.common import truncated_normal
from .policy import (Network, Params, State, conv_trunk, heads,
                     init_conv_trunk, init_heads, make_network)

# The JAX package's MODEL_DEFAULTS (the subset of upstream RLlib's that
# applies here).
MODEL_DEFAULTS: Dict = {
    "custom_model": None,
    "fcnet_hiddens": (64, 64),
    "use_lstm": False,
    "lstm_cell_size": 64,
    # "auto": Nature CNN for rank-3 observations; "mlp"/"conv" force one.
    "network": "auto",
}

_CUSTOM_MODELS: Dict[str, Callable] = {}


def register_custom_model(name: str, factory: Callable) -> None:
    """``factory(obs_shape, num_actions, model_config) -> Network``."""
    _CUSTOM_MODELS[name] = factory


def _init_lstm(generator: Optional[torch.Generator], feat: int, cell: int,
               num_actions: int) -> Params:
    std = float(np.sqrt(1.0 / (feat + cell)))
    params = {"lstm_w": truncated_normal((feat + cell, 4 * cell), generator,
                                         stddev=std),
              "lstm_b": torch.zeros(4 * cell)}
    params.update(init_heads(generator, cell, num_actions))
    return params


def init_lstm_policy(generator: Optional[torch.Generator], obs_dim: int,
                     num_actions: int, hidden: Sequence[int] = (64,),
                     cell: int = 64) -> Params:
    """tanh MLP trunk ``t<i>_w``/``t<i>_b``, the LSTM cell, then policy and
    value heads off its output."""
    params: Params = {}
    sizes = [obs_dim] + list(hidden)
    for i in range(len(sizes) - 1):
        std = float(np.sqrt(2.0 / sizes[i]))
        params[f"t{i}_w"] = truncated_normal((sizes[i], sizes[i + 1]),
                                             generator, stddev=std)
        params[f"t{i}_b"] = torch.zeros(sizes[i + 1])
    params.update(_init_lstm(generator, sizes[-1], cell, num_actions))
    return params


def lstm_initial_state(batch: int, cell: int, device=None) -> State:
    """(h, c), zeros of [batch, cell]."""
    return (torch.zeros((batch, cell), device=device),
            torch.zeros((batch, cell), device=device))


def lstm_step(params: Params, x: torch.Tensor, state: State
              ) -> Tuple[torch.Tensor, torch.Tensor, State]:
    """One step of the cell on fp32 features ``x`` [B, feat], then the
    heads: (logits, values, (h, c))."""
    h, c = state
    gates = torch.cat([x, h], dim=-1) @ params["lstm_w"] + params["lstm_b"]
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    c = torch.sigmoid(gf + 1.0) * c + torch.sigmoid(gi) * torch.tanh(gg)
    h = torch.sigmoid(go) * torch.tanh(c)
    logits, values = heads(params, h)
    return logits, values, (h, c)


def forward_lstm(params: Params, obs: torch.Tensor, state: State
                 ) -> Tuple[torch.Tensor, torch.Tensor, State]:
    """-> (logits [B, A], values [B], new_state)."""
    x = obs.float().reshape(obs.shape[0], -1)
    i = 0
    while f"t{i}_w" in params:
        x = torch.tanh(x @ params[f"t{i}_w"] + params[f"t{i}_b"])
        i += 1
    return lstm_step(params, x, state)


def init_conv_lstm_policy(generator: Optional[torch.Generator],
                          obs_shape: Tuple[int, ...], num_actions: int,
                          cell: int = 64, dense: int = 256) -> Params:
    """Nature-CNN trunk with dense ``dense``, the LSTM cell, then the
    heads (the catalog's vision-plus-LSTM wrapping)."""
    params = init_conv_trunk(generator, obs_shape, dense)
    params.update(_init_lstm(generator, dense, cell, num_actions))
    return params


def forward_conv_lstm(params: Params, obs: torch.Tensor, state: State
                      ) -> Tuple[torch.Tensor, torch.Tensor, State]:
    """[B, H, W, C] frames (uint8 normalised as ``forward_conv``; the
    trunk in bf16) -> (logits, values, new_state), the cell in fp32."""
    return lstm_step(params, conv_trunk(params, obs), state)


def get_network(obs_shape: Tuple[int, ...], num_actions: int,
                model_config: Optional[Dict] = None) -> Network:
    """The catalog's entry point: the custom registry first, then the
    LSTM wrapper, then conv or MLP by the observation's rank."""
    cfg = dict(MODEL_DEFAULTS)
    cfg.update(model_config or {})
    custom = cfg.get("custom_model")
    if custom is not None:
        if callable(custom):
            # A factory passed itself survives pickling into remote
            # rollout workers; the name registry is per process.
            return custom(obs_shape, num_actions, cfg)
        if custom not in _CUSTOM_MODELS:
            raise ValueError(
                f"custom model {custom!r} is not registered "
                f"(known: {sorted(_CUSTOM_MODELS)}). With remote rollout "
                "workers pass the factory itself as custom_model: the name "
                "registry is per process")
        return _CUSTOM_MODELS[custom](obs_shape, num_actions, cfg)
    if cfg.get("use_lstm"):
        cell = int(cfg["lstm_cell_size"])

        def initial_state(batch, device=None):
            return lstm_initial_state(batch, cell, device)

        if len(obs_shape) == 3:
            # Frames: a conv trunk under the cell (an MLP over raw
            # [0, 255] pixels would saturate at once).
            return Network("conv_lstm", lambda g: init_conv_lstm_policy(
                g, obs_shape, num_actions, cell), None, initial_state,
                forward_conv_lstm)
        obs_dim = int(np.prod(obs_shape))
        hidden = tuple(cfg["fcnet_hiddens"])
        return Network("lstm", lambda g: init_lstm_policy(
            g, obs_dim, num_actions, hidden, cell), None, initial_state,
            forward_lstm)
    return make_network(obs_shape, num_actions, cfg.get("network", "auto"),
                        tuple(cfg["fcnet_hiddens"]))


def scan_sequence(apply_state: Callable, params: Params, obs: torch.Tensor,
                  dones: torch.Tensor, state: State
                  ) -> Tuple[torch.Tensor, torch.Tensor, State]:
    """A recurrent network over a [T, N, ...] sequence from ``state``:
    each step runs the cell, then zeros the state of the sequences whose
    episode ended at that step, in the JAX package's order. Returns
    (logits [T, N, A], values [T, N], the state after the last step)."""
    logits, values = [], []
    for t in range(obs.shape[0]):
        lg, v, state = apply_state(params, obs[t], state)
        keep = (1.0 - dones[t].float())[:, None]
        state = tuple(s * keep for s in state)
        logits.append(lg)
        values.append(v)
    return torch.stack(logits), torch.stack(values), state


__all__ = ["MODEL_DEFAULTS", "forward_conv_lstm", "forward_lstm",
           "get_network", "init_conv_lstm_policy", "init_lstm_policy",
           "lstm_initial_state", "register_custom_model", "scan_sequence"]
