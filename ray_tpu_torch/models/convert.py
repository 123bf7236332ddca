"""Carries GPT-2 parameters between the JAX package's pytree and the
port's module.

The JAX tree arrives as nested dicts of numpy arrays (``np.asarray`` of
each leaf). Block leaves are stacked ``[L, ...]`` there and are one
tensor per layer here (``blocks.<i>.<name>``). bf16 leaves are numpy
arrays of an extension dtype named ``bfloat16``; they cross as their
``uint16`` bits and are viewed as ``torch.bfloat16``, bit for bit.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_TOP = ("wte", "wpe", "lnf_scale", "lnf_bias")


def tensor_from_numpy(arr) -> torch.Tensor:
    """A CPU tensor with ``arr``'s values and dtype (bf16 included)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """fp32 numpy copy of ``t`` (bf16 widened exactly)."""
    return t.detach().float().cpu().numpy()


def gpt2_params_from_numpy(tree: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX GPT-2 pytree (numpy leaves) -> the ``GPT2`` module's state dict."""
    state = {name: tensor_from_numpy(tree[name]) for name in _TOP}
    for name, stacked in tree["blocks"].items():
        t = tensor_from_numpy(stacked)
        if t.shape[0] != cfg.num_layers:
            raise ValueError(f"blocks.{name} has {t.shape[0]} layers, "
                             f"config has {cfg.num_layers}")
        for i in range(cfg.num_layers):
            state[f"blocks.{i}.{name}"] = t[i].clone()
    return state


def gpt2_tree_to_numpy(named: Mapping[str, torch.Tensor], cfg) -> Dict:
    """Module-named tensors (parameters or their gradients) -> the JAX
    pytree layout as fp32 numpy, block leaves stacked ``[L, ...]``."""
    tree = {name: tensor_to_numpy(named[name]) for name in _TOP}
    names = {k.split(".", 2)[2] for k in named if k.startswith("blocks.")}
    tree["blocks"] = {
        n: np.stack([tensor_to_numpy(named[f"blocks.{i}.{n}"])
                     for i in range(cfg.num_layers)])
        for n in sorted(names)}
    return tree
