"""Carries GPT-2, Llama, ViT, ResNet and RL parameters between
the JAX package's pytrees and the port's modules.

The JAX tree arrives as nested dicts of numpy arrays (``np.asarray`` of
each leaf). Block leaves are stacked ``[L, ...]`` there and are one
tensor per layer here (``blocks.<i>.<name>``; ``layers.<name>``
``[L, ...]`` once a GPT-2's layers are stacked), whatever the leaf: a MoE
GPT-2's ``router_w`` ``[L, d, E]``, ``moe_in_w`` ``[L, E, d, m]`` and
``moe_out_w`` ``[L, E, m, d]`` cross like the dense ones. bf16 leaves
are numpy arrays of an extension dtype named ``bfloat16``; they cross as
their ``uint16`` bits and are viewed as ``torch.bfloat16``, bit for bit.

The RL networks and ResNet's parameters and batch statistics are flat
dicts under the same names on both sides; conv weights are HWIO there and
OIHW here, and the conv policies' dense rows keep JAX's (h, w, c) order.
The ``ppo_*`` functions carry every RL tree: the MLP and conv policies,
the catalog's LSTM and conv-LSTM (``lstm_w`` ``[feat + cell, 4 * cell]``
with its gates in the order i, f, g, o, which the port's cell keeps, so
it crosses as it is) and DQN's Q-net. The ``rl_tree_*`` functions carry
the nested trees of SAC, TD3 and CQL and the fitted-Q model's list of
layers as they are; ``ravel_tree``/``unravel_tree`` give ES's flat
vector in ``jax.flatten_util.ravel_pytree``'s order.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

_GPT2_TOP = ("wte", "wpe", "lnf_scale", "lnf_bias")
_LLAMA_TOP = ("wte", "final_norm")
_VIT_TOP = ("patch_w", "patch_b", "cls_token", "pos_embed", "lnf_scale",
            "lnf_bias", "head_w", "head_b")


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


def _params_from_numpy(tree: Mapping, cfg, top: Sequence[str]
                       ) -> Dict[str, torch.Tensor]:
    state = {name: tensor_from_numpy(tree[name]) for name in top}
    for name, stacked in tree["blocks"].items():
        t = tensor_from_numpy(stacked)
        if t.shape[0] != cfg.num_layers:
            raise ValueError(f"blocks.{name} has {t.shape[0]} layers, "
                             f"config has {cfg.num_layers}")
        for i in range(cfg.num_layers):
            state[f"blocks.{i}.{name}"] = t[i].clone()
    return state


def _tree_to_numpy(named: Mapping[str, torch.Tensor], cfg,
                   top: Sequence[str]) -> Dict:
    tree = {name: tensor_to_numpy(named[name]) for name in top}
    stacked = {k.split(".", 1)[1]: tensor_to_numpy(v)
               for k, v in named.items() if k.startswith("layers.")}
    if stacked:  # a model whose layers are stacked (GPT2.stack_layers)
        tree["blocks"] = dict(sorted(stacked.items()))
        return tree
    names = {k.split(".", 2)[2] for k in named if k.startswith("blocks.")}
    tree["blocks"] = {
        n: np.stack([tensor_to_numpy(named[f"blocks.{i}.{n}"])
                     for i in range(cfg.num_layers)])
        for n in sorted(names)}
    return tree


def gpt2_params_from_numpy(tree: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX GPT-2 pytree (numpy leaves) -> the ``GPT2`` module's state dict."""
    return _params_from_numpy(tree, cfg, _GPT2_TOP)


def gpt2_tree_to_numpy(named: Mapping[str, torch.Tensor], cfg) -> Dict:
    """Module-named tensors (parameters or their gradients) -> the JAX
    pytree layout as fp32 numpy, block leaves stacked ``[L, ...]``."""
    return _tree_to_numpy(named, cfg, _GPT2_TOP)


def llama_params_from_numpy(tree: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX Llama pytree (numpy leaves) -> the ``Llama`` module's state
    dict."""
    return _params_from_numpy(tree, cfg, _LLAMA_TOP)


def llama_tree_to_numpy(named: Mapping[str, torch.Tensor], cfg) -> Dict:
    """Module-named tensors (parameters or their gradients) -> the JAX
    Llama pytree layout as fp32 numpy, block leaves stacked ``[L, ...]``."""
    return _tree_to_numpy(named, cfg, _LLAMA_TOP)


def vit_params_from_numpy(tree: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX ViT pytree (numpy leaves) -> the ``ViT`` module's state dict."""
    return _params_from_numpy(tree, cfg, _VIT_TOP)


def vit_tree_to_numpy(named: Mapping[str, torch.Tensor], cfg) -> Dict:
    """Module-named tensors (parameters or their gradients) -> the JAX ViT
    pytree layout as fp32 numpy, block leaves stacked ``[L, ...]``."""
    return _tree_to_numpy(named, cfg, _VIT_TOP)


def resnet_params_from_numpy(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ResNet params or batch statistics (flat, numpy leaves) -> the
    port's: 4-D leaves are conv kernels, HWIO there, OIHW here."""
    return {name: tensor_from_numpy(np.transpose(arr, (3, 2, 0, 1))
                                    if np.ndim(arr) == 4 else arr)
            for name, arr in tree.items()}


def resnet_tree_to_numpy(named: Mapping[str, torch.Tensor]) -> Dict:
    """The port's ResNet tensors (parameters, their gradients or the
    statistics) -> the JAX layout as fp32 numpy."""
    return {name: tensor_to_numpy(t.permute(2, 3, 1, 0) if t.ndim == 4
                                  else t)
            for name, t in named.items()}


def _is_conv(name: str) -> bool:
    return name.startswith("conv") and name.endswith("_w")


def ppo_params_from_numpy(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX RL params (MLP, conv, LSTM, conv-LSTM or Q-net; numpy leaves)
    -> the port's dict."""
    return {name: (tensor_from_numpy(np.transpose(arr, (3, 2, 0, 1)))
                   if _is_conv(name) else tensor_from_numpy(arr))
            for name, arr in tree.items()}


def ppo_tree_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict:
    """The port's RL params (or their gradients) -> the JAX layout as fp32
    numpy."""
    return {name: (tensor_to_numpy(t.permute(2, 3, 1, 0)) if _is_conv(name)
                   else tensor_to_numpy(t))
            for name, t in params.items()}


def rl_tree_from_numpy(tree):
    """A nested JAX RL tree (numpy leaves) -> the same nesting of CPU
    tensors: SAC's, TD3's and CQL's ``{"actor": {...}, "q1": {...}, ...,
    "log_alpha": ()}`` and ``FittedQModel``'s list of ``{"w", "b"}``
    layers. Their dense weights are ``[in, out]`` on both sides."""
    if isinstance(tree, Mapping):
        return {k: rl_tree_from_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [rl_tree_from_numpy(v) for v in tree]
    arr = np.asarray(tree)
    return tensor_from_numpy(arr).reshape(arr.shape)  # 0-d stays 0-d


def rl_tree_to_numpy(tree):
    """The port's nested RL tree (tensors) -> the JAX layout as fp32
    numpy, nested the same way."""
    if isinstance(tree, Mapping):
        return {k: rl_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [rl_tree_to_numpy(v) for v in tree]
    return tensor_to_numpy(tree)


def _ravel_leaves(tree) -> list:
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in _ravel_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _ravel_leaves(v)]
    return [tree]


def ravel_tree(tree) -> np.ndarray:
    """A numpy tree in the JAX layout -> one flat fp32 vector, ordered as
    ``jax.flatten_util.ravel_pytree`` orders it: a dict's keys sorted, a
    list in order, each leaf row-major (ES's parameter vector)."""
    leaves = _ravel_leaves(tree)
    if not leaves:
        return np.zeros(0, np.float32)
    return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                           for x in leaves])


def unravel_tree(flat: np.ndarray, like):
    """``ravel_tree``'s inverse: ``flat`` cut into ``like``'s leaves, as
    fp32 numpy of their shapes, nested as ``like``."""
    flat = np.asarray(flat, np.float32)
    offset = 0

    def cut(node):
        nonlocal offset
        if isinstance(node, Mapping):
            return {k: cut(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [cut(v) for v in node]
        shape = np.shape(node)
        n = int(np.prod(shape))
        out = flat[offset:offset + n].reshape(shape)
        offset += n
        return out

    tree = cut(like)
    if offset != flat.size:
        raise ValueError(f"flat vector of {flat.size} for {offset} values")
    return tree
