"""GPT-2 for the benchmark: sizes from a configuration file, weights from
the seed, the program's model and training step, and the plain reference.

A configuration file holds the published ``config.json`` keys of a GPT-2
(``n_layer``, ``n_embd``, ``n_head``, ``n_inner``, ``n_positions``,
``vocab_size``) and a ``recipe``: the parameters' type, the optimizer and
its learning rate, the remat policy, the attention path, and the vocabulary
as the program pads it.

The weights are the benchmark's, not the program's: each leaf of the JAX
package's layout (the block parameters stacked ``[L, ...]``) is drawn on
the device from the seed in one call, GPT-2's initialisation (truncated
normals of std 0.02, the residual projections' scaled by 1/sqrt(2L), the
position table's 0.01; layer norms at 1 and 0, biases 0), and rounded to
the type the recipe trains in. The program's ``GPT2`` is built on the card
and handed copies of them, and the reference gets them again from the same
seed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import roofline
from ..reference import gpt2 as reference


LEAVES = ("wte", "wpe", *(f"blocks.{n}" for n in reference.BLOCK_LEAVES),
          "lnf_scale", "lnf_bias")


def sizes(conf: Dict) -> Dict[str, int]:
    """Layers, width, heads, MLP width, the padded and the published
    vocabulary, and the positions of a configuration file."""
    d = conf["n_embd"]
    return {"layers": conf["n_layer"], "d": d, "heads": conf["n_head"],
            "mlp": conf.get("n_inner") or 4 * d,
            "vocab": conf["recipe"]["padded_vocab_size"],
            "tokens": conf["vocab_size"], "positions": conf["n_positions"]}


def leaf_shapes(sz: Dict[str, int]) -> Dict[str, Tuple[Tuple[int, ...],
                                                       str, float]]:
    """Each leaf's shape and initialisation ("normal" with its std, "ones"
    or "zeros"), in the order they are drawn."""
    L, d, m = sz["layers"], sz["d"], sz["mlp"]
    res = 0.02 / math.sqrt(2 * L)
    return {
        "wte": ((sz["vocab"], d), "normal", 0.02),
        "wpe": ((sz["positions"], d), "normal", 0.01),
        "blocks.ln1_scale": ((L, d), "ones", 0.0),
        "blocks.ln1_bias": ((L, d), "zeros", 0.0),
        "blocks.qkv_w": ((L, d, 3 * d), "normal", 0.02),
        "blocks.qkv_b": ((L, 3 * d), "zeros", 0.0),
        "blocks.proj_w": ((L, d, d), "normal", res),
        "blocks.proj_b": ((L, d), "zeros", 0.0),
        "blocks.ln2_scale": ((L, d), "ones", 0.0),
        "blocks.ln2_bias": ((L, d), "zeros", 0.0),
        "blocks.mlp_in_w": ((L, d, m), "normal", 0.02),
        "blocks.mlp_in_b": ((L, m), "zeros", 0.0),
        "blocks.mlp_out_w": ((L, m, d), "normal", res),
        "blocks.mlp_out_b": ((L, d), "zeros", 0.0),
        "lnf_scale": ((d,), "ones", 0.0),
        "lnf_bias": ((d,), "zeros", 0.0),
    }


def param_dtype(conf: Dict):
    return getattr(torch, conf["recipe"]["param_dtype"])


def make_weights(conf: Dict, seed: int, device) -> Dict:
    """The initial weights from ``seed``, leaf by leaf on ``device`` in the
    recipe's type."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = param_dtype(conf)
    out = {}
    for name, (shape, kind, std) in leaf_shapes(sizes(conf)).items():
        if kind == "normal":
            t = torch.empty(shape, device=device)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
            out[name] = (t * std).to(dtype)
            del t
        else:
            fill = torch.ones if kind == "ones" else torch.zeros
            out[name] = fill(shape, device=device, dtype=dtype)
    return out


def make_batches(conf: Dict, mix: Dict, seed: int, count: int, device):
    """``count`` batches [B, S + 1] of tokens uniform on the published
    vocabulary, drawn from ``seed`` (numpy's ``default_rng``)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, conf["vocab_size"],
                        (count, mix["batch"], mix["seq"] + 1))
    return list(torch.from_numpy(toks).to(device).unbind(0))


def program_name(leaf: str, layer: int) -> str:
    """The program's parameter name of ``leaf`` at ``layer``."""
    if leaf.startswith("blocks."):
        return f"blocks.{layer}.{leaf[len('blocks.'):]}"
    return leaf


def build_program(conf: Dict, weights: Dict, device):
    """The program's model, as ``build_train``'s ``init_fn``, and its loss:
    ``ray_tpu_torch``'s ``GPT2`` built on ``device``, cast to the recipe's
    type and given ``weights``."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.common import cast_floating

    sz, recipe = sizes(conf), conf["recipe"]
    cfg = gpt2.GPT2Config(
        vocab_size=sz["vocab"], max_seq=sz["positions"],
        num_layers=sz["layers"], num_heads=sz["heads"], d_model=sz["d"],
        d_mlp=sz["mlp"], dtype=param_dtype(conf),
        attention_impl=recipe["attention_impl"],
        remat_policy=recipe["remat_policy"])

    def init_fn(_generator) -> torch.nn.Module:
        # Its own draws on the device are overwritten below.
        with torch.device(device):
            model = cast_floating(gpt2.GPT2(cfg), param_dtype(conf))
        params = dict(model.named_parameters())
        with torch.no_grad():
            for leaf, t in weights.items():
                parts = t.unbind(0) if leaf.startswith("blocks.") else (t,)
                for j, part in enumerate(parts):
                    params[program_name(leaf, j)].copy_(part)
        return model

    return init_fn, lambda model, batch: model.loss_fn(batch)


def optimizer(conf: Dict):
    """The recipe's optimizer, from the program."""
    from ray_tpu_torch.train import optim

    recipe = conf["recipe"]
    if recipe["optimizer"] != "adafactor":
        raise ValueError(f"no optimizer {recipe['optimizer']!r} here")
    return optim.adafactor(recipe["learning_rate"])


def leaf_of(named: Dict, leaf: str, layers: int):
    """The program's tensors (keyed by its names) of one leaf, stacked:
    [L, ...] for a block leaf, [1, ...] for the others."""
    if leaf.startswith("blocks."):
        return torch.stack([named[program_name(leaf, j)]
                            for j in range(layers)])
    return named[leaf][None]


def leaf_name(name: str) -> str:
    """The leaf of the program's parameter ``name``."""
    parts = name.split(".")
    return f"blocks.{parts[2]}" if parts[0] == "blocks" else name


unit_norms = reference.unit_norms


def by_leaf(named: Dict, layers: int) -> Dict:
    """Per-parameter norm vectors of the program (keyed by its names),
    joined by leaf in layer order, as ``reference.leaf_norms`` lays them
    out."""
    return {leaf: (torch.cat([named[program_name(leaf, j)]
                              for j in range(layers)])
                   if leaf.startswith("blocks.") else named[leaf])
            for leaf in LEAVES}


def reference_train(conf: Dict, weights: Dict, batches: List,
                    precision: str = "fp32") -> Dict:
    """The plain reference's steps on ``batches`` from ``weights``."""
    return reference.train(weights, batches, sizes(conf)["heads"],
                           conf["recipe"]["learning_rate"], precision,
                           param_dtype(conf))


def flops_per_token(conf: Dict, seq: int) -> float:
    sz = sizes(conf)
    return roofline.gpt2_flops_per_token(sz["vocab"], sz["positions"],
                                         sz["layers"], sz["d"], sz["mlp"],
                                         seq)


def attention_calls(conf: Dict, mix: Dict) -> Tuple[Tuple[int, ...], int]:
    """The shape [B, H, S, D] of each attention call of a step, and the
    calls a step makes (one forward and one backward a layer)."""
    sz = sizes(conf)
    return ((mix["batch"], sz["heads"], mix["seq"], sz["d"] // sz["heads"]),
            sz["layers"])


def attention_entry():
    """The program's attention op (an autograd Function) whose forward and
    backward the traced run brackets."""
    from ray_tpu_torch.ops.attention import _Flash

    return _Flash


def build_kernels() -> Dict[str, float]:
    """Builds (or finds built) the kernels this family's path launches."""
    from ray_tpu_torch.ops import _build

    return _build.build(["flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"])
