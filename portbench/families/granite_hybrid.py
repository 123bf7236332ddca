"""Granite 4.0-H for the benchmark: sizes from a configuration file, weights
from the seed, the program's model and training step, and the plain
reference.

A configuration file holds the published ``config.json`` keys of a
``granitemoehybrid`` model, cut as its ``reduced`` and ``deployment`` say:
``num_hidden_layers`` and ``layer_types`` the layers kept,
``num_local_experts`` the experts this chip holds, from
``deployment["experts_held_first"]``, while the router keeps
``deployment["router_experts"]`` outputs. ``recipe`` gives the parameters'
type, the optimizer and its learning rate.

The weights are the benchmark's: each parameter, by the program's name,
drawn on the device from the seed in one call (``param_shapes``: the
modeling code's initialisation), rounded to the recipe's type; the program
is handed copies and the reference gets them again from the same seed. Each
parameter is a leaf of its own (the optimizer's and the comparison's).

The program's model module is imported here, at the family's import, so
that a checkout without it fails as the cell is loaded.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch.models import granite_hybrid as program

from .. import roofline_ssd
from ..reference import granite_hybrid as reference


def held(conf: Dict) -> Tuple[int, int]:
    """(first, count) of the experts this chip holds."""
    return conf["deployment"]["experts_held_first"], conf["num_local_experts"]


def reference_conf(conf: Dict) -> Dict:
    """The configuration as the reference reads it: the router over every
    expert of the deployment."""
    return {**conf, "num_local_experts": conf["deployment"]["router_experts"]}


def sizes(conf: Dict) -> Dict[str, int]:
    return {"layers": conf["num_hidden_layers"]}


def param_shapes(conf: Dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Each parameter's shape and initialisation ("normal", "ones",
    "zeros" or "a_log"), by the program's names, in the order drawn."""
    d, v = conf["hidden_size"], conf["vocab_size"]
    heads, p, n = (conf["mamba_n_heads"], conf["mamba_d_head"],
                   conf["mamba_d_state"])
    di, conv = heads * p, heads * p + 2 * n
    qh, kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = d // qh
    m, ms = conf["intermediate_size"], conf["shared_intermediate_size"]
    count, experts = conf["num_local_experts"], \
        conf["deployment"]["router_experts"]
    out = {"embed": ((v, d), "normal")}
    for i, kind in enumerate(conf["layer_types"]):
        pre = f"layers.{i}."
        out[pre + "input_norm"] = ((d,), "ones")
        if kind == "mamba":
            out.update({
                pre + "mamba.in_proj": ((d, di + conv + heads), "normal"),
                pre + "mamba.conv_w": ((conv, conf["mamba_d_conv"]),
                                       "normal"),
                pre + "mamba.conv_b": ((conv,), "zeros"),
                pre + "mamba.dt_bias": ((heads,), "ones"),
                pre + "mamba.A_log": ((heads,), "a_log"),
                pre + "mamba.D": ((heads,), "ones"),
                pre + "mamba.norm": ((di,), "ones"),
                pre + "mamba.out_proj": ((di, d), "normal")})
        else:
            out.update({
                pre + "attn.wq": ((d, qh * hd), "normal"),
                pre + "attn.wk": ((d, kv * hd), "normal"),
                pre + "attn.wv": ((d, kv * hd), "normal"),
                pre + "attn.wo": ((qh * hd, d), "normal")})
        out.update({
            pre + "post_norm": ((d,), "ones"),
            pre + "moe.router": ((d, experts), "normal"),
            pre + "moe.experts_in": ((count, d, 2 * m), "normal"),
            pre + "moe.experts_out": ((count, m, d), "normal"),
            pre + "moe.shared_in": ((d, 2 * ms), "normal"),
            pre + "moe.shared_out": ((ms, d), "normal")})
    out["final_norm"] = ((d,), "ones")
    return out


def param_dtype(conf: Dict):
    return getattr(torch, conf["recipe"]["param_dtype"])


def make_weights(conf: Dict, seed: int, device) -> Dict:
    """The initial weights from ``seed``, parameter by parameter on
    ``device`` in the recipe's type."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = param_dtype(conf)
    std = conf["initializer_range"]
    out = {}
    for name, (shape, kind) in param_shapes(conf).items():
        if kind == "normal":
            t = torch.empty(shape, device=device).normal_(0.0, std,
                                                          generator=gen)
        elif kind == "a_log":
            t = torch.log(torch.arange(1, shape[0] + 1, device=device,
                                       dtype=torch.float32))
        else:
            t = (torch.ones if kind == "ones" else torch.zeros)(
                shape, device=device)
        out[name] = t.to(dtype)
        del t
    return out


def make_batches(conf: Dict, mix: Dict, seed: int, count: int, device):
    """``count`` batches [B, S + 1] of tokens uniform on the published
    vocabulary, drawn from ``seed`` (numpy's ``default_rng``)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, conf["vocab_size"],
                        (count, mix["batch"], mix["seq"] + 1))
    return list(torch.from_numpy(toks).to(device).unbind(0))


def build_program(conf: Dict, weights: Dict, device):
    """The program's model, as ``build_train``'s ``init_fn``, and its loss:
    ``GraniteHybrid`` built on ``device`` in the recipe's type and given
    ``weights``."""
    if conf["recipe"]["remat"] != "per layer":
        raise ValueError("the program recomputes each layer: recipe remat "
                         f"{conf['recipe']['remat']!r} is not 'per layer'")
    cfg = program.GraniteHybridConfig.from_dict(
        reference_conf(conf), experts_held=held(conf),
        dtype=param_dtype(conf))

    def init_fn(_generator) -> torch.nn.Module:
        # Its own draws on the device are overwritten below.
        model = program.GraniteHybrid(cfg, device=device)
        params = dict(model.named_parameters())
        if set(params) != set(weights):
            raise ValueError("the program's parameters are not the "
                             "benchmark's: "
                             f"{sorted(set(params) ^ set(weights))[:8]}")
        with torch.no_grad():
            for name, t in weights.items():
                params[name].copy_(t)
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
    """The program's tensor of one leaf, as ``[1, ...]``."""
    return named[leaf][None]


def leaf_name(name: str) -> str:
    return name


unit_norms = reference.unit_norms


def by_leaf(named: Dict, layers: int) -> Dict:
    return dict(named)


def reference_train(conf: Dict, weights: Dict, batches: List,
                    precision: str = "fp32") -> Dict:
    """The plain reference's steps on ``batches`` from ``weights``."""
    return reference.train(weights, batches, reference_conf(conf),
                           held(conf), conf["recipe"]["learning_rate"],
                           precision, param_dtype(conf))


def _scan_shape(conf: Dict, mix: Dict) -> Tuple[int, ...]:
    return (mix["batch"], mix["seq"], conf["mamba_n_heads"],
            conf["mamba_d_head"], conf["mamba_d_state"])


def touched_params(conf: Dict) -> float:
    """The parameters a token touches: everything outside the routed
    experts, and of the held experts the share a token reaches on average
    (``num_experts_per_tok`` x held / router experts of one expert)."""
    d = conf["hidden_size"]
    shapes = param_shapes(conf)
    whole = sum(math.prod(s) for n, (s, _) in shapes.items()
                if not n.endswith(("experts_in", "experts_out")))
    per_expert = 3 * d * conf["intermediate_size"]
    reach = conf["num_experts_per_tok"] * conf["num_local_experts"] \
        / conf["deployment"]["router_experts"]
    return whole + conf["num_hidden_layers"] * reach * per_expert


def flops_per_token(conf: Dict, seq: int) -> float:
    """Training operations a token, recompute not counted: 6 x the
    parameters it touches (``touched_params``), the attention layers' 12 x
    heads x head size x S (PaLM, appendix B), and 3 x the chunked scan's
    forward products a token (``roofline_ssd``) in each Mamba layer."""
    kinds = conf["layer_types"]
    attn = 12.0 * kinds.count("attention") * conf["hidden_size"] * seq
    b, s, h, p, n = _scan_shape(conf, {"batch": 1, "seq": seq})
    scan = roofline_ssd.ssd_call(b, s, h, p, n, conf["mamba_chunk_size"])
    per_token = 3.0 * scan["fwd"]["flops"] / seq
    return 6.0 * touched_params(conf) + attn + kinds.count("mamba") \
        * per_token


def attention_calls(conf: Dict, mix: Dict) -> Tuple[Tuple[int, ...], int]:
    """The shape [B, H, S, D] of each attention call of a step (the query
    heads: the KV heads are expanded onto them before the kernels), and the
    calls a step makes: one forward and one backward an attention layer.
    The forward that per-layer remat runs again in the backward is in the
    time the calls take, not in their bound."""
    heads = conf["num_attention_heads"]
    return ((mix["batch"], heads, mix["seq"], conf["hidden_size"] // heads),
            conf["layer_types"].count("attention"))


def attention_entry():
    """The program's attention op (an autograd Function) whose forward and
    backward the traced run brackets."""
    from ray_tpu_torch.ops.attention import _Flash

    return _Flash


def build_kernels() -> Dict[str, float]:
    """Builds (or finds built) the kernels this family's path launches."""
    from ray_tpu_torch.ops import _build

    return _build.build(["flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"])
