"""Vision Transformer (ViT-B/16 family): counterpart of the JAX package's
``models/vit.py``.

Images arrive NHWC ``[B, H, W, 3]`` as there, so ``patchify`` takes the
same patch order. A class token and learned position embeddings, pre-LN
blocks (layer norms in fp32) with fused QKV, **non-causal** attention
through ``ops.attention.attention`` (K1-K3 on the card, at the ragged S =
197 of a 224 image), tanh-GELU MLP, and an fp32 head on the class token.
Parameters keep the JAX package's names and layouts (``qkv_w`` is
``[d, 3d]``, applied as ``y @ w``), one ``Block`` per layer where JAX
stacks them ``[L, ...]``; ``convert.py`` carries a JAX pytree across.

``remat=True`` checkpoints each whole block (``jax.checkpoint`` around the
block there; one ``torch.utils.checkpoint`` region here): a training step
runs K1 twice a layer, K2 and K3 once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention as attention_op
from .common import cross_entropy_loss, layer_norm, truncated_normal


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_mlp: int = 3072
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


CONFIGS: Dict[str, ViTConfig] = {
    "vit-b16": ViTConfig(),
    "vit-s16": ViTConfig(num_layers=12, num_heads=6, d_model=384,
                         d_mlp=1536),
    "vit-b16-cifar": ViTConfig(image_size=32, patch_size=4, num_classes=10),
}


def patchify(images, patch: int):
    """[B, H, W, 3] -> [B, n_patches, patch*patch*3], rows of patches in
    (ph, pw) order, each patch flattened (py, px, c)."""
    b, h, w, c = images.shape
    ph, pw = h // patch, w // patch
    x = images.reshape(b, ph, patch, pw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, ph * pw, patch * patch * c)


class Block(nn.Module):
    """One pre-LN encoder block (``_block`` in the JAX package)."""

    def __init__(self, cfg: ViTConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        d, m = cfg.d_model, cfg.d_mlp
        proj_std = 0.02 / math.sqrt(2 * cfg.num_layers)
        tn = lambda shape, std=0.02: nn.Parameter(
            truncated_normal(shape, generator, stddev=std))
        self.ln1_scale = nn.Parameter(torch.ones(d))
        self.ln1_bias = nn.Parameter(torch.zeros(d))
        self.qkv_w = tn((d, 3 * d))
        self.qkv_b = nn.Parameter(torch.zeros(3 * d))
        self.proj_w = tn((d, d), proj_std)
        self.proj_b = nn.Parameter(torch.zeros(d))
        self.ln2_scale = nn.Parameter(torch.ones(d))
        self.ln2_bias = nn.Parameter(torch.zeros(d))
        self.mlp_in_w = tn((d, m))
        self.mlp_in_b = nn.Parameter(torch.zeros(m))
        self.mlp_out_w = tn((m, d), proj_std)
        self.mlp_out_b = nn.Parameter(torch.zeros(d))

    @staticmethod
    def _dense(y, w, b):
        return F.linear(y, w.to(y.dtype).t(), b.to(y.dtype))

    def forward(self, x):
        b, s, d = x.shape
        h, hd = self.cfg.num_heads, self.cfg.head_dim
        y = layer_norm(x, self.ln1_scale, self.ln1_bias)
        qkv = self._dense(y, self.qkv_w, self.qkv_b)
        # [B,S,D] -> [B,H,S,hd], contiguous for the kernels
        q, k, v = (t.reshape(b, s, h, hd).transpose(1, 2).contiguous()
                   for t in qkv.split(d, dim=-1))
        o = attention_op(q, k, v, causal=False)
        o = o.transpose(1, 2).reshape(b, s, d)
        x = x + self._dense(o, self.proj_w, self.proj_b)
        y = layer_norm(x, self.ln2_scale, self.ln2_bias)
        hdn = F.gelu(self._dense(y, self.mlp_in_w, self.mlp_in_b),
                     approximate="tanh")
        return x + self._dense(hdn, self.mlp_out_w, self.mlp_out_b)


class ViT(nn.Module):
    """ViT classifier. Parameters are created fp32 on the CPU from
    ``generator`` (move the module with ``.to(device)``)."""

    def __init__(self, cfg: ViTConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        patch_dim = cfg.patch_size * cfg.patch_size * 3
        self.patch_w = nn.Parameter(truncated_normal((patch_dim, d),
                                                     generator))
        self.patch_b = nn.Parameter(torch.zeros(d))
        self.cls_token = nn.Parameter(truncated_normal((1, 1, d), generator))
        self.pos_embed = nn.Parameter(truncated_normal(
            (cfg.num_patches + 1, d), generator, stddev=0.01))
        self.blocks = nn.ModuleList(Block(cfg, generator)
                                    for _ in range(cfg.num_layers))
        self.lnf_scale = nn.Parameter(torch.ones(d))
        self.lnf_bias = nn.Parameter(torch.zeros(d))
        self.head_w = nn.Parameter(torch.zeros(d, cfg.num_classes))
        self.head_b = nn.Parameter(torch.zeros(cfg.num_classes))

    def forward(self, images):
        """images [B, H, W, 3] -> fp32 logits [B, classes]."""
        dt = self.cfg.dtype
        patches = patchify(images.to(dt), self.cfg.patch_size)
        x = patches @ self.patch_w.to(dt) + self.patch_b.to(dt)
        cls = self.cls_token.to(dt).expand(x.shape[0], 1, self.cfg.d_model)
        x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed[: x.shape[1]].to(dt)[None]
        for block in self.blocks:
            if self.cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        x = layer_norm(x, self.lnf_scale, self.lnf_bias)
        return x[:, 0].float() @ self.head_w.float() + self.head_b

    def loss_fn(self, batch):
        """batch: {"image": [B, H, W, 3], "label": [B]} -> mean CE."""
        loss, _ = cross_entropy_loss(self(batch["image"]), batch["label"])
        return loss


def flops_per_image(cfg: ViTConfig, num_params: int) -> float:
    """Training FLOPs of one image: (6N + 12·L·d·S) a token over its S =
    patches + 1 tokens (the GPT-2 formula, recompute not counted)."""
    s = cfg.num_patches + 1
    return s * (6.0 * num_params + 12 * cfg.num_layers * cfg.d_model * s)
