"""ResNet family (CIFAR and ImageNet stems): counterpart of the JAX
package's ``models/resnet.py``.

Images arrive NHWC ``[B, H, W, 3]`` as there; inside, activations are
NCHW and conv kernels OIHW, PyTorch's layouts (``convert.py`` turns the
JAX package's HWIO kernels). Batch norm carries its statistics beside the
parameters, as there: ``forward`` and ``loss_fn`` take a stats dict and
return the new one.

Two places where PyTorch's defaults differ from the reference, done here
as the reference does them:

- ``"SAME"`` padding is XLA's: a total of ``max((out - 1) * stride + k -
  in, 0)`` with the odd element after, so a 3x3 stride-2 conv on an even
  input pads 0 before and 1 after (``nn.Conv2d(padding=1)`` pads 1 on
  both sides). The ImageNet stem's 3x3 stride-2 max pool pads the same
  way, with -inf.
- ``batch_norm`` normalizes with the biased batch variance and updates
  ``momentum * old + (1 - momentum) * batch`` with momentum 0.9 (not
  ``nn.BatchNorm2d``'s 0.1 on the new value and unbiased variance).

Convs compute in ``cfg.dtype`` (fp32 for every config here); on the card
an fp32 conv runs TF32 or full fp32 as ``device.fp32_settings()`` says.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import default_device
from .common import cross_entropy_loss, truncated_normal


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)  # resnet-18
    num_classes: int = 10
    width: int = 64
    cifar_stem: bool = True  # 3x3/stride-1 stem, no maxpool
    dtype: torch.dtype = torch.float32


CONFIGS: Dict[str, ResNetConfig] = {
    "resnet18-cifar": ResNetConfig(),
    "resnet34-cifar": ResNetConfig(stage_sizes=(3, 4, 6, 3)),
    "resnet18-imagenet": ResNetConfig(cifar_stem=False, num_classes=1000),
}

Padding = Union[str, Sequence[Tuple[int, int]]]


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad(x, k: Tuple[int, int], stride: int, padding: Padding,
         value: float = 0.0):
    if padding == "SAME":
        (h0, h1), (w0, w1) = (same_pads(x.shape[2], k[0], stride),
                              same_pads(x.shape[3], k[1], stride))
    else:
        (h0, h1), (w0, w1) = padding
    if h0 or h1 or w0 or w1:
        x = F.pad(x, (w0, w1, h0, h1), value=value)
    return x


def conv(x, w, stride: int = 1, padding: Padding = "SAME"):
    """NCHW ``x`` with an OIHW kernel, XLA's padding."""
    x = _pad(x, tuple(w.shape[2:]), stride, padding)
    return F.conv2d(x, w.to(x.dtype), stride=stride)


def max_pool_same(x, k: int = 3, stride: int = 2):
    """``reduce_window(max, -inf, k x k, stride, "SAME")`` on NCHW."""
    return F.max_pool2d(_pad(x, (k, k), stride, "SAME", -math.inf), k,
                        stride)


def batch_norm(x, scale, bias, mean, var, training: bool,
               momentum: float = 0.9, eps: float = 1e-5):
    """NCHW batch norm in fp32; returns (y in x's dtype, new_mean,
    new_var)."""
    xf = x.float()
    if training:
        m = xf.mean(dim=(0, 2, 3))
        v = xf.var(dim=(0, 2, 3), correction=0)
        new_mean = momentum * mean + (1 - momentum) * m
        new_var = momentum * var + (1 - momentum) * v
    else:
        m, v = mean, var
        new_mean, new_var = mean, var
    y = (xf - m[:, None, None]) * torch.rsqrt(v + eps)[:, None, None]
    y = y * scale[:, None, None] + bias[:, None, None]
    return y.to(x.dtype), new_mean, new_var


def _blocks(cfg: ResNetConfig):
    """(prefix, cin, cout, stride, has_proj) of every residual block."""
    cin = cfg.width
    for s, n in enumerate(cfg.stage_sizes):
        cout = cfg.width * (2 ** s)
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            yield f"s{s}b{b}", cin, cout, stride, stride != 1 or cin != cout
            cin = cout


def init_stats(cfg: ResNetConfig, device=None) -> Dict[str, torch.Tensor]:
    """Batch-norm statistics at init: means 0, variances 1, on ``device``
    (CUDA unless the caller passes ``device="cpu"``)."""
    device = default_device(device)
    widths = {"stem_bn": cfg.width}
    for prefix, _, cout, _, proj in _blocks(cfg):
        widths.update({f"{prefix}_bn1": cout, f"{prefix}_bn2": cout})
        if proj:
            widths[f"{prefix}_proj_bn"] = cout
    stats = {}
    for name, c in widths.items():
        stats[f"{name}_mean"] = torch.zeros(c, device=device)
        stats[f"{name}_var"] = torch.ones(c, device=device)
    return stats


class ResNet(nn.Module):
    """ResNet classifier. Parameters (the JAX package's names, conv kernels
    OIHW) are created fp32 on the CPU from ``generator``."""

    def __init__(self, cfg: ResNetConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg

        def conv_w(name, k, cin, cout):
            std = math.sqrt(2.0 / (k * k * cin))
            self.register_parameter(name, nn.Parameter(truncated_normal(
                (cout, cin, k, k), generator, stddev=std)))

        def bn(name, c):
            self.register_parameter(f"{name}_scale",
                                    nn.Parameter(torch.ones(c)))
            self.register_parameter(f"{name}_bias",
                                    nn.Parameter(torch.zeros(c)))

        conv_w("stem_conv", 3 if cfg.cifar_stem else 7, 3, cfg.width)
        bn("stem_bn", cfg.width)
        for prefix, cin, cout, _, proj in _blocks(cfg):
            conv_w(f"{prefix}_conv1", 3, cin, cout)
            bn(f"{prefix}_bn1", cout)
            conv_w(f"{prefix}_conv2", 3, cout, cout)
            bn(f"{prefix}_bn2", cout)
            if proj:
                conv_w(f"{prefix}_proj", 1, cin, cout)
                bn(f"{prefix}_proj_bn", cout)
        width = cfg.width * 2 ** (len(cfg.stage_sizes) - 1)
        self.head_w = nn.Parameter(truncated_normal(
            (width, cfg.num_classes), generator, stddev=0.01))
        self.head_b = nn.Parameter(torch.zeros(cfg.num_classes))

    def forward(self, stats: Dict[str, torch.Tensor], images,
                training: bool = False):
        """images [B, H, W, 3] -> (fp32 logits [B, classes], new_stats)."""
        cfg = self.cfg
        p = dict(self.named_parameters())
        new_stats = dict(stats)

        def apply_bn(name, x):
            y, m, v = batch_norm(x, p[f"{name}_scale"], p[f"{name}_bias"],
                                 stats[f"{name}_mean"], stats[f"{name}_var"],
                                 training)
            new_stats[f"{name}_mean"] = m
            new_stats[f"{name}_var"] = v
            return y

        # Contiguous NCHW: PyTorch's CPU backward of a 1x1 stride-2 conv on
        # a channels-last tensor aborts the process.
        x = images.to(cfg.dtype).permute(0, 3, 1, 2).contiguous()
        if cfg.cifar_stem:
            x = conv(x, p["stem_conv"], 1)
        else:
            x = conv(x, p["stem_conv"], 2, padding=((3, 3), (3, 3)))
        x = torch.relu(apply_bn("stem_bn", x))
        if not cfg.cifar_stem:
            x = max_pool_same(x)
        for prefix, _, _, stride, proj in _blocks(cfg):
            shortcut = x
            y = torch.relu(apply_bn(f"{prefix}_bn1",
                                    conv(x, p[f"{prefix}_conv1"], stride)))
            y = apply_bn(f"{prefix}_bn2", conv(y, p[f"{prefix}_conv2"], 1))
            if proj:
                shortcut = apply_bn(f"{prefix}_proj_bn", conv(
                    shortcut, p[f"{prefix}_proj"], stride))
            x = torch.relu(y + shortcut)
        x = x.float().mean(dim=(2, 3))
        return x @ self.head_w + self.head_b, new_stats

    def loss_fn(self, stats, batch, training: bool = True):
        """batch: {"image": [B,H,W,3], "label": [B]} -> (loss, (new_stats,
        acc))."""
        logits, new_stats = self(stats, batch["image"], training)
        labels = batch["label"]
        loss, _ = cross_entropy_loss(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, (new_stats, acc)
