"""Models of the port (counterparts of the JAX package's ``models``):
GPT-2, Llama, ResNet and ViT, and ``common``; and Granite 4.0-H
(``granite_hybrid``), which the JAX package does not have. Each family
loads when first named (``ray_tpu_torch.models.gpt2``), as in the JAX
package.
"""

import importlib

__all__ = ["common", "gpt2", "granite_hybrid", "llama", "resnet", "vit"]


def __getattr__(name):
    # Lazy: rollout workers import models.common at actor startup; don't
    # make every worker pay for loading all model families.
    if name in __all__:
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
