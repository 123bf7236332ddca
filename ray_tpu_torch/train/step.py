"""Training-step construction on one device: counterpart of
the JAX package's ``train/step.py``.

``build_train`` returns ``(init, step)`` with the JAX package's flow,
including its ``master_fp32`` mixed precision: the live parameters (and
so the gradients) are bf16, while an fp32 master copy and the optimizer
moments live in the optimizer state; each step updates the master and
casts it back into the live parameters. Parameters, master and moments
are updated in place where JAX would donate and rebind them.

Without the master copy the step is the JAX package's pure one: a model
whose parameters are bf16 (``models.common.cast_floating``) gets bf16
gradients, the optimizer sees the bf16 parameters (so Adafactor's state
is bf16), and ``p + u`` rounds once, as ``optax.apply_updates``. The
optimizer is told which parameters are the layers of one JAX leaf
(``optim.leaf_groups`` of the module's names).

Mesh and sharding (``parallel/``) are not ported yet (ROADMAP Queue A
item 7); this runs on one device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..device import default_device
from .optim import (GradientTransformation, default_optimizer, global_norm,
                    leaf_groups)


def build_train(init_fn: Callable[[torch.Generator], nn.Module],
                loss_fn: Callable[[nn.Module, Dict], torch.Tensor],
                optimizer: Optional[GradientTransformation] = None,
                master_fp32: bool = False,
                device=None) -> Tuple[Callable, Callable]:
    """Build (init, step) on ``device`` (CUDA unless told otherwise).

    Args:
      init_fn: ``generator -> module`` with its parameters, on any device.
      loss_fn: ``(module, batch) -> scalar loss``.

    Returns (init, step) where
      init: ``seed -> (model, opt_state, step)``
      step: ``(model, opt_state, step, batch) ->
              (model, opt_state, step, {"loss", "grad_norm"})``;
        ``grad_norm`` is the norm of the raw gradients, before clipping.
    """
    dev = default_device(device)
    optimizer = optimizer or default_optimizer()

    def init(seed: int = 0):
        model = init_fn(torch.Generator().manual_seed(seed)).to(dev)
        groups = leaf_groups([n for n, _ in model.named_parameters()])
        if master_fp32:
            master = [p.detach().clone() for p in model.parameters()]
            opt_state = {"master": master,
                         "inner": optimizer.init(master, groups)}
            model.to(torch.bfloat16)
        else:
            opt_state = optimizer.init(
                [p.detach() for p in model.parameters()], groups)
        return model, opt_state, 0

    def step(model: nn.Module, opt_state: Any, step: int, batch: Dict):
        params = list(model.parameters())
        batch = {k: v.to(dev) for k, v in batch.items()}
        loss = loss_fn(model, batch)
        loss.backward()
        grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        gnorm = global_norm(grads)
        with torch.no_grad():
            if master_fp32:
                master, inner = opt_state["master"], opt_state["inner"]
                updates, inner = optimizer.update(
                    [g.float() for g in grads], inner, master)
                for m, u, p in zip(master, updates, params):
                    m.add_(u)
                    p.copy_(m)
                opt_state = {"master": master, "inner": inner}
            else:
                updates, opt_state = optimizer.update(
                    grads, opt_state, [p.detach() for p in params])
                for p, u in zip(params, updates):
                    p.copy_(p + u)
        return model, opt_state, step + 1, {"loss": loss.detach(),
                                             "grad_norm": gnorm}

    return init, step
