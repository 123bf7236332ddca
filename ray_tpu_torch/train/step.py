"""Training-step construction: counterpart of the JAX package's
``train/step.py``.

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

``build_sharded_train`` is the JAX package's namesake over a
``DeviceMesh``: parameters and optimizer state are DTensors placed by the
pruned rules, each rank passes the whole batch and keeps its
("dp", "fsdp") share, and the step runs the model's loss under the mesh
(``sharding.use_mesh``). Both builders share the optimizer's set-up and
update (``_init_state``, ``_apply_updates``).

Each step of either is one trace of device spans
(``observability.tracing.device_span``), recorded while the tracer is
enabled or a torch profiler records: ``train.step`` (attributes ``step``,
``tokens``, on a card the allocator's ``reserved_bytes`` at its end, and
whatever the ops count onto their trace, ``tracing.count``) over
``train.forward`` (the loss), ``train.backward`` (the backward with any
remat recompute, and on a mesh each gradient brought to its parameter's
layout) and ``train.optimizer`` (the global norm and ``_apply_updates``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..device import default_device
from ..observability import tracing
from ..parallel.sharding import (Rules, distribute, place,
                                 prune_rules_for_mesh, spec_for, use_mesh)
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
        return model, _init_state(model, optimizer, master_fp32), 0

    def step(model: nn.Module, opt_state: Any, step: int, batch: Dict):
        with tracing.device_span("train.step", dev) as root:
            params = list(model.parameters())
            batch = {k: v.to(dev) for k, v in batch.items()}
            with tracing.device_span("train.forward", dev):
                loss = loss_fn(model, batch)
            with tracing.device_span("train.backward", dev):
                loss.backward()
            grads = [p.grad for p in params]
            for p in params:
                p.grad = None
            with tracing.device_span("train.optimizer", dev):
                gnorm = global_norm(grads)
                opt_state = _apply_updates(optimizer, opt_state, params,
                                           grads, master_fp32)
            if root is not None:
                _annotate(root, step, batch, dev)
        return model, opt_state, step + 1, {"loss": loss.detach(),
                                             "grad_norm": gnorm}

    return init, step


def _annotate(root, step: int, batch: Dict, dev) -> None:
    """The ``train.step`` span's own attributes, at the step's end."""
    root.attributes["step"] = step
    if "tokens" in batch:
        root.attributes["tokens"] = batch["tokens"].numel()
    if dev.type == "cuda":
        root.attributes["reserved_bytes"] = torch.cuda.memory_reserved(dev)


def _init_state(model: nn.Module, optimizer: GradientTransformation,
                master_fp32: bool) -> Any:
    """The optimizer state of ``model``'s parameters. With ``master_fp32``
    the state holds an fp32 master copy and the module is cast to bf16."""
    params = [p.detach() for p in model.parameters()]
    groups = leaf_groups([n for n, _ in model.named_parameters()])
    if not master_fp32:
        return optimizer.init(params, groups)
    master = [p.clone() for p in params]
    model.to(torch.bfloat16)
    return {"master": master, "inner": optimizer.init(master, groups)}


def _apply_updates(optimizer: GradientTransformation, opt_state: Any,
                   params, grads, master_fp32: bool) -> Any:
    """One optimizer update of ``params`` (in place); returns the new
    state. With the master copy the fp32 master takes the update and is
    cast back into the live parameters; without it ``p + u`` rounds once,
    as ``optax.apply_updates``."""
    with torch.no_grad():
        if master_fp32:
            master, inner = opt_state["master"], opt_state["inner"]
            updates, inner = optimizer.update(
                [g.float() for g in grads], inner, master)
            for m, u, p in zip(master, updates, params):
                m.add_(u)
                p.copy_(m)
            return {"master": master, "inner": inner}
        updates, opt_state = optimizer.update(
            grads, opt_state, [p.detach() for p in params])
        for p, u in zip(params, updates):
            p.copy_(p + u)
        return opt_state


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def build_sharded_train(
    init_fn: Callable[[torch.Generator], nn.Module],
    loss_fn: Callable[[nn.Module, Dict], torch.Tensor],
    mesh,
    rules: Optional[Rules] = None,
    optimizer: Optional[GradientTransformation] = None,
    master_fp32: bool = False,
) -> Tuple[Callable, Callable, Rules]:
    """Build (init, step) over a ``DeviceMesh`` (``MeshSpec.build()``).

    Args:
      init_fn: ``generator -> module``; every rank makes the same module
        from the same seed. Its ``logical_axes()`` (name -> logical axes)
        places each parameter; a module without it is replicated. Where
        the rules map "layers" to a mesh axis (pp), a module with
        ``stack_layers()`` stacks its layers first, so that each stage
        holds only its own.
      loss_fn: ``(module, batch) -> scalar loss``, mesh-rule aware through
        the model's ``constrain`` and ``smap`` regions (pass it the pruned
        rules, as the JAX package's callers do).
      mesh: the mesh; rules are pruned to its non-trivial axes.
      master_fp32: live parameters (and so gradients) bf16, an fp32 master
        copy in the optimizer state, as ``build_train``.

    Returns (init, step, rules) where
      init: ``seed -> (model, opt_state, step)``, placed on the mesh;
      step: ``(model, opt_state, step, batch) ->
              (model, opt_state, step, {"loss", "grad_norm"})``, the batch
        whole on every rank. The metrics are plain tensors, the same on
        every rank.

    Parameters, gradients and optimizer state are DTensors, so the
    optimizer's reductions (the global norm) span the shards. Batch
    tensors of 2 or more dims are sharded on their first dim by the
    "batch" rule. The JAX package also shards their second dim by "seq";
    here the tokens carry S + 1 positions, which sp need not divide, so the
    model shards the sequence at its embedding instead.
    """
    rules = prune_rules_for_mesh(mesh, rules)
    optimizer = optimizer or default_optimizer()
    dev = _mesh_device(mesh)

    def init(seed: int = 0):
        model = init_fn(torch.Generator().manual_seed(seed)).to(dev)
        if spec_for(("layers",), rules) and hasattr(model, "stack_layers"):
            model.stack_layers()  # so the "layers" rule can shard them
        names = [n for n, _ in model.named_parameters()]
        axes = (model.logical_axes() if hasattr(model, "logical_axes")
                else {n: () for n in names})
        place(mesh, model, axes, rules)
        return model, _init_state(model, optimizer, master_fp32), 0

    def step(model: nn.Module, opt_state: Any, step: int, batch: Dict):
        with tracing.device_span("train.step", dev) as root:
            params = list(model.parameters())
            batch = _place_batch(batch, mesh, rules, dev)
            with tracing.device_span("train.forward", dev), \
                    use_mesh(mesh):
                loss = loss_fn(model, batch)
            with tracing.device_span("train.backward", dev):
                with use_mesh(mesh):
                    loss.backward()
                # Each gradient in its parameter's layout (a replicated
                # parameter's gradient may arrive as partial sums).
                grads = [p.grad.redistribute(p.device_mesh, p.placements)
                         for p in params]
            for p in params:
                p.grad = None
            with tracing.device_span("train.optimizer", dev):
                gnorm = global_norm(grads)
                opt_state = _apply_updates(optimizer, opt_state, params,
                                           grads, master_fp32)
            if root is not None:
                _annotate(root, step, batch, dev)
        return model, opt_state, step + 1, {"loss": _whole(loss.detach()),
                                             "grad_norm": _whole(gnorm)}

    return init, step, rules


def _place_batch(batch: Dict, mesh, rules: Rules, dev) -> Dict:
    """Each batch tensor as a DTensor: tensors of 2 or more dims sharded
    on their first dim by the "batch" rule, the rest replicated."""
    spec = spec_for(("batch",), rules)
    return {k: distribute(v.to(dev), mesh, spec if v.ndim >= 2 else ())
            for k, v in batch.items()}


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def make_eval_step(loss_fn: Callable[[nn.Module, Dict], torch.Tensor], mesh,
                   rules: Optional[Rules] = None) -> Callable:
    """``(model, batch) -> loss`` without gradients, the batch whole on
    every rank and placed as ``build_sharded_train`` places it."""
    rules = prune_rules_for_mesh(mesh, rules)
    dev = _mesh_device(mesh)

    def eval_step(model: nn.Module, batch: Dict) -> torch.Tensor:
        batch = _place_batch(batch, mesh, rules, dev)
        with use_mesh(mesh), torch.no_grad():
            return _whole(loss_fn(model, batch))

    return eval_step
