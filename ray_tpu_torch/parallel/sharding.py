"""Logical-axis sharding rules on DTensors: counterpart of the JAX
package's ``parallel/sharding.py``.

Parameters and activations carry logical axis names ("embed", "mlp",
"heads", "batch", "seq"), and a rule table maps each to mesh axes. A spec
is a tuple with one entry per tensor dim (a mesh axis, a tuple of mesh
axes, or None), the same tuple JAX's ``PartitionSpec`` holds, so the two
compare equal. On a ``DeviceMesh`` a spec becomes DTensor placements:
``Shard(i)`` on each mesh dim that tensor dim i is split over, else
``Replicate()``.

``place`` distributes a module's parameters as DTensors; ``constrain``
redistributes a DTensor activation (identity without a mesh, without
rules, or on a plain tensor); ``smap`` runs a body on local shards, as
``shard_map`` does. Its gradient follows ``shard_map``'s: the cotangent of
an output is divided by the size of the mesh axes its spec does not
mention, and the gradient of an input is summed over the axes its spec
does not mention (so a psum inside the body, whose backward is a psum,
gives each replicated input its whole gradient once).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicate)
Rules = Dict[str, Union[str, Tuple[str, ...], None]]

# Default rule table for transformer LMs. fsdp shards the embed dim of
# params (ZeRO-3 style); tp shards heads/mlp; sp shards activation seq.
DEFAULT_RULES: Rules = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",
    "heads": "tp",
    "kv": None,
    "mlp": "tp",
    "vocab": "tp",
    "layers": None,
    "stage": "pp",
    "expert": "ep",
    "qkv": "tp",
}


class P(tuple):
    """A partition spec: ``P("dp", None)`` is the tuple ``("dp", None)``;
    equal to JAX's ``PartitionSpec`` of the same entries."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def spec_for(logical_axes: Sequence[Optional[str]],
             rules: Optional[Rules] = None) -> P:
    """Map a tuple of logical axis names to a spec (trailing Nones
    trimmed)."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    out = [None if ax is None else rules.get(ax) for ax in logical_axes]
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_spec(logical_tree: Any, rules: Optional[Rules] = None) -> Any:
    """Map a tree (dicts, lists) of logical-axis tuples to specs."""
    if _is_axes(logical_tree):
        return spec_for(logical_tree, rules)
    if isinstance(logical_tree, Mapping):
        return {k: tree_spec(v, rules) for k, v in logical_tree.items()}
    return type(logical_tree)(tree_spec(v, rules) for v in logical_tree)


def mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def spec_axes(spec: Sequence) -> Tuple[str, ...]:
    """The mesh axes a spec shards over, in order."""
    out = []
    for entry in spec:
        if entry is None:
            continue
        out.extend((entry,) if isinstance(entry, str) else entry)
    return tuple(out)


def dtensor_mesh(mesh):
    """The mesh DTensors live on: ``mesh``'s dims of size > 1 (its first
    dim when there are none). DTensor's sharding propagation enumerates
    placements over every mesh dim, and six dims of size one cost it
    seconds an op for nothing."""
    names = tuple(a for a, n in mesh_sizes(mesh).items() if n > 1)
    names = names or tuple(mesh.mesh_dim_names[:1])
    if names == tuple(mesh.mesh_dim_names):
        return mesh
    key = (id(mesh), names)
    if key not in _SUBMESHES:
        _SUBMESHES[key] = (mesh, mesh[names])  # keeps ``mesh`` alive
    return _SUBMESHES[key][1]


_SUBMESHES: Dict[tuple, tuple] = {}


def placements(mesh, spec: Sequence) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on every
    mesh dim that tensor dim i is split over. A dim split over several
    mesh axes takes them major to minor, which must be the mesh's order.
    Axes ``mesh`` lacks are of size one (``dtensor_mesh``) and ignored."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {axes} is not in the mesh's axis "
                             f"order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def shardings_for(mesh, logical_tree: Any,
                  rules: Optional[Rules] = None) -> Any:
    """Tree of DTensor placements for placing tensors on the mesh."""
    specs = tree_spec(logical_tree, rules)

    def walk(s):
        if isinstance(s, P):
            return placements(mesh, s)
        if isinstance(s, Mapping):
            return {k: walk(v) for k, v in s.items()}
        return type(s)(walk(v) for v in s)

    return walk(specs)


def prune_rules_for_mesh(mesh, rules: Optional[Rules] = None) -> Rules:
    """Drop rule entries referring to axes absent from (or trivial in) the
    mesh so the same model code runs on any mesh shape."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    sizes = mesh_sizes(mesh)

    def keep(mesh_axis):
        return mesh_axis is not None and sizes.get(mesh_axis, 1) > 1

    out: Rules = {}
    for logical, mesh_axis in rules.items():
        if mesh_axis is None:
            out[logical] = None
        elif isinstance(mesh_axis, tuple):
            kept = tuple(a for a in mesh_axis if keep(a))
            out[logical] = kept if kept else None
        else:
            out[logical] = mesh_axis if keep(mesh_axis) else None
    return out


def distribute(x: torch.Tensor, mesh, spec: Sequence):
    """A tensor whose whole value every rank holds, as a DTensor of
    ``spec``: each rank keeps its own shard, with no communication."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = dtensor_mesh(mesh)
    rep = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, placements(mesh, spec))


def place(mesh, module: torch.nn.Module, logical_axes: Mapping[str, tuple],
          rules: Optional[Rules] = None) -> torch.nn.Module:
    """Replace each parameter of ``module`` (named as ``logical_axes``
    names it; every rank holds the same values) by a DTensor sharded by
    its logical axes under ``rules``. In place; returns the module."""
    names = {n for n, _ in module.named_parameters()}
    if names != set(logical_axes):
        raise ValueError(f"logical axes do not name the parameters: "
                         f"{sorted(names ^ set(logical_axes))}")
    for name in sorted(names):
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        p = getattr(owner, leaf)
        d = distribute(p.detach(), mesh, spec_for(logical_axes[name], rules))
        setattr(owner, leaf, torch.nn.Parameter(d, p.requires_grad))
    return module


# -- the current mesh ---------------------------------------------------------

_CURRENT_MESH: list = [None]


def set_current_mesh(mesh) -> None:
    _CURRENT_MESH[0] = mesh


def current_mesh():
    return _CURRENT_MESH[0]


@contextlib.contextmanager
def use_mesh(mesh):
    """``mesh`` as the current mesh for the duration."""
    prev = current_mesh()
    set_current_mesh(mesh)
    try:
        yield mesh
    finally:
        set_current_mesh(prev)


def under_mesh(mesh, fn):
    """Wrap ``fn`` so every call runs with ``mesh`` as the current mesh
    (so :func:`constrain`, the model's ``smap`` regions and the in-graph
    collectives resolve)."""

    def wrapped(*args, **kwargs):
        with use_mesh(mesh):
            return fn(*args, **kwargs)

    return wrapped


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x, logical_axes: Sequence[Optional[str]],
              rules: Optional[Rules] = None):
    """Redistribute a DTensor to the layout of ``logical_axes`` under
    ``rules``. The identity without a current mesh, without rules, on a
    plain tensor (inside an ``smap`` body) or for an empty spec."""
    mesh = current_mesh()
    if rules is None or mesh is None or not is_dtensor(x):
        return x
    spec = spec_for(logical_axes, rules)
    if not len(spec):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(mesh, spec))


# -- smap: a per-rank body on local shards ------------------------------------

def _unmentioned(mesh, spec) -> int:
    """Product of the sizes of the mesh axes ``spec`` does not shard over."""
    mentioned = set(spec_axes(spec))
    return math.prod(n for a, n in mesh_sizes(mesh).items()
                     if a not in mentioned)


class _ToLocal(torch.autograd.Function):
    """DTensors laid out as their specs -> local shards. Backward: each
    local gradient (zeros where the body did not use a shard) becomes a
    DTensor with the spec's Shard placements and ``Partial`` on the other
    mesh dims, i.e. summed over the axes the spec does not mention."""

    @staticmethod
    def forward(ctx, mesh, specs, *xs):
        ctx.mesh, ctx.specs = mesh, specs
        return tuple(x.to_local() for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        from torch.distributed.tensor import DTensor, Partial, Shard

        out = []
        for g, spec in zip(grads, ctx.specs):
            if g is None:  # an integer input (token ids)
                out.append(None)
                continue
            pl = [p if isinstance(p, Shard) else Partial()
                  for p in placements(ctx.mesh, spec)]
            out.append(DTensor.from_local(g.contiguous(), ctx.mesh, pl,
                                          run_check=False))
        return (None, None, *out)


class _ScaleGrad(torch.autograd.Function):
    """Identity whose backward multiplies the gradient by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _flatten(tree, spec, out_leaves, out_specs):
    """Leaves of ``tree`` (tensor, dict, list or tuple) with the spec of
    each (``spec``: one spec for every leaf, or a matching dict)."""
    if isinstance(tree, Mapping):
        return {k: _flatten(v, spec[k] if isinstance(spec, Mapping) else spec,
                            out_leaves, out_specs) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Tensor):
        return type(tree)(_flatten(v, spec, out_leaves, out_specs)
                          for v in tree)
    out_leaves.append(tree)
    out_specs.append(spec)
    return len(out_leaves) - 1


def _unflatten(skeleton, leaves):
    if isinstance(skeleton, Mapping):
        return {k: _unflatten(v, leaves) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_unflatten(v, leaves) for v in skeleton)
    return leaves[skeleton]


def smap(f, mesh, in_specs: Sequence, out_specs):
    """``shard_map`` on DTensors: ``f`` runs on this rank's shards.

    ``in_specs`` has one entry per positional argument: a spec for a
    tensor, or for every tensor of a dict/list argument, or a dict of
    specs for a dict argument. A DTensor argument is redistributed to its
    spec, a plain tensor is taken as the whole value (every rank holds
    it). ``out_specs`` is a spec for a tensor result, or a tuple of specs
    for a tuple result; each local result becomes a DTensor of that spec
    (``from_local``). Gradients follow ``shard_map``'s (module docstring).
    """
    from torch.distributed.tensor import DTensor

    full_mesh, mesh = mesh, dtensor_mesh(mesh)

    def wrapped(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"smap: {len(args)} arguments, "
                             f"{len(in_specs)} in_specs")
        leaves, specs = [], []
        skeleton = [_flatten(a, s, leaves, specs)
                    for a, s in zip(args, in_specs)]
        idx = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
        dts = []
        for i in idx:
            x = leaves[i]
            if isinstance(x, DTensor):
                dts.append(x.redistribute(mesh, placements(mesh, specs[i])))
            else:
                dts.append(distribute(x, full_mesh, specs[i]))
        local = _ToLocal.apply(mesh, tuple(specs[i] for i in idx), *dts)
        for i, t in zip(idx, local):
            leaves[i] = t
        with use_mesh(full_mesh):  # the body's axis names resolve on it
            out = f(*_unflatten(skeleton, leaves))
        single = not isinstance(out, (tuple, list))
        outs, ospecs = ((out,), (out_specs,)) if single else (out, out_specs)
        results = []
        for y, spec in zip(outs, ospecs):
            n = _unmentioned(mesh, spec)
            if n > 1 and y.requires_grad:
                y = _ScaleGrad.apply(y, 1.0 / n)
            results.append(DTensor.from_local(y, mesh, placements(mesh, spec),
                                              run_check=False))
        return results[0] if single else tuple(results)

    return wrapped
