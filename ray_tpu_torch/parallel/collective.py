"""Collectives over ``torch.distributed``: counterpart of the JAX package's
``parallel/collective.py``.

A group is a mesh dim: ``CollectiveGroup(name, mesh, axis)`` runs over
``mesh.get_group(axis)``, and ranks are positions along that axis.

Two styles, as in the JAX package:

- the eager API (``allreduce``, ``allgather``, ``reducescatter``,
  ``broadcast``, ``barrier``, ``send_recv``, ``reduce``, ``gather``).
  The JAX package runs one program over every rank and takes a
  ``[world, ...]`` array whose row r is rank r's share. Here each process
  calls the op with its own share and gets its own part of the result:
  row r of the JAX input is what rank r passes, and what the JAX op
  returns for the group (the whole value, or row r of it) is what rank r
  gets back;
- ``ops``: the in-graph forms, differentiable, for bodies that run on
  local shards (``sharding.smap``). A collective's backward is the
  collective that transposes it: psum's is a psum, all_gather's a
  psum_scatter, all_to_all's the inverse all_to_all, ppermute's the
  permutation the other way round. Axis names resolve on the current mesh
  (``sharding.current_mesh``).

Transport: NCCL moves CUDA tensors on the card. gloo moves host memory,
so under a gloo group (several ranks sharing one card, where NCCL refuses
to run) a CUDA tensor is copied to the host for the exchange and back
after it. The choice is made by the group's backend name; every product,
softmax and kernel stays on the card.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .mesh import MeshSpec
from .sharding import current_mesh, mesh_sizes

_REDUCE_OPS = ("sum", "max", "min", "mean")
_DIST_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
             "min": dist.ReduceOp.MIN, "mean": dist.ReduceOp.SUM}


# -- transport ----------------------------------------------------------------

def _staged(group, t: torch.Tensor) -> bool:
    """Whether ``t`` crosses through host memory: a CUDA tensor in a gloo
    group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(group, t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if _staged(group, t) else t


def _all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``t`` reduced over the group."""
    buf = _host(group, t).clone()
    dist.all_reduce(buf, op=_DIST_OPS[op], group=group)
    if op == "mean":
        buf /= dist.get_world_size(group)
    return buf.to(t.device)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``[n, *t.shape]``: every rank's ``t`` in rank order."""
    src = _host(group, t).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def _all_to_all(chunks: torch.Tensor, group) -> torch.Tensor:
    """``chunks`` ``[n, ...]``: row j goes to rank j; returns ``[n, ...]``
    whose row i came from rank i."""
    src = _host(group, chunks).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(chunks.device)


def _ppermute(t: torch.Tensor, group, perm: Sequence[Tuple[int, int]]
              ) -> torch.Tensor:
    """Each ``(src, dst)`` pair sends src's ``t`` to dst (group ranks).
    A rank that no pair sends to gets zeros, as ``jax.lax.ppermute``."""
    me = dist.get_rank(group)
    src = _host(group, t).contiguous()
    out, ops = None, []
    for s, d in perm:
        if s == me and d == me:
            out = src.clone()
        elif s == me:
            ops.append(dist.P2POp(dist.isend, src,
                                  dist.get_global_rank(group, d), group))
        elif d == me:
            out = torch.empty_like(src)
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, s), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if out is None:
        out = torch.zeros_like(src)
    return out.to(t.device)


# -- groups -------------------------------------------------------------------

@dataclass
class CollectiveGroup:
    """A named group = a mesh + the axis collectives run over."""

    name: str
    mesh: object
    axis: str = "dp"

    @property
    def world_size(self) -> int:
        return mesh_sizes(self.mesh)[self.axis]

    @property
    def group(self):
        return self.mesh.get_group(self.axis)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)


_groups: Dict[str, CollectiveGroup] = {}
_lock = threading.Lock()
_DEFAULT = "default"


def init_collective_group(mesh=None, axis: str = "dp",
                          group_name: str = _DEFAULT) -> CollectiveGroup:
    """Register a collective group over a mesh axis (``mesh`` None: every
    rank of the process group on dp, a mesh on the card)."""
    if mesh is None:
        mesh = MeshSpec(dp=dist.get_world_size()).build()
    group = CollectiveGroup(group_name, mesh, axis)
    with _lock:
        _groups[group_name] = group
    return group


def destroy_collective_group(group_name: str = _DEFAULT) -> None:
    with _lock:
        _groups.pop(group_name, None)


def get_group(group_name: str = _DEFAULT) -> CollectiveGroup:
    with _lock:
        group = _groups.get(group_name)
    if group is None:
        group = init_collective_group(group_name=group_name)
    return group


# -- eager API: each rank passes its share ------------------------------------

def _check_op(op: str) -> None:
    if op not in _REDUCE_OPS:
        raise ValueError(f"op must be one of {_REDUCE_OPS}")


def allreduce(tensor, op: str = "sum", group_name: str = _DEFAULT):
    """The group's shares reduced, on every rank."""
    _check_op(op)
    return _all_reduce(tensor, get_group(group_name).group, op)


def allgather(tensor, group_name: str = _DEFAULT):
    """``[world, ...]``: every rank's share, on every rank."""
    return _all_gather(tensor, get_group(group_name).group)


def reducescatter(tensor, op: str = "sum", group_name: str = _DEFAULT):
    """The shares reduced, then split along dim 0: this rank's chunk
    (dim 0 must divide by the group size)."""
    _check_op(op)
    g = get_group(group_name)
    reduced = _all_reduce(tensor, g.group, op)
    return reduced.chunk(g.world_size, 0)[g.rank].clone()


def broadcast(tensor, src_rank: int = 0, group_name: str = _DEFAULT):
    """Rank ``src_rank``'s share, on every rank."""
    g = get_group(group_name)
    buf = _host(g.group, tensor).clone()
    dist.broadcast(buf, dist.get_global_rank(g.group, src_rank),
                   group=g.group)
    return buf.to(tensor.device)


def barrier(group_name: str = _DEFAULT) -> None:
    """Block until every rank of the group arrives."""
    g = get_group(group_name)
    _all_reduce(torch.zeros(1), g.group)


def send_recv(tensor, src_rank: int, dst_rank: int,
              group_name: str = _DEFAULT):
    """Rank ``dst_rank`` gets rank ``src_rank``'s share; every other rank
    keeps its own."""
    g = get_group(group_name)
    moved = _ppermute(tensor, g.group, [(src_rank, dst_rank)])
    return moved if g.rank == dst_rank else tensor


def reduce(tensor, dst_rank: int = 0, op: str = "sum",
           group_name: str = _DEFAULT):
    """The shares reduced on rank ``dst_rank``; zeros on the others (the
    JAX package's non-root slots)."""
    _check_op(op)
    g = get_group(group_name)
    red = _all_reduce(tensor, g.group, op)
    return red if g.rank == dst_rank else torch.zeros_like(red)


def gather(tensor, dst_rank: int = 0, group_name: str = _DEFAULT):
    """``[world, ...]`` on rank ``dst_rank``; None on the others."""
    g = get_group(group_name)
    full = _all_gather(tensor, g.group)
    return full if g.rank == dst_rank else None


# -- in-graph collectives -----------------------------------------------------

AxisName = Union[str, Sequence[str]]


def _names(axis_name: AxisName) -> Tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def _axis_group(axis_name: str):
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError(f"axis {axis_name!r}: no current mesh "
                           "(sharding.use_mesh / under_mesh)")
    return mesh.get_group(axis_name)


def axis_size(axis_name: AxisName) -> int:
    """Size of a mesh axis (the product, for several) on the current mesh."""
    sizes = mesh_sizes(current_mesh())
    n = 1
    for a in _names(axis_name):
        n *= sizes[a]
    return n


def axis_index(axis_name: str) -> int:
    """This rank's position along a mesh axis."""
    return dist.get_rank(_axis_group(axis_name))


def _groups_of(axis_name: AxisName) -> tuple:
    return tuple(_axis_group(a) for a in _names(axis_name))


def _reduce(x, groups, op: str):
    for group in groups:
        x = _all_reduce(x, group, op)
    return x


# The autograd functions take process groups, resolved when the op is
# called: a backward runs after the mesh context has been left.

class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _reduce(x, groups, "sum")

    @staticmethod
    def backward(ctx, g):
        return _PSum.apply(g, ctx.groups), None


def _split(x, n: int, dim: int, tiled: bool) -> torch.Tensor:
    """``[n, ...]``: x cut into n chunks along ``dim`` (tiled), or x's
    ``dim`` (of size n) moved to the front."""
    if tiled:
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                             f"by {n}")
        return torch.stack(x.chunk(n, dim))
    if x.shape[dim] != n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is not {n}")
    return x.movedim(dim, 0)


def _join(parts: torch.Tensor, dim: int, tiled: bool) -> torch.Tensor:
    """Inverse of ``_split``: ``[n, ...]`` concatenated along ``dim``
    (tiled) or stacked there."""
    if tiled:
        return torch.cat(parts.unbind(0), dim)
    return parts.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis, tiled):
        ctx.args = group, axis, tiled
        return _join(_all_gather(x, group), axis, tiled)

    @staticmethod
    def backward(ctx, g):
        return _PSumScatter.apply(g, *ctx.args), None, None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, tiled):
        ctx.args = group, dim, tiled
        parts = _split(x, dist.get_world_size(group), dim, tiled)
        return _all_reduce(parts, group)[dist.get_rank(group)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis, tiled):
        ctx.args = group, split_axis, concat_axis, tiled
        parts = _split(x, dist.get_world_size(group), split_axis, tiled)
        return _join(_all_to_all(parts, group), concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis, tiled = ctx.args
        return (_AllToAll.apply(g, group, concat_axis, split_axis, tiled),
                None, None, None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.args = group, perm
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        group, perm = ctx.args
        return (_PPermute.apply(g, group, tuple((d, s) for s, d in perm)),
                None, None)


def psum(x, axis_name: AxisName):
    """Sum over the ranks of one or more mesh axes (backward: psum)."""
    return _PSum.apply(x, _groups_of(axis_name))


def pmean(x, axis_name: AxisName):
    return psum(x, axis_name) / axis_size(axis_name)


def pmax(x, axis_name: AxisName):
    """Max over the axes (not differentiable)."""
    return _reduce(x.detach(), _groups_of(axis_name), "max")


def pmin(x, axis_name: AxisName):
    """Min over the axes (not differentiable)."""
    return _reduce(x.detach(), _groups_of(axis_name), "min")


def all_gather(x, axis_name: str, axis: int = 0, tiled: bool = False):
    """Every rank's x, stacked at ``axis`` (or concatenated, ``tiled``)."""
    return _AllGather.apply(x, _axis_group(axis_name), axis, tiled)


def psum_scatter(x, axis_name: str, scatter_dimension: int = 0,
                 tiled: bool = False):
    """Sum over the axis, then this rank's slice of ``scatter_dimension``
    (a chunk of it, ``tiled``)."""
    return _PSumScatter.apply(x, _axis_group(axis_name), scatter_dimension,
                              tiled)


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int,
               tiled: bool = False):
    """Chunk j of ``split_axis`` goes to rank j; the chunks received are
    concatenated (``tiled``) or stacked along ``concat_axis`` in rank
    order."""
    return _AllToAll.apply(x, _axis_group(axis_name), split_axis,
                           concat_axis, tiled)


def ppermute(x, axis_name: str, perm: Sequence[Tuple[int, int]]):
    """Send x along each ``(src, dst)`` pair of axis positions; a rank no
    pair sends to gets zeros."""
    return _PPermute.apply(x, _axis_group(axis_name),
                           tuple(map(tuple, perm)))


class ops:
    """In-graph collective ops (differentiable; see the module docstring)."""

    psum = staticmethod(psum)
    pmean = staticmethod(pmean)
    pmax = staticmethod(pmax)
    pmin = staticmethod(pmin)
    all_gather = staticmethod(all_gather)
    all_to_all = staticmethod(all_to_all)
    ppermute = staticmethod(ppermute)
    psum_scatter = staticmethod(psum_scatter)
    axis_index = staticmethod(axis_index)

    @staticmethod
    def ring_permute(x, axis_name: str, shift: int = 1):
        """Rotate shards around the ring defined by a mesh axis."""
        n = axis_size(axis_name)
        return ppermute(x, axis_name, [(i, (i + shift) % n)
                                       for i in range(n)])
