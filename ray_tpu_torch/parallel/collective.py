"""Collectives over ``torch.distributed``: counterpart of the JAX package's
``parallel/collective.py``.

A group is a mesh dim: ``CollectiveGroup(name, mesh, axis)`` runs over
``mesh.get_group(axis)``, and ranks are positions along that axis.

Three styles, as in the JAX package:

- the eager API (``allreduce``, ``allgather``, ``reducescatter``,
  ``broadcast``, ``barrier``, ``send_recv``, ``reduce``, ``gather``).
  The JAX package runs one program over every rank and takes a
  ``[world, ...]`` array whose row r is rank r's share. Here each process
  calls the op with its own share and gets its own part of the result:
  row r of the JAX input is what rank r passes, and what the JAX op
  returns for the group (the whole value, or row r of it) is what rank r
  gets back;
- ``HostGroup``: send/recv, rooted reduce and gather and a barrier
  between actors of an injected runtime, over its object plane;
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


# -- host-plane groups between actors -----------------------------------------
# Point-to-point and rooted collectives BETWEEN ACTORS, rendezvoused
# through a named mailbox actor over the object plane: the JAX package's
# ``HostGroup`` and ``_P2PMailbox`` (``parallel/collective.py:290-475``), on
# the runtime the caller passes (``runtime=``: ``remote``, ``get`` and
# ``get_actor``; ``ray_tpu.core`` has them). Tensors cross as the object
# plane's tensor payloads (``core.serialization``). Matching is
# deterministic via per-edge sequence numbers.

_HOST_REDUCERS = {"sum": lambda x: x.sum(0), "max": lambda x: x.amax(0),
                  "min": lambda x: x.amin(0), "mean": lambda x: x.mean(0)}


class _P2PMailbox:
    """Named rendezvous actor: keyed one-shot slots + epoch barriers."""

    def __init__(self):
        from ..core.serialization import install

        install()  # the slots hand tensors back
        self._slots = {}
        self._barriers = {}

    async def put(self, key, value):
        self._slots[key] = value

    async def take(self, key, timeout: float = 60.0):
        import asyncio
        import time as _t

        deadline = _t.monotonic() + timeout
        while key not in self._slots:
            if _t.monotonic() > deadline:
                raise TimeoutError(f"recv timed out waiting for {key}")
            await asyncio.sleep(0.002)
        return self._slots.pop(key)

    async def arrive(self, group: str, epoch: int, world: int,
                     timeout: float = 60.0):
        import asyncio
        import time as _t

        now = _t.monotonic()
        # lazy sweep of RELEASED entries only (count reached world):
        # an incomplete entry may still have live waiters with long
        # timeouts — deleting it would reset the count under them.
        # Incomplete stale entries are cleared by destroy(). world is
        # not stored per-entry, so released-ness rides a sentinel count.
        for k in [k for k, (c, ts) in self._barriers.items()
                  if c < 0 and now - ts > 600.0]:
            del self._barriers[k]
        k = (group, epoch)
        count, _ = self._barriers.get(k, (0, now))
        if count >= 0:  # negative = already released (late arrival ok)
            count += 1
            self._barriers[k] = (count, now)
        deadline = now + timeout
        while True:
            c, _ = self._barriers.get(k, (0, 0))
            if c < 0 or c >= world:
                break
            if _t.monotonic() > deadline:
                raise TimeoutError(f"barrier {k} timed out")
            await asyncio.sleep(0.002)
        # mark released so the sweep may reclaim it later
        self._barriers[k] = (-1, _t.monotonic())
        return True

    async def reset_group(self, group: str):
        self._slots = {k: v for k, v in self._slots.items()
                       if not (isinstance(k, tuple) and k
                               and k[0] == group)}
        self._barriers = {k: v for k, v in self._barriers.items()
                          if k[0] != group}


class HostGroup:
    """Cross-actor collective group over the object plane.

    Every participant (driver or actor) builds one with the same ``name``
    and distinct ``rank``; ``send`` on one rank pairs with ``recv`` on
    another, ``reduce``/``gather`` deliver to a root rank only. Values are
    tensors (``torch.as_tensor`` of what is sent).
    """

    # The JAX package's mailbox is "rt::p2p-mailbox": the two never share.
    _MAILBOX = "rt::p2p-mailbox-torch"

    def __init__(self, world_size: int, rank: int,
                 name: str = "default-host", runtime=None):
        if runtime is None:
            raise ValueError("HostGroup needs runtime=: an actor runtime "
                             "with remote, get and get_actor, such as "
                             "ray_tpu.core")
        from ..core.serialization import install

        install()  # this process sends tensors
        self.runtime = runtime
        self.world_size = world_size
        self.rank = rank
        self.name = name
        self._send_seq: Dict[Tuple[int, str], int] = {}
        self._recv_seq: Dict[Tuple[int, str], int] = {}
        self._epoch = 0
        self._box = self._get_or_create_mailbox()

    def _get_or_create_mailbox(self):
        """Rendezvous on ONE named mailbox across racing participants.
        A losing creator's failure surfaces asynchronously, so creation is
        confirmed with a ping before the handle is trusted; on any failure
        we fall back to looking the winner up."""
        import time as _t

        rt = self.runtime
        last = None
        for _ in range(100):
            try:
                return rt.get_actor(self._MAILBOX)
            except Exception as e:  # noqa: BLE001 — not registered yet
                last = e
            try:
                h = rt.remote(_P2PMailbox).options(
                    name=self._MAILBOX, lifetime="detached",
                    max_concurrency=64).remote()
                rt.get(h.arrive.remote("__ping__", 0, 1, 5), timeout=30)
                return h
            except Exception as e:  # noqa: BLE001 — lost the race
                last = e
                _t.sleep(0.05)
        raise RuntimeError(f"mailbox rendezvous failed: {last!r}")

    def _key(self, src: int, dst: int, tag: str, seq: int):
        return (self.name, src, dst, tag, seq)

    def send(self, tensor, dst_rank: int, tag: str = "") -> None:
        edge = (dst_rank, tag)
        seq = self._send_seq.get(edge, 0)
        self.runtime.get(self._box.put.remote(
            self._key(self.rank, dst_rank, tag, seq),
            torch.as_tensor(tensor)), timeout=60)
        # advance only on success: a timed-out op must not desync the
        # edge's sequence numbering (a retry re-targets the same seq)
        self._send_seq[edge] = seq + 1

    def recv(self, src_rank: int, tag: str = "", timeout: float = 60.0):
        edge = (src_rank, tag)
        seq = self._recv_seq.get(edge, 0)
        value = self.runtime.get(self._box.take.remote(
            self._key(src_rank, self.rank, tag, seq), timeout),
            timeout=timeout + 10)
        self._recv_seq[edge] = seq + 1  # advance only on success
        return value

    def reduce(self, tensor, dst_rank: int = 0, op: str = "sum"):
        """Rooted reduce: the reduced tensor on the root, None on the
        other ranks (reference: collective.py:380)."""
        _check_op(op)
        if self.rank != dst_rank:
            self.send(tensor, dst_rank, tag="__reduce__")
            return None
        parts = [torch.as_tensor(tensor)]
        for r in range(self.world_size):
            if r != self.rank:
                parts.append(self.recv(r, tag="__reduce__"))
        return _HOST_REDUCERS[op](torch.stack(parts))

    def gather(self, tensor, dst_rank: int = 0):
        """Rooted gather: the root gets [world, ...] in rank order, the
        other ranks None (reference: collective.py:428)."""
        if self.rank != dst_rank:
            self.send(tensor, dst_rank, tag="__gather__")
            return None
        out = [None] * self.world_size
        out[self.rank] = torch.as_tensor(tensor)
        for r in range(self.world_size):
            if r != self.rank:
                out[r] = self.recv(r, tag="__gather__")
        return torch.stack(out)

    def destroy(self) -> None:
        """Clear this group's mailbox state. Call from ONE rank after the
        cohort finishes; REQUIRED before reusing a group name — a new
        cohort under a stale name would see the old cohort's barrier
        counts and release its barriers early."""
        self.runtime.get(self._box.reset_group.remote(self.name), timeout=30)

    def barrier(self, timeout: float = 60.0) -> None:
        epoch = self._epoch
        self.runtime.get(self._box.arrive.remote(
            self.name, epoch, self.world_size, timeout),
            timeout=timeout + 10)
        self._epoch += 1  # advance only on success


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
