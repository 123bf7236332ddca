"""Pipeline parallelism: GPipe microbatch pipelining over a mesh axis.
Counterpart of the JAX package's ``parallel/pipeline.py``.

Stages live on the ranks of the ``pp`` axis; microbatch activations
advance stage to stage with ``collective.ppermute``. Schedule: plain GPipe
(fill + steady + drain = M + N - 1 ticks for M microbatches on N stages),
bubble fraction (N-1)/(M+N-1).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .collective import axis_index, axis_size, ppermute, psum
from .sharding import P, smap


def pipeline_apply_local(stage_fn: Callable, stage_params: Any, microbatches,
                         axis_name: str = "pp"):
    """Run the pipeline on this rank's stage (inside ``smap``).

    Args:
      stage_fn: ``(params, x) -> y``, one stage's computation.
      stage_params: this rank's stage parameters.
      microbatches: [M, micro_batch, ...], the same on every rank (stage 0
        reads them).

    Returns [M, micro_batch, ...] outputs of the last stage, on every rank
    (a psum of the last rank's outputs). Each tick, stage 0 injects
    microbatch t, the last stage commits microbatch t - (N - 1), and every
    activation moves one stage to the right.

    As in the JAX body, every rank runs every tick and selects with
    ``where`` and a mask rather than by branching on its rank: each rank
    then records the same collectives in the same order, and each of their
    backwards runs on every rank, as a collective's backward must.
    """
    n = axis_size(axis_name)
    rank = axis_index(axis_name)
    m = microbatches.shape[0]
    fwd = [(i, (i + 1) % n) for i in range(n)]
    first = torch.tensor(rank == 0, device=microbatches.device)
    incoming = torch.zeros_like(microbatches[0])
    outputs = []
    for t in range(m + n - 1):
        injected = torch.where(first, microbatches[min(t, m - 1)], incoming)
        y = stage_fn(stage_params, injected)
        if t >= n - 1:
            outputs.append(y)
        incoming = ppermute(y, axis_name, fwd)
    mask = float(rank == n - 1)
    return psum(torch.stack(outputs).to(microbatches.dtype) * mask,
                axis_name)


def pipeline_apply(stage_fn: Callable, stacked_params: Any, microbatches,
                   mesh, axis_name: str = "pp", data_spec=None):
    """Sharded entry: ``stacked_params`` (one tensor or a dict of tensors,
    leading dim = stage) sharded over ``axis_name``; runs the pipeline and
    returns the outputs replicated over pp (a DTensor of ``data_spec``)."""
    if data_spec is None:
        data_spec = P()

    def body(params, mb):
        if isinstance(params, dict):
            params = {k: p[0] for k, p in params.items()}
        else:
            params = params[0]
        return pipeline_apply_local(stage_fn, params, mb, axis_name)

    fn = smap(body, mesh, in_specs=(P(axis_name), data_spec),
              out_specs=data_spec)
    return fn(stacked_params, microbatches)


def num_microbatches_for(batch: int, pp: int,
                         target_bubble: float = 0.2) -> int:
    """Pick M so the GPipe bubble (N-1)/(M+N-1) is below target."""
    if pp <= 1:
        return 1
    m = max(1, int((pp - 1) * (1 - target_bubble) / target_bubble))
    while batch % m != 0 and m > 1:
        m -= 1
    return m
