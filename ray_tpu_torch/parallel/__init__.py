"""Parallelism layer on ``torch.distributed``: meshes, sharding rules,
collectives, and the sequence/pipeline/expert-parallel bodies.
Counterpart of the JAX package's ``parallel/``.

Meshes are ``DeviceMesh``es over the process group, placements are
DTensors, and the per-rank bodies (ring, Ulysses, MoE, pipeline) run on
local shards inside ``sharding.smap`` with the differentiable collectives
of ``collective.ops``.
"""

from .collective import (
    CollectiveGroup,
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    get_group,
    init_collective_group,
    ops,
    reducescatter,
)
from .mesh import (AXIS_ORDER, MeshClaim, MeshSpec, local_mesh,
                   single_device_mesh)
from .moe import moe_ffn_local
from .pipeline import (num_microbatches_for, pipeline_apply,
                       pipeline_apply_local)
from .ring import ring_attention, ring_attention_local
from .sharding import (
    DEFAULT_RULES,
    P,
    constrain,
    place,
    prune_rules_for_mesh,
    shardings_for,
    smap,
    spec_for,
    tree_spec,
)
from .ulysses import ulysses_attention, ulysses_attention_local

__all__ = [
    "AXIS_ORDER", "CollectiveGroup", "DEFAULT_RULES", "MeshClaim", "MeshSpec",
    "P", "allgather", "allreduce", "barrier", "broadcast", "constrain",
    "destroy_collective_group", "get_group", "init_collective_group",
    "local_mesh", "moe_ffn_local", "num_microbatches_for", "ops",
    "pipeline_apply", "pipeline_apply_local", "place", "prune_rules_for_mesh",
    "reducescatter", "ring_attention", "ring_attention_local",
    "shardings_for", "single_device_mesh", "smap", "spec_for", "tree_spec",
    "ulysses_attention", "ulysses_attention_local",
]
