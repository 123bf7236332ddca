"""Device meshes and mesh claims: counterpart of the JAX package's
``parallel/mesh.py``.

The dataclasses and their arithmetic are the JAX package's. ``build()``
returns a ``torch.distributed.device_mesh.DeviceMesh`` over the process
group this process has joined (``bootstrap.Bootstrap.initialize_torch``
or ``torch.distributed.init_process_group``): one rank a device, the
ranks laid out row-major over ``AXIS_ORDER``, so the innermost axes (tp,
ep) join adjacent ranks, as the JAX mesh puts them on adjacent chips.

Axis convention (outer -> inner):
  ``dp``   data parallel (gradient all-reduce)
  ``fsdp`` fully-sharded data parallel (parameter and optimizer sharding)
  ``pp``   pipeline stages (point-to-point exchange)
  ``sp``   sequence/context parallel (ring attention / Ulysses)
  ``tp``   tensor parallel
  ``ep``   expert parallel (MoE all_to_all)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

AXIS_ORDER = ("dp", "fsdp", "pp", "sp", "tp", "ep")


@dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism layout, independent of physical devices."""

    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    @property
    def num_devices(self) -> int:
        n = 1
        for a in AXIS_ORDER:
            n *= getattr(self, a)
        return n

    def active_axes(self) -> List[str]:
        return [a for a in AXIS_ORDER if getattr(self, a) > 1]

    @classmethod
    def for_devices(cls, n: int, tp: int = 1, sp: int = 1, pp: int = 1,
                    fsdp: Optional[int] = None, ep: int = 1) -> "MeshSpec":
        """Fill the dp (or fsdp) axis with whatever devices remain."""
        inner = tp * sp * pp * ep if ep > 1 else tp * sp * pp
        if n % inner != 0:
            raise ValueError(f"{n} devices not divisible by tp*sp*pp={inner}")
        rest = n // inner
        if fsdp is None:
            return cls(dp=rest, tp=tp, sp=sp, pp=pp, ep=ep)
        if rest % fsdp != 0:
            raise ValueError(f"remaining {rest} not divisible by fsdp={fsdp}")
        return cls(dp=rest // fsdp, fsdp=fsdp, tp=tp, sp=sp, pp=pp, ep=ep)

    def build(self, device_type: Optional[str] = None):
        """A ``DeviceMesh`` over the initialised process group, with
        ``mesh_dim_names=AXIS_ORDER``. Raises unless the group has exactly
        ``num_devices`` ranks. The mesh is on the card (raising without
        one) unless ``device_type="cpu"`` asks for the CPU; the group's
        backend does not choose it (under gloo a CUDA tensor only crosses
        host memory in transit, ``collective``)."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        from ..device import default_device

        if not dist.is_initialized():
            raise RuntimeError("MeshSpec.build needs an initialised process "
                               "group (Bootstrap.initialize_torch)")
        world = dist.get_world_size()
        if world != self.num_devices:
            raise ValueError(f"MeshSpec {self.describe()} needs "
                             f"{self.num_devices} ranks; the group has "
                             f"{world}")
        return init_device_mesh(
            default_device(device_type).type,
            tuple(getattr(self, a) for a in AXIS_ORDER),
            mesh_dim_names=AXIS_ORDER)

    def describe(self) -> str:
        parts = [f"{a}={getattr(self, a)}" for a in self.active_axes()]
        return "x".join(parts) if parts else "single-device"


@dataclass
class MeshClaim:
    """A reservation of device topology, schedulable like a placement-group
    bundle (the JAX package's ``MeshClaim``)."""

    spec: MeshSpec
    slice_type: Optional[str] = None  # e.g. "v5e-8"; None = any
    multislice: bool = False  # allow spanning DCN-linked slices (dp axis only)
    name: str = ""

    def chips(self) -> int:
        return self.spec.num_devices

    def to_bundles(self, chips_per_host: int) -> List[Dict[str, float]]:
        """Lower to placement-group bundles of TPU chips per host."""
        total = self.chips()
        n_hosts = max(1, math.ceil(total / chips_per_host))
        per_host = min(total, chips_per_host)
        return [{"TPU": float(per_host)} for _ in range(n_hosts)]


def local_mesh(tp: int = 1, sp: int = 1, device_type: Optional[str] = None,
               **kwargs):
    """Mesh over every rank of the initialised process group."""
    import torch.distributed as dist

    spec = MeshSpec.for_devices(dist.get_world_size(), tp=tp, sp=sp,
                                **kwargs)
    return spec.build(device_type)


def single_device_mesh(device_type: Optional[str] = None):
    return MeshSpec().build(device_type)
