"""Tensors on the object plane: counterpart of the JAX package's
``core/serialization.py`` (``DeviceArrayPayload`` :30, the ``jax.Array``
branch of ``_RTPickler.reducer_override`` :147-166 and
``_rebuild_device_array`` :285).

A ``torch.Tensor`` crosses as a ``TensorPayload``: its values as a host
numpy array, which a protocol-5 pickler sends out of band (so the object
store holds the bytes once and a reader gets a view of them), plus the
dtype's name and the device class. A CUDA tensor comes to the host with
one synchronous copy; a contiguous CPU tensor with none (``.numpy()`` is a
view). numpy has no bf16, and the port may not use ``ml_dtypes``: a bf16
tensor travels as its ``int16`` view, tagged ``bfloat16``.

Registration is scoped to one pickler class. ``install()`` puts
``reduce_tensor`` in the dispatch table of cloudpickle's ``Pickler``,
which the JAX package's runtime pickler subclasses; never in
``copyreg.dispatch_table``, which every pickler in the process reads:
there it would change what ``torch.save`` writes, and the weights-only
``torch.load`` refuses such a file.

Importing this module installs nothing. Every process that sends tensors
over a cloudpickle-based object plane calls ``install()`` first (the
port's actor bodies do so in their constructors). A process that only
receives needs nothing: the pickle stream names ``rebuild_tensor``, so
unpickling a payload imports this module.
"""

from __future__ import annotations

import collections.abc
import copyreg
import warnings
from dataclasses import dataclass
from typing import Any

import torch

from ..device import default_device

# Dtypes numpy lacks: they travel as the integer view of the same width.
BITS_VIEW = {torch.bfloat16: torch.int16}
BITS_VIEW.update({getattr(torch, n): torch.uint8
                  for n in ("float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
                            "float8_e5m2fnuz") if hasattr(torch, n)})


@dataclass
class TensorPayload:
    """Host-side form of a tensor crossing the object plane."""

    data: Any            # numpy array, sent out of band
    dtype: str           # torch dtype name, e.g. "bfloat16"
    device: str          # device class: "cpu" or "cuda"
    requires_grad: bool = False


def reduce_tensor(t: torch.Tensor):
    """Pickle reducer for ``torch.Tensor``: ``(rebuild_tensor,
    (TensorPayload,))``. Tensors that are not plain strided CPU or CUDA
    tensors (sparse, quantized, meta) keep torch's own reduce."""
    if (t.layout != torch.strided or t.is_quantized
            or t.device.type not in ("cpu", "cuda")):
        return t.__reduce_ex__(5)
    x = t.detach().resolve_conj().resolve_neg().contiguous()
    if x.device.type == "cuda":
        x = x.to("cpu")  # synchronous: the bytes are final when it returns
    x = x.view(BITS_VIEW[x.dtype]) if x.dtype in BITS_VIEW else x
    return rebuild_tensor, (TensorPayload(
        x.numpy(), str(t.dtype).removeprefix("torch."), t.device.type,
        t.requires_grad),)


def rebuild_tensor(payload: TensorPayload) -> torch.Tensor:
    """The tensor of ``payload``. A ``cuda`` payload goes to
    ``default_device(None)``, which raises in a process without a card; a
    ``cpu`` payload is a view of the received buffer: where the object
    store hands out a read-only view of sealed memory, the tensor aliases
    that memory, as a numpy ``get`` does, and must not be written."""
    dtype = getattr(torch, payload.dtype)
    with warnings.catch_warnings():
        # The buffer is read-only when it is the store's sealed memory.
        warnings.filterwarnings(
            "ignore", message="The given NumPy array is not writable")
        t = torch.from_numpy(payload.data)
    if dtype in BITS_VIEW:
        t = t.view(dtype)
    if payload.device == "cuda":
        t = t.to(default_device(None))
    if payload.requires_grad:
        t.requires_grad_(True)
    return t


def install(pickler_cls=None) -> bool:
    """Put ``reduce_tensor`` in ``pickler_cls``'s dispatch table, for
    ``torch.Tensor``; None means cloudpickle's ``Pickler`` (and so every
    subclass, the JAX package's runtime pickler among them), imported
    here because the card's machine may lack cloudpickle. Returns False,
    installing nothing, when it is None and cloudpickle is absent: the
    process then has no cloudpickle-based object plane. Idempotent."""
    if pickler_cls is None:
        try:
            import cloudpickle
        except ImportError:
            return False
        pickler_cls = cloudpickle.Pickler
    table = getattr(pickler_cls, "dispatch_table", None)
    if not isinstance(table, collections.abc.MutableMapping):
        raise TypeError(f"{pickler_cls.__name__} has no dispatch_table "
                        "mapping of its own")
    # A ChainMap (cloudpickle's) writes into its first map.
    if getattr(table, "maps", [table])[0] is copyreg.dispatch_table:
        raise ValueError("refusing copyreg.dispatch_table: it changes every "
                         "pickler in the process, torch.save included")
    table[torch.Tensor] = reduce_tensor
    return True
