"""Checkpoints: dict <-> directory <-> array storage. Counterpart of the
JAX package's ``train/checkpoint.py``, with its file names
(``checkpoint_data.pkl``, ``arrays/``, ``meta.json``).

Reference analog: ``python/ray/air/checkpoint.py:77-694``.

Arrays are stored in the layout of the JAX package's fallback,
``arrays/arrays.pkl``: a tree (dicts, lists, tuples) of host numpy
arrays, tensors widened where numpy has no dtype for them (bf16 to fp32,
exactly, as ``convert.tensor_to_numpy`` does). The JAX package's
``restore_arrays`` reads that file first, so it reads a port checkpoint;
the port reads the JAX package's fallback files that hold numpy dtypes
(fp32 included) and refuses, saying why, those that need ``ml_dtypes``
(bf16) or JAX (an orbax directory).

The port updates tensors in place, where JAX arrays never change, so
``snapshot`` (used by ``CheckpointManager.save_async`` and by
``session.report``) copies every tensor leaf to the host, synchronously,
before it returns.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.serialization import BITS_VIEW


class Checkpoint:
    """A training snapshot: metrics-adjacent user data + array trees."""

    _DICT_FILE = "checkpoint_data.pkl"
    _ARRAYS_DIR = "arrays"
    _META_FILE = "meta.json"

    def __init__(self, data: Optional[Dict] = None,
                 path: Optional[str] = None):
        self._data = data
        self._path = path

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path=path)

    # -- conversions ---------------------------------------------------------
    def to_dict(self) -> Dict:
        if self._data is not None:
            return dict(self._data)
        assert self._path is not None
        file = os.path.join(self._path, self._DICT_FILE)
        if os.path.exists(file):
            with open(file, "rb") as f:
                data = pickle.load(f)
        else:
            data = {}
        arrays_dir = os.path.join(self._path, self._ARRAYS_DIR)
        if os.path.isdir(arrays_dir):
            data["__arrays__"] = restore_arrays(arrays_dir)
        return data

    def to_directory(self, path: Optional[str] = None) -> str:
        if self._path is not None:
            if path is None or os.path.abspath(path) == os.path.abspath(
                    self._path):
                return self._path
            # Directory-backed checkpoint copied to an explicit target: the
            # source directory's contents ARE the checkpoint.
            shutil.copytree(self._path, path, dirs_exist_ok=True)
            return path
        path = path or tempfile.mkdtemp(prefix="rt_ckpt_")
        os.makedirs(path, exist_ok=True)
        data = dict(self._data or {})
        arrays = data.pop("__arrays__", None)
        with open(os.path.join(path, self._DICT_FILE), "wb") as f:
            pickle.dump(data, f)
        if arrays is not None:
            save_arrays(os.path.join(path, self._ARRAYS_DIR), arrays)
        with open(os.path.join(path, self._META_FILE), "w") as f:
            json.dump({"created": time.time()}, f)
        self._path = path
        return path

    def __repr__(self):
        src = "dict" if self._data is not None else self._path
        return f"Checkpoint({src})"


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf of a tree of dicts, lists and tuples
    (named tuples included), keeping the containers' types."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v) for v in tree]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return fn(tree)


def snapshot(tree: Any) -> Any:
    """``tree`` with every tensor leaf copied to the host (synchronously)
    and every numpy leaf copied: what the caller does to its tensors
    afterwards, in place or not, leaves the snapshot as it was."""
    def snap(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        if isinstance(x, np.ndarray):
            return x.copy()
        return x
    return tree_map(snap, tree)


def host_numpy(x):
    """A tensor as a host numpy array, widened where numpy has no dtype
    for it (bf16 to fp32, exactly); any other value as it is."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in BITS_VIEW:  # numpy has no such dtype: widen, exactly
            x = x.float()
        return x.cpu().numpy()
    return x


def save_arrays(path: str, tree: Any) -> None:
    """Write ``tree`` (tensor or numpy leaves) as ``path/arrays.pkl``, host
    numpy arrays with bf16 widened to fp32 (twice its bytes on disk)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "arrays.pkl"), "wb") as f:
        pickle.dump(tree_map(host_numpy, tree), f,
                    protocol=pickle.HIGHEST_PROTOCOL)


class _NumpyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "ml_dtypes":
            raise ValueError(
                f"the arrays hold an ml_dtypes {name} array (a bf16 tree "
                "saved by the JAX package): the port reads numpy dtypes "
                "only; save the tree cast to float32")
        return super().find_class(module, name)


def restore_arrays(path: str, template: Any = None) -> Any:
    """The tree ``save_arrays`` wrote, as numpy arrays. With ``template``
    (a tree of the same structure), each tensor leaf of the template gives
    its dtype and device to the restored leaf, so bf16 comes back bit for
    bit; the template's other leaves take the restored value as it is."""
    pkl = os.path.join(path, "arrays.pkl")
    if not os.path.exists(pkl):
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint arrays at {path}")
        raise ValueError(
            f"{path} holds no arrays.pkl: an orbax (tensorstore) checkpoint "
            "of the JAX package, which only JAX reads; the port reads the "
            "arrays.pkl layout")
    with open(pkl, "rb") as f:
        tree = _NumpyUnpickler(f).load()
    if template is None:
        return tree
    return as_template(template, tree)


def as_template(template: Any, tree: Any) -> Any:
    """``tree`` (numpy leaves, as ``restore_arrays`` or ``Checkpoint.
    to_dict`` return them) in ``template``'s structure, each leaf where the
    template has a tensor a tensor of that tensor's dtype and device; the
    template's other leaves take the tree's value as it is."""
    if isinstance(template, dict):
        return type(template)((k, as_template(v, tree[k]))
                              for k, v in template.items())
    if isinstance(template, (list, tuple)):
        items = [as_template(t, x)
                 for t, x in zip(template, tree, strict=True)]
        return (type(template)(*items) if hasattr(template, "_fields")
                else type(template)(items))
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.asarray(tree)).to(device=template.device,
                                                     dtype=template.dtype)
    return tree


class CheckpointManager:
    """Keep-N retention with optional score ordering.

    Reference analog: ``air/_internal/checkpoint_manager.py`` +
    ``CheckpointConfig`` semantics.
    """

    def __init__(self, directory: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None,
                 score_order: str = "max"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._entries = []  # (step, score, path)
        self._executor = None
        self._pending = []

    def save(self, checkpoint: Checkpoint, step: int,
             metrics: Optional[Dict] = None) -> str:
        path = os.path.join(self.directory, f"checkpoint_{step:08d}")
        checkpoint.to_directory(path)
        score = None
        if self.score_attribute and metrics:
            score = metrics.get(self.score_attribute)
        self._entries.append((step, score, path))
        self._enforce_retention()
        return path

    def save_async(self, checkpoint: Checkpoint, step: int,
                   metrics: Optional[Dict] = None):
        """Snapshot now, save later: every tensor leaf is copied to the host
        before this returns (``snapshot``), so the checkpoint is this step's
        even when the next step updates the tensors in place; pickling and
        disk IO run on a background thread. Returns a Future of the
        checkpoint path; ``wait_async()`` joins all pending saves."""
        from concurrent.futures import ThreadPoolExecutor

        host_ckpt = Checkpoint.from_dict(snapshot(checkpoint.to_dict()))
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="rt-ckpt-save")
        fut = self._executor.submit(self.save, host_ckpt, step, metrics)
        self._pending.append(fut)
        return fut

    def wait_async(self, timeout: Optional[float] = None) -> None:
        """Block until every async save has landed on disk."""
        from concurrent.futures import wait as _wait

        pending, self._pending = self._pending, []
        if pending:
            _wait(pending, timeout=timeout)

    def latest(self) -> Optional[Checkpoint]:
        if not self._entries:
            existing = sorted(
                d for d in os.listdir(self.directory)
                if d.startswith("checkpoint_")
            )
            if not existing:
                return None
            return Checkpoint.from_directory(
                os.path.join(self.directory, existing[-1])
            )
        return Checkpoint.from_directory(self._entries[-1][2])

    def best(self) -> Optional[Checkpoint]:
        scored = [e for e in self._entries if e[1] is not None]
        if not scored:
            return self.latest()
        rev = self.score_order == "max"
        best = sorted(scored, key=lambda e: e[1], reverse=rev)[0]
        return Checkpoint.from_directory(best[2])

    def _badness(self, entry) -> tuple:
        # Higher badness = deleted first. Unscored entries are worst; among
        # scored ones the worst is the lowest score for 'max' order and the
        # highest score for 'min' order.
        step, score, _ = entry
        if score is None:
            return (1, 0)
        return (0, -score if self.score_order == "max" else score)

    def _enforce_retention(self) -> None:
        if self.num_to_keep is None:
            return
        # _entries stays in insertion (step) order so latest() keeps working.
        while len(self._entries) > self.num_to_keep:
            if self.score_attribute:
                victim = max(self._entries, key=self._badness)
                self._entries.remove(victim)
            else:
                victim = self._entries.pop(0)  # oldest
            shutil.rmtree(victim[2], ignore_errors=True)
