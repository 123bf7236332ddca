"""A copy of the JAX package's ``rllib/replay_buffers.py`` (numpy only),
kept here because the port imports nothing of that package. Its
docstring:

Replay buffers: FIFO, prioritized (sum-tree), reservoir.

Reference analog: ``rllib/utils/replay_buffers/`` — ``ReplayBuffer``
(FIFO ring), ``PrioritizedReplayBuffer`` (proportional prioritization,
Schaul et al. 2015), ``ReservoirReplayBuffer`` (uniform-over-stream).

TPU-first design notes: buffers live in host RAM as preallocated numpy
ring arrays (structure-of-arrays, one array per SampleBatch column), so
``sample`` produces a contiguous batch the learner can ship to HBM in a
single transfer.  The sum-tree is a flat numpy array updated vectorised —
no per-element Python tree nodes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .sample_batch import SampleBatch


class ReplayBuffer:
    """FIFO ring buffer over SampleBatch rows.

    Columns are preallocated on the first ``add`` from the batch's own
    dtypes/shapes; adds and samples are vectorised slices.
    """

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = int(capacity)
        self._cols: Dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)
        self._added = 0

    def __len__(self) -> int:
        return self._size

    @property
    def added_count(self) -> int:
        return self._added

    def _ensure_cols(self, batch: SampleBatch) -> None:
        for k, v in batch.items():
            if k not in self._cols:
                v = np.asarray(v)
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:],
                                         v.dtype)

    def _write(self, batch: SampleBatch) -> np.ndarray:
        """Write rows into the ring; returns the written indices."""
        self._ensure_cols(batch)
        n = batch.count
        if n > self.capacity:  # keep only the newest rows
            batch = batch.slice(n - self.capacity, n)
            n = self.capacity
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._cols[k][idx] = np.asarray(v)
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)
        self._added += n
        return idx

    def add(self, batch: SampleBatch) -> None:
        self._write(batch)

    def sample(self, num_items: int) -> SampleBatch:
        if self._size == 0:
            raise ValueError("empty replay buffer")
        idx = self._rng.integers(0, self._size, num_items)
        return SampleBatch({k: v[idx] for k, v in self._cols.items()})

    def stats(self) -> Dict:
        return {"size": self._size, "capacity": self.capacity,
                "added_count": self._added}


class SumSegmentTree:
    """Flat-array sum tree supporting O(log n) prefix-sum sampling and
    vectorised priority updates (reference: ``utils/segment_tree.py``)."""

    def __init__(self, capacity: int):
        self.capacity = 1
        while self.capacity < capacity:
            self.capacity *= 2
        self._tree = np.zeros(2 * self.capacity, np.float64)

    def __setitem__(self, idx, val) -> None:
        idx = np.atleast_1d(np.asarray(idx, np.int64)) + self.capacity
        self._tree[idx] = np.atleast_1d(val)
        # propagate up level by level (vectorised over the index set)
        while idx[0] > 1:
            idx = np.unique(idx // 2)
            self._tree[idx] = self._tree[2 * idx] + self._tree[2 * idx + 1]

    def __getitem__(self, idx):
        return self._tree[np.asarray(idx) + self.capacity]

    def sum(self) -> float:
        return float(self._tree[1])

    def find_prefixsum_idx(self, prefixsum: np.ndarray) -> np.ndarray:
        """Vectorised descent: for each target mass, the leaf where the
        running prefix sum crosses it."""
        prefixsum = np.asarray(prefixsum, np.float64).copy()
        idx = np.ones(len(prefixsum), np.int64)
        while idx[0] < self.capacity:
            left = self._tree[2 * idx]
            go_right = prefixsum > left
            prefixsum -= np.where(go_right, left, 0.0)
            idx = 2 * idx + go_right
        return idx - self.capacity


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (alpha/beta schedule, IS weights).

    ``sample`` returns the batch plus ``weights`` (importance-sampling
    correction) and ``batch_indexes`` for ``update_priorities``.
    """

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 seed: int = 0):
        super().__init__(capacity, seed)
        assert alpha > 0
        self._alpha = alpha
        self._tree = SumSegmentTree(self.capacity)
        self._max_priority = 1.0

    def add(self, batch: SampleBatch, priorities=None) -> None:
        """``priorities`` (|td| per row) lets distributed producers ship
        INITIAL priorities with the data instead of defaulting to max —
        the Ape-X insight that keeps fresh-but-boring transitions from
        flooding the sample distribution (reference: apex_dqn.py)."""
        idx = self._write(batch)
        if priorities is None:
            self._tree[idx] = self._max_priority ** self._alpha
        else:
            priorities = np.abs(np.asarray(priorities, np.float64)) + 1e-6
            # _write keeps only the NEWEST `capacity` rows of an
            # oversized batch; keep the matching tail of priorities.
            if len(priorities) > len(idx):
                priorities = priorities[-len(idx):]
            self._tree[idx] = priorities ** self._alpha
            self._max_priority = max(self._max_priority,
                                     float(priorities.max()))

    def sample(self, num_items: int, beta: float = 0.4) -> SampleBatch:
        if self._size == 0:
            raise ValueError("empty replay buffer")
        mass = self._rng.random(num_items) * self._tree.sum()
        idx = np.minimum(self._tree.find_prefixsum_idx(mass), self._size - 1)
        p = self._tree[idx] / max(self._tree.sum(), 1e-12)
        weights = (p * self._size) ** (-beta)
        weights /= weights.max() + 1e-12
        out = SampleBatch({k: v[idx] for k, v in self._cols.items()})
        out["weights"] = weights.astype(np.float32)
        out["batch_indexes"] = idx.astype(np.int64)
        return out

    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray
                          ) -> None:
        priorities = np.abs(np.asarray(priorities, np.float64)) + 1e-6
        self._tree[np.asarray(idx)] = priorities ** self._alpha
        self._max_priority = max(self._max_priority,
                                 float(priorities.max()))


class ReservoirReplayBuffer(ReplayBuffer):
    """Uniform sample over the whole stream (Vitter's algorithm R);
    used by league-style algorithms (reference: reservoir buffer in
    ``utils/replay_buffers/reservoir_replay_buffer.py``)."""

    def add(self, batch: SampleBatch) -> None:
        self._ensure_cols(batch)
        n = batch.count
        for row in range(n):
            self._added += 1
            if self._size < self.capacity:
                slot = self._size
                self._size += 1
            else:
                slot = int(self._rng.integers(0, self._added))
                if slot >= self.capacity:
                    continue
            for k, v in batch.items():
                self._cols[k][slot] = np.asarray(v[row])


class MultiAgentReplayBuffer:
    """Per-policy-id buffers behind one facade (reference:
    ``multi_agent_replay_buffer.py``)."""

    def __init__(self, capacity: int = 100_000, prioritized: bool = False,
                 seed: int = 0, **kwargs):
        self._capacity = capacity
        self._prioritized = prioritized
        self._seed = seed
        self._kwargs = kwargs
        self.buffers: Dict[str, ReplayBuffer] = {}

    def _buffer(self, policy_id: str) -> ReplayBuffer:
        if policy_id not in self.buffers:
            cls = PrioritizedReplayBuffer if self._prioritized else ReplayBuffer
            self.buffers[policy_id] = cls(
                self._capacity, seed=self._seed + len(self.buffers),
                **self._kwargs)
        return self.buffers[policy_id]

    def add(self, batch: SampleBatch, policy_id: str = "default_policy"
            ) -> None:
        self._buffer(policy_id).add(batch)

    def sample(self, num_items: int, policy_id: str = "default_policy",
               **kwargs) -> SampleBatch:
        return self._buffer(policy_id).sample(num_items, **kwargs)

    def stats(self) -> Dict:
        return {pid: b.stats() for pid, b in self.buffers.items()}
