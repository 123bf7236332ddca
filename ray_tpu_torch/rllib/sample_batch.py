"""A copy of the JAX package's ``rllib/sample_batch.py`` (numpy only),
kept here because the port imports nothing of that package. Its
docstring:

SampleBatch: columnar trajectory storage + GAE.

Reference analog: ``rllib/policy/sample_batch.py`` (SampleBatch,
concat_samples) and ``rllib/evaluation/postprocessing.py`` (GAE advantage
computation). Columns are numpy arrays host-side; the learner converts to
device arrays once per update.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
STATE_IN = "state_in"  # [S, N, cell]: recurrent state at fragment start
NEXT_OBS = "next_obs"
LOGPS = "action_logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"


class SampleBatch(dict):
    """A dict of equal-length numpy columns."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            self[k] = np.asarray(v)

    @property
    def count(self) -> int:
        if not self:
            return 0
        return len(next(iter(self.values())))

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    @staticmethod
    def concat_samples(batches: List["SampleBatch"]) -> "SampleBatch":
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch(
            {k: np.concatenate([b[k] for b in batches]) for k in keys}
        )

    def shuffle(self, seed: Optional[int] = None) -> "SampleBatch":
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.count)
        return SampleBatch({k: v[idx] for k, v in self.items()})

    def minibatches(self, size: int) -> Iterator["SampleBatch"]:
        n = self.count
        for start in range(0, n - size + 1, size):
            yield SampleBatch(
                {k: v[start:start + size] for k, v in self.items()}
            )

    def split(self, n: int) -> List["SampleBatch"]:
        bounds = np.linspace(0, self.count, n + 1).astype(int)
        return [
            SampleBatch({k: v[bounds[i]: bounds[i + 1]]
                         for k, v in self.items()})
            for i in range(n)
        ]


def compute_gae(batch: SampleBatch, last_values: np.ndarray,
                gamma: float = 0.99, lam: float = 0.95) -> SampleBatch:
    """Generalized advantage estimation over (possibly vectorized) rollouts.

    Expects columns shaped [T, N] (time-major over N parallel envs) for
    REWARDS/DONES/VF_PREDS; ``last_values`` [N] bootstraps the final step.
    Reference: postprocessing.py compute_advantages.
    """
    rewards = batch[REWARDS]
    dones = batch[DONES].astype(np.float32)
    values = batch[VF_PREDS]
    t_len = rewards.shape[0]
    next_values = np.concatenate([values[1:], last_values[None]], axis=0)
    adv = np.zeros_like(rewards, dtype=np.float32)
    last_gae = np.zeros_like(last_values, dtype=np.float32)
    for t in range(t_len - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_values[t] * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
    batch[ADVANTAGES] = adv
    batch[VALUE_TARGETS] = adv + values
    return batch


def flatten_time_major(batch: SampleBatch) -> SampleBatch:
    """[T, N, ...] -> [T*N, ...] for minibatch SGD."""
    out = {}
    for k, v in batch.items():
        out[k] = v.reshape((-1,) + v.shape[2:])
    return SampleBatch(out)
