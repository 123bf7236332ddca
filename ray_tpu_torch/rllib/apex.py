"""Ape-X DQN: counterpart of the JAX package's ``rllib/apex.py``.

Distributed prioritized replay on an actor runtime the caller injects
(``runtime=``, as ``WorkerSet`` takes it; the port imports none):

- rollout workers compute the initial priorities (|TD| under their
  current weights, on the CPU) and ship (batch, priorities) to the
  replay tier;
- the replay tier is a set of ``ReplayShard`` actors, each a
  ``PrioritizedReplayBuffer``: adds, samples and priority updates are
  actor calls;
- the learner (the port's DQN update, on the learner's device) keeps one
  sample in flight per rollout worker, trains from the shards in turn,
  sends priority corrections back to the shard a batch came from, and
  broadcasts weights every ``weight_sync_period`` updates.

Worker ``i`` of ``N`` explores with ``eps_i = base ** (1 + i/(N-1) *
alpha)``, constant, not annealed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.convert import ppo_tree_to_numpy
from .algorithm import batch_to
from .dqn import DQN, DQNConfig, DQNRolloutWorker, q_values
from .replay_buffers import PrioritizedReplayBuffer
from .sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch

_NO_RUNTIME = ("ApexDQN's replay shards and rollout workers are actors: it "
               "needs runtime=, an object with remote, get, put, wait and "
               "kill, such as ray_tpu.core; the port imports no runtime "
               "itself (ROADMAP Queue A item 8)")


class ApexRolloutWorker(DQNRolloutWorker):
    """DQN rollout worker that ships initial priorities with its data."""

    @torch.no_grad()
    def sample_with_priorities(self, rollout_length: int, gamma: float):
        batch = self.sample(rollout_length)
        params = self.policy.params
        dev = self.policy.device
        q = q_values(params, torch.as_tensor(batch[OBS], device=dev)
                     ).cpu().numpy()
        q_taken = q[np.arange(batch.count),
                    np.asarray(batch[ACTIONS]).astype(np.int64)]
        next_q_online = q_values(params, torch.as_tensor(
            batch[NEXT_OBS], device=dev)).cpu().numpy()
        # Workers hold no target net: the online net picks and values for
        # the initial priority, which only seeds the sampling
        # distribution; the learner's updates use the target net.
        next_a = np.argmax(next_q_online, axis=-1)
        next_q = next_q_online[np.arange(batch.count), next_a]
        not_done = 1.0 - np.asarray(batch[DONES], np.float32)
        target = np.asarray(batch[REWARDS]) + gamma * not_done * next_q
        prios = np.abs(q_taken - target).astype(np.float32)
        return dict(batch), prios


class ReplayShard:
    """Actor body of one prioritized replay shard."""

    def __init__(self, capacity: int, alpha: float, seed: int):
        self.buffer = PrioritizedReplayBuffer(capacity, alpha=alpha,
                                              seed=seed)
        self.adds = 0
        self.samples = 0

    def add(self, batch: Dict, priorities) -> int:
        self.buffer.add(SampleBatch(batch), priorities)
        self.adds += 1
        return len(self.buffer)

    def sample(self, num_items: int, beta: float):
        if len(self.buffer) < num_items:
            return None
        self.samples += 1
        return dict(self.buffer.sample(num_items, beta=beta))

    def update_priorities(self, idx, priorities) -> bool:
        self.buffer.update_priorities(np.asarray(idx),
                                      np.asarray(priorities))
        return True

    def stats(self) -> Dict:
        return {"size": len(self.buffer), "adds": self.adds,
                "samples": self.samples}


def epsilon_ladder(n: int, base: float, alpha: float) -> list:
    """Ape-X's per-worker exploration: ``base ** (1 + i/(n-1) * alpha)``."""
    return [float(base ** (1.0 + (i / max(n - 1, 1)) * alpha))
            for i in range(n)]


class ApexConfig(DQNConfig):
    def __init__(self):
        super().__init__()
        self._algo_class = ApexDQN
        self.num_rollout_workers = 2
        self.num_replay_shards = 2
        self.worker_epsilon_base = 0.4
        self.worker_epsilon_alpha = 7.0
        self.weight_sync_period = 16  # learner updates between broadcasts
        self.sample_wait_timeout = 10.0

    def training(self, **kwargs) -> "ApexConfig":
        for k in ("num_replay_shards", "worker_epsilon_base",
                  "worker_epsilon_alpha", "weight_sync_period"):
            if k in kwargs:
                setattr(self, k, kwargs.pop(k))
        super().training(**kwargs)
        return self


class ApexDQN(DQN):
    """Distributed replay on the injected runtime's actors; the learner's
    update is DQN's. Without a runtime it raises: it has no local
    buffer to fall back to."""

    _worker_cls = ApexRolloutWorker

    def setup(self, config: ApexConfig) -> None:
        if self.runtime is None:
            raise ValueError(_NO_RUNTIME)
        super().setup(config)
        rt = self.runtime
        self.buffer = None  # replaced by the sharded replay tier
        shard_cls = rt.remote(ReplayShard)
        per_shard = max(1, config.buffer_capacity
                        // max(config.num_replay_shards, 1))
        self.shards = [
            shard_cls.options(num_cpus=0).remote(
                per_shard, config.prioritized_alpha, config.seed + i)
            for i in range(config.num_replay_shards)]
        self._add_rr = 0
        self._sample_rr = 0
        self._replay_size = 0
        self._in_flight: Dict = {}
        n = max(len(self.workers.remote_workers), 1)
        self._epsilons = epsilon_ladder(n, config.worker_epsilon_base,
                                        config.worker_epsilon_alpha)
        for i, w in enumerate(self.workers.remote_workers):
            eps = self._epsilons[i]
            rt.get(w.apply.remote(lambda wk, e=eps: wk.set_epsilon(e)),
                   timeout=60)
        self.workers.local_worker.set_epsilon(self._epsilons[0])

    def _push_to_shard(self, batch: Dict, prios) -> None:
        shard = self.shards[self._add_rr % len(self.shards)]
        self._add_rr += 1
        # fire-and-forget: the learner never blocks on replay ingestion
        shard.add.remote(batch, prios)

    def _pump_workers(self) -> int:
        """Keep one sample in flight per remote worker; drain finished ones
        into the replay tier. Returns the new env steps."""
        cfg, rt = self.config, self.runtime
        new_steps = 0
        for w in self.workers.remote_workers:
            if w not in self._in_flight.values():
                ref = w.sample_with_priorities.remote(
                    cfg.rollout_fragment_length, cfg.gamma)
                self._in_flight[ref] = w
        if self._in_flight:
            ready, _ = rt.wait(list(self._in_flight), num_returns=1,
                               timeout=cfg.sample_wait_timeout)
            for ref in ready:
                self._in_flight.pop(ref)
                batch, prios = rt.get(ref)
                new_steps += len(prios)
                self._push_to_shard(batch, prios)
        return new_steps

    def training_step(self) -> Dict:
        cfg, rt = self.config, self.runtime
        if self.workers.remote_workers:
            new_steps = self._pump_workers()
        else:  # synchronous: the local worker samples inline
            batch, prios = self.workers.local_worker \
                .sample_with_priorities(cfg.rollout_fragment_length,
                                        cfg.gamma)
            self._push_to_shard(batch, prios)
            new_steps = len(prios)
        self._timesteps_total += new_steps

        losses = []
        # Gated on learning_starts as DQN; _replay_size is the last
        # iteration's shard total.
        updates_allowed = (cfg.num_updates_per_iter
                           if self._replay_size >= cfg.learning_starts
                           else 0)
        for _ in range(updates_allowed):
            shard = self.shards[self._sample_rr % len(self.shards)]
            self._sample_rr += 1
            sampled = rt.get(shard.sample.remote(
                cfg.train_batch_size, cfg.prioritized_beta), timeout=60)
            if sampled is None:
                continue  # shard still warming up
            device_batch = batch_to({k: v for k, v in sampled.items()
                                     if k != "batch_indexes"}, self.device)
            self.params, self.opt_state, loss, td = self._update(
                self.params, self.target_params, self.opt_state,
                device_batch)
            shard.update_priorities.remote(sampled["batch_indexes"],
                                           td.cpu().numpy())
            self._num_updates += 1
            if self._num_updates % cfg.target_network_update_freq == 0:
                self.target_params = self._copy(self.params)
            if self._num_updates % cfg.weight_sync_period == 0:
                weights = ppo_tree_to_numpy(self.params)
                self.workers.local_worker.set_weights(weights)
                self.workers.sync_weights(weights)
            losses.append(float(loss))

        shard_stats = rt.get([s.stats.remote() for s in self.shards],
                             timeout=60)
        self._replay_size = int(sum(s["size"] for s in shard_stats))
        return {
            "timesteps_this_iter": new_steps,
            "num_learner_updates": self._num_updates,
            "replay_shards": shard_stats,
            "replay_buffer_size": self._replay_size,
            "loss": float(np.mean(losses)) if losses else None,
        }

    def stop(self) -> None:
        self._in_flight.clear()
        for s in getattr(self, "shards", []):
            try:
                self.runtime.kill(s)
            except Exception:  # an actor already gone is what stop wants
                pass
        super().stop()
