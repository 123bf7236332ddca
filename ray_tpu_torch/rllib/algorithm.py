"""Algorithm, AlgorithmConfig and WorkerSet: counterpart of the JAX
package's ``rllib/algorithm.py``.

The learner runs on ``default_device(device)``: the card unless the
caller passes ``device="cpu"``. The rollout workers' policies run on the
CPU. With ``num_rollout_workers=0`` (local mode) the one local worker
samples inline and nothing else is needed. Remote workers are actors of a
runtime the caller passes as ``runtime=``: any object with ``remote``,
``get``, ``put``, ``wait`` and ``kill`` (``ray_tpu.core`` is one). The port
imports no runtime itself. Weights cross to the workers as numpy dicts in
the JAX package's layout, so every sync copies each leaf from the learner's
device to the host once.

Also here: what the learners share, their parameters as a dict of leaf
tensors on the learner's device (``to_learner``; nested trees
``learner_tree``, in place ``copy_into``/``copy_tree_into``) and one
optimizer step on them (``sgd_step``, ``opt_step``).
"""

from __future__ import annotations

import copy
import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import default_device
from ..models.convert import ppo_params_from_numpy, rl_tree_from_numpy
from .policy import Params
from .rollout_worker import RolloutWorker
from .sample_batch import SampleBatch

_NO_RUNTIME = ("num_rollout_workers > 0 needs runtime=: an object with "
               "remote, get, put, wait and kill, such as ray_tpu.core; the "
               "port imports no runtime itself (ROADMAP Queue A item 8)")


class AlgorithmConfig:
    """Fluent config: ``environment``, ``rollouts``, ``training``,
    ``debugging``, ``copy``, ``build``."""

    def __init__(self):
        self.env: Any = "FastCartPole"
        self.num_rollout_workers: int = 0
        self.num_envs_per_worker: int = 8
        self.rollout_fragment_length: int = 128
        self.gamma: float = 0.99
        self.lr: float = 3e-4
        self.train_batch_size: int = 2048
        self.seed: int = 0
        self.policy_hidden: tuple = (64, 64)
        # "auto": conv (Nature CNN) for [H, W, C] frames, mlp otherwise.
        self.policy_network: str = "auto"
        # The catalog's model config: fcnet_hiddens, use_lstm,
        # lstm_cell_size, custom_model, ...
        self.model: Optional[Dict[str, Any]] = None
        # Algorithm-specific keys forwarded into every worker's policy cfg.
        self.policy_config_extra: Dict[str, Any] = {}
        self.extra: Dict[str, Any] = {}

    def environment(self, env: Any = None, **kwargs) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        self.extra.update(kwargs)
        return self

    def rollouts(self, num_rollout_workers: Optional[int] = None,
                 num_envs_per_worker: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None
                 ) -> "AlgorithmConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, lr: Optional[float] = None,
                 gamma: Optional[float] = None,
                 train_batch_size: Optional[int] = None,
                 model: Optional[Dict[str, Any]] = None,
                 **kwargs) -> "AlgorithmConfig":
        if lr is not None:
            self.lr = lr
        if gamma is not None:
            self.gamma = gamma
        if train_batch_size is not None:
            self.train_batch_size = train_batch_size
        if model is not None:
            self.model = model
        self.extra.update(kwargs)
        return self

    def debugging(self, seed: Optional[int] = None, **kwargs
                  ) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def build(self, device=None, runtime=None) -> "Algorithm":
        """The algorithm, its learner on ``default_device(device)``;
        ``runtime`` as ``Algorithm`` takes it."""
        algo_cls = getattr(self, "_algo_class", None)
        if algo_cls is None:
            raise ValueError("use a concrete config (e.g. PPOConfig)")
        return algo_cls(self, device=device, runtime=runtime)


class WorkerSet:
    """The learner's view of the rollout workers: the local worker, and
    ``num_rollout_workers`` actors of ``runtime``."""

    def __init__(self, config: AlgorithmConfig, worker_cls=None,
                 runtime=None):
        self.config = config
        self.runtime = runtime
        worker_cls = worker_cls or RolloutWorker
        policy_cfg = {"hidden": config.policy_hidden,
                      "network": config.policy_network,
                      "model": config.model,
                      **config.policy_config_extra}
        if config.num_rollout_workers > 0 and runtime is None:
            raise ValueError(_NO_RUNTIME)
        self.local_worker = worker_cls(
            config.env, config.num_envs_per_worker, dict(policy_cfg),
            seed=config.seed)
        self.remote_workers: List[Any] = []
        if config.num_rollout_workers > 0:
            remote_cls = runtime.remote(worker_cls)
            self.remote_workers = [
                remote_cls.options(num_cpus=1).remote(
                    config.env, config.num_envs_per_worker,
                    dict(policy_cfg), seed=config.seed, worker_index=i + 1)
                for i in range(config.num_rollout_workers)]

    def foreach_worker(self, fn: Callable) -> List[Any]:
        """``fn`` on the local worker inline and on each remote one."""
        results = [fn(self.local_worker)]
        if self.remote_workers:
            results.extend(self.runtime.get(
                [w.apply.remote(fn) for w in self.remote_workers]))
        return results

    def sync_weights(self, weights: Dict) -> None:
        if self.remote_workers:
            ref = self.runtime.put(weights)  # one copy, N readers
            self.runtime.get([w.set_weights.remote(ref)
                              for w in self.remote_workers])

    def sample(self, rollout_length: int) -> List[SampleBatch]:
        if self.remote_workers:
            return self.runtime.get([w.sample.remote(rollout_length)
                                     for w in self.remote_workers])
        return [self.local_worker.sample(rollout_length)]

    def episode_stats(self) -> List[Dict]:
        if self.remote_workers:
            return self.runtime.get([w.episode_stats.remote()
                                     for w in self.remote_workers])
        return [self.local_worker.episode_stats()]

    def stop(self) -> None:
        for w in self.remote_workers:
            try:
                self.runtime.kill(w)
            except Exception:  # an actor already gone is what stop wants
                pass


def to_learner(weights: Dict[str, np.ndarray], device) -> Params:
    """Numpy weights in the JAX layout -> leaf tensors on ``device`` that
    take gradients."""
    return {k: v.to(device).requires_grad_()
            for k, v in ppo_params_from_numpy(weights).items()}


def batch_to(columns: Dict[str, np.ndarray], device
             ) -> Dict[str, torch.Tensor]:
    """Numpy columns -> tensors on ``device`` (an array the object plane
    handed over read-only is copied first)."""
    return {k: torch.from_numpy(np.require(v, requirements="W")).to(device)
            for k, v in columns.items()}


@torch.no_grad()
def copy_into(params: Params, weights: Dict[str, np.ndarray]) -> None:
    """Numpy weights in the JAX layout copied into ``params`` in place,
    leaf by leaf (the same names and shapes)."""
    new = ppo_params_from_numpy(weights)
    if set(new) != set(params):
        raise ValueError(f"weights {sorted(new)} are not the parameters "
                         f"{sorted(params)}")
    for k, p in params.items():
        p.copy_(new[k])


def tree_map(fn: Callable, tree, leaf: type = torch.Tensor):
    """``fn`` on every ``leaf`` (a tensor, or a numpy array) of nested
    tuples, lists and dicts, such as an optimizer state."""
    if isinstance(tree, leaf):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, leaf) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, leaf) for v in tree)
    return tree


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested dicts, lists and tuples in JAX's flattening
    order (a dict's keys sorted), which the optimizer states of nested
    parameter trees follow."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def learner_tree(weights, device):
    """A nested numpy tree in the JAX layout (SAC's, TD3's, CQL's) -> leaf
    tensors on ``device`` that take gradients, nested as the weights."""
    return tree_map(lambda t: t.to(device).requires_grad_(),
                    rl_tree_from_numpy(weights))


@torch.no_grad()
def copy_tree_into(tree, weights) -> None:
    """A nested numpy tree in the JAX layout copied into ``tree`` in place,
    leaf by leaf (the same nesting, names and shapes)."""
    mine, theirs = tree_leaves(tree), tree_leaves(rl_tree_from_numpy(weights))
    if len(mine) != len(theirs):
        raise ValueError(f"{len(theirs)} leaves for {len(mine)}")
    for p, v in zip(mine, theirs):
        p.copy_(v.reshape(p.shape))


def key_to_numpy(key) -> np.ndarray:
    """A ``random`` key as JAX keeps it: uint32 words ``[2]``."""
    return np.array([int(key[0]), int(key[1])], np.uint32)


def key_from_numpy(words, device):
    w = np.asarray(words).astype(np.int64)
    return (torch.tensor(w[0], device=device),
            torch.tensor(w[1], device=device))


@torch.no_grad()
def opt_step(leaves: List[torch.Tensor], grads, optimizer, opt_state):
    """The optimizer's update of ``leaves`` from ``grads``, added to them in
    place; returns the optimizer state."""
    updates, opt_state = optimizer.update(
        list(grads), opt_state, [p.detach() for p in leaves])
    for p, u in zip(leaves, updates):
        p.add_(u)
    return opt_state


def sgd_step(params: Params, opt_state, optimizer, loss_fn: Callable
             ) -> Tuple[torch.Tensor, Any, Any]:
    """One step: ``loss_fn(params) -> (loss, aux)``, its gradients, the
    optimizer's update added to the parameters in place. Returns (loss,
    aux) detached and the optimizer state."""
    leaves = list(params.values())
    with torch.enable_grad():
        loss, aux = loss_fn(params)
        grads = torch.autograd.grad(loss, leaves)
    opt_state = opt_step(leaves, grads, optimizer, opt_state)
    return loss.detach(), tree_map(torch.Tensor.detach, aux), opt_state


class Algorithm:
    """Trainable-style base: ``train``, ``save``/``restore``,
    ``get_state``/``set_state``, ``stop``, ``as_trainable``."""

    # Subclasses swap the rollout worker (DQN's collects transitions).
    _worker_cls = RolloutWorker

    def __init__(self, config: AlgorithmConfig, device=None, runtime=None):
        self.device = default_device(device)
        self.config = config
        self.runtime = runtime
        self.iteration = 0
        self._timesteps_total = 0
        self.setup(config)

    def setup(self, config: AlgorithmConfig) -> None:
        self.workers = WorkerSet(config, worker_cls=type(self)._worker_cls,
                                 runtime=self.runtime)

    def training_step(self) -> Dict:
        raise NotImplementedError

    def train(self) -> Dict:
        """One training iteration."""
        t0 = time.perf_counter()
        result = self.training_step()
        self.iteration += 1
        elapsed = time.perf_counter() - t0
        rewards = [s["episode_reward_mean"]
                   for s in self.workers.episode_stats()
                   if s.get("episode_reward_mean") is not None]
        result.update({
            "training_iteration": self.iteration,
            "timesteps_total": self._timesteps_total,
            "time_this_iter_s": elapsed,
            "env_steps_per_sec": result.get("timesteps_this_iter", 0) / max(
                elapsed, 1e-9),
        })
        if rewards:
            result["episode_reward_mean"] = float(sum(rewards) / len(rewards))
        return result

    def save(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        file = os.path.join(path, "algorithm_state.pkl")
        with open(file, "wb") as f:
            pickle.dump(self.get_state(), f)
        return file

    def restore(self, path: str) -> None:
        file = (path if path.endswith(".pkl")
                else os.path.join(path, "algorithm_state.pkl"))
        with open(file, "rb") as f:
            self.set_state(pickle.load(f))

    def get_state(self) -> Dict:
        state = {"iteration": self.iteration,
                 "timesteps_total": self._timesteps_total}
        try:
            state["connectors"] = self.workers.local_worker.connector_state()
        except Exception:  # lambda connectors; the rest still saves
            pass
        return state

    def set_state(self, state: Dict) -> None:
        self.iteration = state.get("iteration", 0)
        self._timesteps_total = state.get("timesteps_total", 0)
        conn = state.get("connectors")
        if conn is not None:
            self.workers.foreach_worker(
                lambda w: w.restore_connector_state(conn))

    def _set_learner_params(self, weights: Dict[str, np.ndarray]) -> None:
        """The learner's parameters from numpy weights, copied in place
        (the optimizer state follows the parameters' order), then every
        worker's."""
        copy_into(self.params, weights)
        self.workers.local_worker.set_weights(weights)
        self.workers.sync_weights(weights)

    def stop(self) -> None:
        self.workers.stop()

    @classmethod
    def as_trainable(cls, base_config: AlgorithmConfig,
                     report: Optional[Callable] = None,
                     stop_iters: int = 10, device=None, runtime=None
                     ) -> Callable:
        """Adapt to the Tune layer: a function trainable that calls
        ``report`` with each iteration's result; by default the port's
        ``ray_tpu_torch.tune.report``."""

        def trainable(tune_config: Dict):
            from ..tune import report as tune_report

            emit = report or tune_report
            config = base_config.copy()
            for k, v in tune_config.items():
                setattr(config, k, v)
            algo = cls(config, device=device, runtime=runtime)
            try:
                for _ in range(stop_iters):
                    emit(algo.train())
            finally:
                algo.stop()

        return trainable
