"""The port's PPO and IMPALA with remote rollout workers: actors of the
JAX package's runtime, injected as ``runtime=ray_tpu.core`` (the port
itself imports no runtime). The counterpart of ``test_rllib.py``'s
``test_ppo_remote_workers``.
"""

import signal

import numpy as np

import ray_tpu as rt
import ray_tpu.core
from ray_tpu_torch.rllib import ImpalaConfig, PPOConfig

LIMIT_S = 240  # the test's own limit: a hung worker fails it, not the suite


def _on_alarm(signum, frame):
    raise TimeoutError(f"remote rollout workers took over {LIMIT_S} s")


def test_remote_rollout_workers():
    """PPO with 2 remote workers: one iteration samples 2 x 2 x 32 steps
    through them and sends every worker the learner's new weights; then
    IMPALA's asynchronous loop (the runtime's ``wait``) learns on 4
    fragments from 2 workers. The runtime is shut down in any case."""
    previous = signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(LIMIT_S)
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=4)
    try:
        algo = (PPOConfig().environment("FastCartPole")
                .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                          rollout_fragment_length=32)
                .training(sgd_minibatch_size=32, num_sgd_iter=2)
                .build(device="cpu", runtime=ray_tpu.core))
        try:
            result = algo.train()
            assert result["timesteps_this_iter"] == 2 * 2 * 32
            assert np.isfinite(result["total_loss"])
            want = algo.get_state()["params"]
            for w in algo.workers.remote_workers:
                got = ray_tpu.core.get(w.get_weights.remote())
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
            assert all(p.device.type == "cpu" for p in algo.params.values())
        finally:
            algo.stop()
        algo = (ImpalaConfig().environment("FastCartPole")
                .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                          rollout_fragment_length=16)
                .training(num_batches_per_iter=4)
                .build(device="cpu", runtime=ray_tpu.core))
        try:
            result = algo.train()
            assert result["num_learner_updates"] == 4
            assert result["timesteps_this_iter"] == 4 * 2 * 16
            assert np.isfinite(result["loss"])
        finally:
            algo.stop()
    finally:
        rt.shutdown()
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
