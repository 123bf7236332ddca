"""Reinforcement learning of the port (counterparts of the JAX package's
``rllib``): the actor-based algorithms (PPO, recurrent PPO, A2C, IMPALA,
APPO, DQN) with their learner on the card and their rollout workers'
policies on the CPU, the catalog's networks, the envs, connectors, replay
buffers and sample batches, and the on-device PPO path (``ondevice.py``).
Remote rollout workers run on a runtime the caller passes (``runtime=``).
"""

from .a2c import A2C, A2CConfig
from .algorithm import Algorithm, AlgorithmConfig, WorkerSet
from .appo import APPO, APPOConfig
from .catalog import MODEL_DEFAULTS, get_network, register_custom_model
from .dqn import DQN, DQNConfig
from .env import AtariSim, FastCartPole, FastPendulum, VectorEnv, make_env
from .impala import Impala, ImpalaConfig, vtrace
from .policy import Network, TorchPolicy, make_network
from .ppo import PPO, PPOConfig
from .rollout_worker import RolloutWorker
from .sample_batch import SampleBatch, compute_gae

__all__ = [
    "A2C", "A2CConfig", "APPO", "APPOConfig", "Algorithm",
    "AlgorithmConfig", "AtariSim", "DQN", "DQNConfig", "FastCartPole",
    "FastPendulum", "Impala", "ImpalaConfig", "MODEL_DEFAULTS", "Network",
    "PPO", "PPOConfig", "RolloutWorker", "SampleBatch", "TorchPolicy",
    "VectorEnv", "WorkerSet", "compute_gae", "get_network", "make_env",
    "make_network", "register_custom_model", "vtrace",
]
