"""Reinforcement learning of the port (counterparts of the JAX package's
``rllib``): the actor-based algorithms (PPO, recurrent PPO, A2C, IMPALA,
APPO, DQN, Ape-X), the continuous-control learners (SAC, TD3), the offline
ones (CQL, MARWIL, BC) with their JSON I/O and off-policy estimators, and
ES/ARS; the learners on the card, the rollout workers' policies and ES's
evaluation on the CPU; the catalog's networks, the envs, connectors,
replay buffers and sample batches, and the on-device PPO path
(``ondevice.py``). Remote workers and Ape-X's replay shards run on a
runtime the caller passes (``runtime=``).
"""

from .a2c import A2C, A2CConfig
from .algorithm import Algorithm, AlgorithmConfig, WorkerSet
from .apex import ApexConfig, ApexDQN
from .appo import APPO, APPOConfig
from .catalog import MODEL_DEFAULTS, get_network, register_custom_model
from .cql import CQL, CQLConfig
from .dqn import DQN, DQNConfig
from .env import AtariSim, FastCartPole, FastPendulum, VectorEnv, make_env
from .es import ARS, ARSConfig, ES, ESConfig, SharedNoiseTable
from .impala import Impala, ImpalaConfig, vtrace
from .marwil import BC, BCConfig, MARWIL, MARWILConfig
from .offline import (DirectMethod, DoublyRobust, ImportanceSampling,
                      JsonReader, JsonWriter, WeightedImportanceSampling)
from .policy import Network, TorchPolicy, make_network
from .ppo import PPO, PPOConfig
from .rollout_worker import RolloutWorker
from .sac import SAC, SACConfig
from .sample_batch import SampleBatch, compute_gae
from .td3 import TD3, TD3Config

__all__ = [
    "A2C", "A2CConfig", "APPO", "APPOConfig", "ARS", "ARSConfig",
    "Algorithm", "AlgorithmConfig", "ApexConfig", "ApexDQN", "AtariSim",
    "BC", "BCConfig", "CQL", "CQLConfig", "DQN", "DQNConfig",
    "DirectMethod", "DoublyRobust", "ES", "ESConfig", "FastCartPole",
    "FastPendulum", "Impala", "ImpalaConfig", "ImportanceSampling",
    "JsonReader", "JsonWriter", "MARWIL", "MARWILConfig", "MODEL_DEFAULTS",
    "Network", "PPO", "PPOConfig", "RolloutWorker", "SAC", "SACConfig",
    "SampleBatch", "SharedNoiseTable", "TD3", "TD3Config", "TorchPolicy",
    "VectorEnv", "WeightedImportanceSampling", "WorkerSet", "compute_gae",
    "get_network", "make_env", "make_network", "register_custom_model",
    "vtrace",
]
