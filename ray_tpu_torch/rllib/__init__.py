"""Reinforcement learning of the port (counterparts of the JAX package's
``rllib``): the actor-based algorithms (PPO, recurrent PPO, A2C, IMPALA,
APPO, DQN, Ape-X), the continuous-control learners (SAC, TD3), the offline
ones (CQL, MARWIL, BC) with their JSON I/O and off-policy estimators, and
ES/ARS; the learners on the card, the rollout workers' policies and ES's
evaluation on the CPU; external envs and the policy server; the catalog's
networks, the envs (multi-agent too), connectors, replay buffers, sample
batches and contextual bandits, and the on-device PPO path
(``ondevice.py``). Remote workers and Ape-X's replay shards run on a
runtime the caller passes (``runtime=``).

Every name of the JAX package's ``__all__`` is here, under its own name or
under the port's: ``TorchPolicy`` for ``JaxPolicy``, and for the
on-device envs ``DeviceEnv``, ``cartpole``, ``atari_sim`` and ``ENVS``
for ``JaxEnv``, ``jax_cartpole``, ``jax_atari_sim`` and ``JAX_ENVS``.
"""

from .a2c import A2C, A2CConfig
from .algorithm import Algorithm, AlgorithmConfig, WorkerSet
from .apex import ApexConfig, ApexDQN
from .appo import APPO, APPOConfig
from .bandit import BanditEnv, LinTS, LinUCB, run_bandit
from .catalog import MODEL_DEFAULTS, get_network, register_custom_model
from .connectors import (ActionConnector, ActionConnectorPipeline,
                         AgentConnector, AgentConnectorPipeline,
                         ConnectorContext, create_connectors_for_policy,
                         register_connector, restore_connectors_for_policy)
from .cql import CQL, CQLConfig
from .dqn import DQN, DQNConfig
from .env import (AtariSim, FastCartPole, FastPendulum, GymVectorEnv,
                  VectorEnv, make_env)
from .es import ARS, ARSConfig, ES, ESConfig, SharedNoiseTable
from .external import (ExternalDQNWorker, ExternalEnv, ExternalEnvWorker,
                       PolicyClient, PolicyServerInput)
from .impala import Impala, ImpalaConfig, vtrace
from .marwil import BC, BCConfig, MARWIL, MARWILConfig
from .multi_agent import MultiAgentEnv, make_multi_agent, sample_multi_agent
from .offline import (DirectMethod, DoublyRobust, ImportanceSampling,
                      JsonReader, JsonWriter, WeightedImportanceSampling)
from .ondevice import ENVS, DeviceEnv, OnDevicePPO, atari_sim, cartpole
from .policy import Network, TorchPolicy, make_network
from .ppo import PPO, PPOConfig
from .replay_buffers import (MultiAgentReplayBuffer, PrioritizedReplayBuffer,
                             ReplayBuffer, ReservoirReplayBuffer)
from .rollout_worker import RolloutWorker
from .sac import SAC, SACConfig
from .sample_batch import SampleBatch, compute_gae
from .td3 import TD3, TD3Config

__all__ = [
    "A2C", "A2CConfig", "APPO", "APPOConfig", "ARS", "ARSConfig",
    "ActionConnector", "ActionConnectorPipeline", "AgentConnector",
    "AgentConnectorPipeline", "Algorithm", "AlgorithmConfig", "ApexConfig",
    "ApexDQN", "AtariSim", "BC", "BCConfig", "BanditEnv", "CQL",
    "CQLConfig", "ConnectorContext", "DQN", "DQNConfig", "DeviceEnv",
    "DirectMethod", "DoublyRobust", "ENVS", "ES", "ESConfig",
    "ExternalDQNWorker", "ExternalEnv", "ExternalEnvWorker", "FastCartPole",
    "FastPendulum", "GymVectorEnv", "Impala", "ImpalaConfig",
    "ImportanceSampling", "JsonReader", "JsonWriter", "LinTS", "LinUCB",
    "MARWIL", "MARWILConfig", "MODEL_DEFAULTS", "MultiAgentEnv",
    "MultiAgentReplayBuffer", "Network", "OnDevicePPO", "PPO", "PPOConfig",
    "PolicyClient", "PolicyServerInput", "PrioritizedReplayBuffer",
    "ReplayBuffer", "ReservoirReplayBuffer", "RolloutWorker", "SAC",
    "SACConfig", "SampleBatch", "SharedNoiseTable", "TD3", "TD3Config",
    "TorchPolicy", "VectorEnv", "WeightedImportanceSampling", "WorkerSet",
    "atari_sim", "cartpole", "compute_gae", "create_connectors_for_policy",
    "get_network", "make_env", "make_multi_agent", "make_network",
    "register_connector", "register_custom_model",
    "restore_connectors_for_policy", "run_bandit", "sample_multi_agent",
    "vtrace",
]
