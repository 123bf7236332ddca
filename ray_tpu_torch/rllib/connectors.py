"""A copy of the JAX package's ``rllib/connectors.py`` (numpy only),
kept here because the port imports nothing of that package. Its
docstring:

Connectors: composable env<->policy transformation pipelines.

Reference analog: ``rllib/connectors/connector.py`` (Connector,
ConnectorContext, ConnectorPipeline), ``connectors/agent/*`` (obs
preprocessing, reward clipping, state buffering, lambdas) and
``connectors/action/*`` (clip, normalize, immutable, lambdas).

Re-founded for the vectorized-rollout design of this framework: the
reference transforms *lists of per-agent items* (AgentConnectorDataType)
in Python loops; here a connector transforms the **whole [N, ...] batch**
of a vector env in one numpy op, which is what keeps the rollout loop off
the per-step Python floor and hands contiguous arrays to the jitted
policy. Connectors are serializable (``to_state``/``from_state``) so a
policy restored from a checkpoint — or served behind the policy server —
reconstructs the exact preprocessing it trained with, which is the whole
point of the reference's connector redesign (bring-your-own-env serving).

Stateful connectors (frame stacking, running obs normalization) key their
state on the env slot dimension and reset slots on episode ends via
``on_episode_done(mask)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Registry (reference: register_connector / get_connector in connector.py,
# backed by the tune registry; plain dict here).
# ---------------------------------------------------------------------------

_CONNECTOR_REGISTRY: Dict[str, type] = {}


def register_connector(name: str, cls: type) -> None:
    """Register a connector class for name-based (de)serialization."""
    _CONNECTOR_REGISTRY[name] = cls


def get_connector(name: str, ctx: "ConnectorContext",
                  params: Any) -> "Connector":
    """Rebuild a connector from its serialized (name, params) state."""
    if name not in _CONNECTOR_REGISTRY:
        raise KeyError(
            f"Unknown connector {name!r}; registered: "
            f"{sorted(_CONNECTOR_REGISTRY)}")
    return _CONNECTOR_REGISTRY[name].from_state(ctx, params)


class ConnectorContext:
    """Env/policy facts a connector may need (reference:
    ConnectorContext, connector.py:27)."""

    def __init__(self, obs_shape: Optional[Tuple[int, ...]] = None,
                 num_actions: int = 0,
                 action_low: Optional[np.ndarray] = None,
                 action_high: Optional[np.ndarray] = None,
                 num_envs: int = 1,
                 config: Optional[Dict] = None):
        self.obs_shape = tuple(obs_shape) if obs_shape else None
        self.num_actions = num_actions
        self.action_low = action_low
        self.action_high = action_high
        self.num_envs = num_envs
        self.config = config or {}

    @staticmethod
    def from_env(env, config: Optional[Dict] = None) -> "ConnectorContext":
        return ConnectorContext(
            obs_shape=getattr(env, "observation_space_shape", None),
            num_actions=getattr(env, "num_actions", 0),
            action_low=getattr(env, "action_low", None),
            action_high=getattr(env, "action_high", None),
            num_envs=getattr(env, "num_envs", 1),
            config=config,
        )


class Connector:
    """Base: a named, serializable transformation step."""

    name = "Connector"

    def __init__(self, ctx: ConnectorContext):
        self._ctx = ctx
        self._is_training = True

    def in_training(self) -> None:
        self._is_training = True

    def in_eval(self) -> None:
        self._is_training = False

    # -- serialization ------------------------------------------------------
    def to_state(self) -> Tuple[str, Any]:
        """(name, json-able params). Stateless default."""
        return (self.name, None)

    @classmethod
    def from_state(cls, ctx: ConnectorContext, params: Any) -> "Connector":
        return cls(ctx)

    def __str__(self, indent: int = 0) -> str:
        return " " * indent + type(self).__name__


# ---------------------------------------------------------------------------
# Agent connectors: env data -> policy input
# ---------------------------------------------------------------------------


class AgentConnector(Connector):
    """Transforms the batched observation [N, ...] before the policy
    sees it (reference: AgentConnector, connector.py:137)."""

    #: True when the connector keys state on the batch's slot dimension
    #: (e.g. frame stacking). Such connectors require a stable vector-env
    #: slot layout and cannot serve flat interleaved-episode batches
    #: (external envs reject them).
    slot_stateful = False

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        return self.transform(obs)

    def transform(self, obs: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform_reward(self, rewards: np.ndarray) -> np.ndarray:
        """Hook for reward-shaping connectors (identity default)."""
        return rewards

    def on_episode_done(self, done_mask: np.ndarray) -> None:
        """Reset per-slot state for finished sub-envs."""

    def reset(self) -> None:
        """Reset all state (new rollout worker / eval run)."""


class FlattenObsConnector(AgentConnector):
    """Flatten [N, ...] observations to [N, D] vectors.

    Reference: connectors/agent/obs_preproc.py (ObsPreprocessorConnector
    wrapping the catalog's flatten preprocessor)."""

    name = "FlattenObs"

    def transform(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs)
        return obs.reshape(obs.shape[0], -1)


class ClipRewardConnector(AgentConnector):
    """sign() or [-limit, limit] reward clipping.

    Reference: connectors/agent/clip_reward.py."""

    name = "ClipReward"

    def __init__(self, ctx: ConnectorContext, sign: bool = False,
                 limit: Optional[float] = None):
        super().__init__(ctx)
        self.sign = sign
        self.limit = limit

    def transform(self, obs):
        return obs

    def transform_reward(self, rewards: np.ndarray) -> np.ndarray:
        if self.sign:
            return np.sign(rewards).astype(np.float32)
        if self.limit is not None:
            return np.clip(rewards, -self.limit, self.limit)
        return rewards

    def to_state(self):
        return (self.name, {"sign": self.sign, "limit": self.limit})

    @classmethod
    def from_state(cls, ctx, params):
        return cls(ctx, **(params or {}))


class FrameStackConnector(AgentConnector):
    """Stack the last k observations along the final axis.

    The rolling buffer lives here (per env slot); finished slots refill
    with the reset frame so episodes never see cross-episode frames.
    Vector-obs envs get [N, D*k]; image envs [N, H, W, C*k]."""

    name = "FrameStack"
    slot_stateful = True

    def __init__(self, ctx: ConnectorContext, k: int = 4):
        super().__init__(ctx)
        self.k = int(k)
        self._buf: Optional[np.ndarray] = None  # [N, ..., C*k]
        self._reset_mask: Optional[np.ndarray] = None

    def transform(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs)
        if self._buf is None or self._buf.shape[0] != obs.shape[0]:
            self._buf = np.concatenate([obs] * self.k, axis=-1)
        else:
            c = obs.shape[-1]
            self._buf = np.concatenate([self._buf[..., c:], obs], axis=-1)
            if self._reset_mask is not None and np.any(self._reset_mask):
                # Done slots received a fresh reset obs this step: their
                # history must be k copies of it, not the dead episode's
                # trailing frames.
                m = self._reset_mask
                self._buf[m] = np.concatenate([obs[m]] * self.k, axis=-1)
        self._reset_mask = None
        return self._buf

    def on_episode_done(self, done_mask: np.ndarray) -> None:
        self._reset_mask = np.asarray(done_mask, bool)

    def reset(self) -> None:
        self._buf = None
        self._reset_mask = None

    def to_state(self):
        return (self.name, {"k": self.k})

    @classmethod
    def from_state(cls, ctx, params):
        return cls(ctx, **(params or {}))


class MeanStdObsConnector(AgentConnector):
    """Running mean/std observation normalization (Welford), frozen in
    eval mode.

    Reference: the MeanStdFilter observation filter
    (``rllib/utils/filter.py``) that ``config.observation_filter=
    "MeanStdFilter"`` installs — recast as a connector so the statistics
    serialize with the policy (the reference syncs filters separately
    through FilterManager)."""

    name = "MeanStdObs"

    def __init__(self, ctx: ConnectorContext, eps: float = 1e-8,
                 clip: float = 10.0):
        super().__init__(ctx)
        self.eps = eps
        self.clip = clip
        self.count = 0.0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None

    def transform(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        flat = obs.reshape(obs.shape[0], -1)
        if self.mean is None:
            self.mean = np.zeros(flat.shape[1], np.float64)
            self.m2 = np.zeros(flat.shape[1], np.float64)
        if self._is_training:
            # Chan parallel update with the batch as one group.
            bmean = flat.mean(axis=0)
            bm2 = ((flat - bmean) ** 2).sum(axis=0)
            n, bn = self.count, float(flat.shape[0])
            delta = bmean - self.mean
            tot = n + bn
            self.mean = self.mean + delta * (bn / tot)
            self.m2 = self.m2 + bm2 + delta ** 2 * (n * bn / tot)
            self.count = tot
        if self.count < 2:
            return obs
        std = np.sqrt(self.m2 / max(self.count - 1, 1.0)) + self.eps
        out = (flat - self.mean) / std
        return np.clip(out, -self.clip, self.clip).astype(
            np.float32).reshape(obs.shape)

    def to_state(self):
        return (self.name, {
            "eps": self.eps, "clip": self.clip, "count": self.count,
            "mean": None if self.mean is None else self.mean.tolist(),
            "m2": None if self.m2 is None else self.m2.tolist(),
        })

    @classmethod
    def from_state(cls, ctx, params):
        params = dict(params or {})
        count = params.pop("count", 0.0)
        mean = params.pop("mean", None)
        m2 = params.pop("m2", None)
        conn = cls(ctx, **params)
        conn.count = count
        conn.mean = None if mean is None else np.asarray(mean, np.float64)
        conn.m2 = None if m2 is None else np.asarray(m2, np.float64)
        return conn


class LambdaAgentConnector(AgentConnector):
    """Adapt a stateless fn into an agent connector (reference:
    register_lambda_agent_connector, connectors/agent/lambdas.py).
    Not serializable by name unless registered with a factory."""

    name = "LambdaAgent"

    def __init__(self, ctx: ConnectorContext,
                 fn: Callable[[np.ndarray], np.ndarray]):
        super().__init__(ctx)
        self.fn = fn

    def transform(self, obs):
        return self.fn(obs)

    def to_state(self):
        raise TypeError("LambdaAgentConnector is not serializable; "
                        "subclass AgentConnector and register it instead")


# ---------------------------------------------------------------------------
# Action connectors: policy output -> env actions
# ---------------------------------------------------------------------------


class ActionConnector(Connector):
    """Transforms the batched action array before env.step
    (reference: ActionConnector, connector.py:282)."""

    def __call__(self, actions: np.ndarray) -> np.ndarray:
        return self.transform(actions)

    def transform(self, actions: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class ClipActionConnector(ActionConnector):
    """Clip continuous actions to the env's bounds
    (reference: connectors/action/clip.py)."""

    name = "ClipAction"

    def transform(self, actions: np.ndarray) -> np.ndarray:
        lo, hi = self._ctx.action_low, self._ctx.action_high
        if lo is None or hi is None:
            return actions
        return np.clip(actions, lo, hi)


class NormalizeActionConnector(ActionConnector):
    """Map squashed [-1, 1] policy outputs to the env's [low, high]
    (reference: connectors/action/normalize.py / unsquash_action)."""

    name = "NormalizeAction"

    def transform(self, actions: np.ndarray) -> np.ndarray:
        lo, hi = self._ctx.action_low, self._ctx.action_high
        if lo is None or hi is None:
            return actions
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        return lo + (np.clip(actions, -1.0, 1.0) + 1.0) * 0.5 * (hi - lo)


class ImmutableActionConnector(ActionConnector):
    """Hand the env a write-protected copy so in-place env mutation can't
    corrupt the training batch (reference: connectors/action/immutable.py)."""

    name = "ImmutableAction"

    def transform(self, actions: np.ndarray) -> np.ndarray:
        out = np.array(actions, copy=True)
        out.setflags(write=False)
        return out


class LambdaActionConnector(ActionConnector):
    name = "LambdaAction"

    def __init__(self, ctx: ConnectorContext,
                 fn: Callable[[np.ndarray], np.ndarray]):
        super().__init__(ctx)
        self.fn = fn

    def transform(self, actions):
        return self.fn(actions)

    def to_state(self):
        raise TypeError("LambdaActionConnector is not serializable")


# ---------------------------------------------------------------------------
# Pipelines
# ---------------------------------------------------------------------------


class ConnectorPipeline:
    """Ordered connector chain with insert/remove by name
    (reference: ConnectorPipeline, connector.py:337)."""

    def __init__(self, ctx: ConnectorContext,
                 connectors: Sequence[Connector] = ()):
        self._ctx = ctx
        self.connectors: List[Connector] = list(connectors)

    def in_training(self):
        for c in self.connectors:
            c.in_training()

    def in_eval(self):
        for c in self.connectors:
            c.in_eval()

    def remove(self, name: str) -> None:
        self.connectors = [c for c in self.connectors
                           if type(c).__name__ != name and c.name != name]

    def insert_before(self, name: str, connector: Connector) -> None:
        idx = self._index(name)
        self.connectors.insert(idx, connector)

    def insert_after(self, name: str, connector: Connector) -> None:
        idx = self._index(name)
        self.connectors.insert(idx + 1, connector)

    def prepend(self, connector: Connector) -> None:
        self.connectors.insert(0, connector)

    def append(self, connector: Connector) -> None:
        self.connectors.append(connector)

    def _index(self, name: str) -> int:
        for i, c in enumerate(self.connectors):
            if type(c).__name__ == name or c.name == name:
                return i
        raise ValueError(f"No connector named {name!r} in pipeline")

    def to_state(self) -> List[Tuple[str, Any]]:
        return [c.to_state() for c in self.connectors]

    def __str__(self, indent: int = 0) -> str:
        lines = [" " * indent + type(self).__name__]
        lines += [c.__str__(indent + 4) for c in self.connectors]
        return "\n".join(lines)


class AgentConnectorPipeline(ConnectorPipeline):
    def __call__(self, obs: np.ndarray) -> np.ndarray:
        for c in self.connectors:
            obs = c(obs)
        return obs

    def transform_reward(self, rewards: np.ndarray) -> np.ndarray:
        for c in self.connectors:
            rewards = c.transform_reward(rewards)
        return rewards

    def on_episode_done(self, done_mask: np.ndarray) -> None:
        for c in self.connectors:
            c.on_episode_done(done_mask)

    def reset(self) -> None:
        for c in self.connectors:
            c.reset()

    @staticmethod
    def from_state(ctx: ConnectorContext,
                   state: List[Tuple[str, Any]]) -> "AgentConnectorPipeline":
        return AgentConnectorPipeline(
            ctx, [get_connector(name, ctx, params)
                  for name, params in state])


class ActionConnectorPipeline(ConnectorPipeline):
    def __call__(self, actions: np.ndarray) -> np.ndarray:
        for c in self.connectors:
            actions = c(actions)
        return actions

    @staticmethod
    def from_state(ctx: ConnectorContext,
                   state: List[Tuple[str, Any]]) -> "ActionConnectorPipeline":
        return ActionConnectorPipeline(
            ctx, [get_connector(name, ctx, params)
                  for name, params in state])


# ---------------------------------------------------------------------------
# Spec-driven construction (what algorithm configs carry)
# ---------------------------------------------------------------------------

#: connectors config spec:
#:   {"agent": [("FrameStack", {"k": 4}), "MeanStdObs"],
#:    "action": ["NormalizeAction", "ClipAction", "ImmutableAction"]}


def _build(ctx: ConnectorContext, spec: Sequence) -> List[Connector]:
    out = []
    for item in spec:
        if isinstance(item, Connector):
            out.append(item)
            continue
        if isinstance(item, str):
            name, params = item, None
        else:
            name, params = item
        out.append(get_connector(name, ctx, params))
    return out


def create_connectors_for_policy(
        ctx: ConnectorContext, spec: Optional[Dict] = None,
) -> Tuple[AgentConnectorPipeline, ActionConnectorPipeline]:
    """Build (agent_pipeline, action_pipeline) from a config spec
    (reference: create_connectors_for_policy, connectors/util.py)."""
    spec = spec or {}
    agent = AgentConnectorPipeline(ctx, _build(ctx, spec.get("agent", ())))
    action = ActionConnectorPipeline(
        ctx, _build(ctx, spec.get("action", ())))
    return agent, action


def restore_connectors_for_policy(
        ctx: ConnectorContext, state: Dict,
) -> Tuple[AgentConnectorPipeline, ActionConnectorPipeline]:
    """Rebuild pipelines from ``{"agent": [...], "action": [...]}`` state
    (reference: restore_connectors_for_policy, connectors/util.py)."""
    return (AgentConnectorPipeline.from_state(ctx, state.get("agent", [])),
            ActionConnectorPipeline.from_state(ctx,
                                               state.get("action", [])))


for _cls in (FlattenObsConnector, ClipRewardConnector, FrameStackConnector,
             MeanStdObsConnector, ClipActionConnector,
             NormalizeActionConnector, ImmutableActionConnector):
    register_connector(_cls.name, _cls)
