"""External envs and the policy server: counterpart of the JAX package's
``rllib/external.py``, on the port's rollout workers (``ExternalEnvWorker``
on ``RolloutWorker``, ``ExternalDQNWorker`` on ``DQNRolloutWorker``'s
Q policy): their policies run on the CPU, and a replay-based algorithm
plugs the worker in through ``_worker_cls``, its learner on the card. The
env side and the HTTP layer are a copy (numpy and the standard library);
the wire format is the JAX package's (length-delimited pickle over POST,
the same five commands), so a client of either package drives a server of
the other. The JAX module's docstring:

External environments: inverted-control envs + policy serving REST API.

Reference analogs:
- ``rllib/env/external_env.py:22`` — ``ExternalEnv``: the *environment*
  drives the loop and queries the policy (``start_episode`` /
  ``get_action`` / ``log_action`` / ``log_returns`` / ``end_episode``),
  instead of the algorithm calling ``env.step``.
- ``rllib/env/policy_server_input.py`` / ``policy_client.py`` — the same
  episode API over HTTP, so simulators living in another process (or
  another machine, behind a firewall) can drive training.

Design differences from the reference:
- The sampler batches *all* concurrently-waiting ``get_action`` requests
  into one policy call (the reference answers them one at a time
  through the sampler's queue) — external episodes get the same batched
  inference path as vector envs.
- Transitions are emitted flat ``(obs, action, reward, next_obs, done)``
  rows — the replay-based algorithms (DQN/SAC/TD3) consume them natively;
  this is the reference's primary external-env use case (serving +
  off-policy training).
- The HTTP layer uses length-delimited pickle over POST (the reference
  pickles over HTTP too); ``PolicyClient`` only supports remote inference
  (every ``get_action`` is a round trip). Local-inference mode with
  weight sync is a non-goal: the server owns the single policy.
"""

from __future__ import annotations

import pickle
import queue
import threading
import time
import uuid
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .rollout_worker import RolloutWorker
from .sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch


class _Episode:
    """Per-episode state: the obs->action handoff and the pending
    transition (reference: _ExternalEnvEpisode)."""

    def __init__(self, episode_id: str, training_enabled: bool = True):
        self.episode_id = episode_id
        self.training_enabled = training_enabled
        self.action_q: "queue.Queue" = queue.Queue(maxsize=1)
        self.prev_obs: Optional[np.ndarray] = None
        self.prev_action: Optional[Any] = None
        self.reward_accum = 0.0
        self.total_reward = 0.0


class ExternalEnv(threading.Thread):
    """Inverted-control environment.

    Subclass and override :meth:`run` with your loop::

        class MySim(ExternalEnv):
            def run(self):
                while True:
                    eid = self.start_episode()
                    obs = ...  # from your simulator
                    while not done:
                        action = self.get_action(eid, obs)
                        obs, reward, done = my_sim.step(action)
                        self.log_returns(eid, reward)
                    self.end_episode(eid, obs)

    Declare ``obs_shape`` / ``num_actions`` so the sampler can build the
    policy (the reference passes gym spaces; shapes stand in for them).
    """

    def __init__(self, obs_shape: Tuple[int, ...], num_actions: int,
                 max_concurrent: int = 100):
        super().__init__(daemon=True)
        self.observation_space_shape = tuple(obs_shape)
        self.num_actions = int(num_actions)
        self.num_envs = 1  # batch dim is dynamic (concurrent episodes)
        self._max_concurrent = max_concurrent
        self._episodes: Dict[str, _Episode] = {}
        # Recent finished ids only (duplicate-end detection): unbounded
        # retention would leak one uuid per episode in a server that
        # runs for days.
        self._finished: "OrderedDict[str, None]" = OrderedDict()
        self._finished_cap = 10_000
        self._lock = threading.Lock()
        # (episode, obs) pairs waiting for an on-policy action.
        self._pending: "queue.Queue" = queue.Queue()
        # Completed transition rows, drained by the sampler.
        self._transitions: List[Tuple] = []
        self._completed_returns: List[float] = []

    # -- episode API (called from the external thread) ---------------------

    def start_episode(self, episode_id: Optional[str] = None,
                      training_enabled: bool = True) -> str:
        if episode_id is None:
            episode_id = uuid.uuid4().hex
        with self._lock:
            if episode_id in self._finished:
                raise ValueError(f"episode {episode_id} already completed")
            if episode_id in self._episodes:
                raise ValueError(f"episode {episode_id} already started")
            if len(self._episodes) >= self._max_concurrent:
                raise RuntimeError(
                    f"{len(self._episodes)} concurrent episodes exceed "
                    f"max_concurrent={self._max_concurrent}")
            self._episodes[episode_id] = _Episode(episode_id,
                                                  training_enabled)
        return episode_id

    def get_action(self, episode_id: str, observation) -> Any:
        """Record ``observation`` and block for the on-policy action."""
        ep = self._get(episode_id)
        obs = np.asarray(observation)
        self._emit_step(ep, obs, done=False)
        self._pending.put((ep, obs))
        action = ep.action_q.get()
        ep.prev_obs, ep.prev_action = obs, action
        return action

    def log_action(self, episode_id: str, observation, action) -> None:
        """Record an off-policy (externally chosen) action."""
        ep = self._get(episode_id)
        obs = np.asarray(observation)
        self._emit_step(ep, obs, done=False)
        ep.prev_obs, ep.prev_action = obs, action

    def log_returns(self, episode_id: str, reward: float,
                    info: Optional[Dict] = None) -> None:
        ep = self._get(episode_id)
        ep.reward_accum += float(reward)
        ep.total_reward += float(reward)

    def end_episode(self, episode_id: str, observation) -> None:
        ep = self._get(episode_id)
        self._emit_step(ep, np.asarray(observation), done=True)
        with self._lock:
            self._finished[episode_id] = None
            while len(self._finished) > self._finished_cap:
                self._finished.popitem(last=False)
            self._episodes.pop(episode_id, None)
            self._completed_returns.append(ep.total_reward)

    # -- internals ---------------------------------------------------------

    def _get(self, episode_id: str) -> _Episode:
        with self._lock:
            if episode_id in self._finished:
                raise ValueError(f"episode {episode_id} already completed")
            if episode_id not in self._episodes:
                raise ValueError(f"episode {episode_id} not found")
            return self._episodes[episode_id]

    def _emit_step(self, ep: _Episode, obs: np.ndarray, done: bool) -> None:
        """Complete the pending (prev_obs, prev_action) transition now
        that its next_obs (and accumulated reward) are known."""
        if ep.prev_obs is None:
            return
        if ep.training_enabled:
            with self._lock:
                self._transitions.append(
                    (ep.prev_obs, ep.prev_action, ep.reward_accum, obs,
                     done))
        ep.reward_accum = 0.0
        if done:
            ep.prev_obs = ep.prev_action = None

    def run(self):  # pragma: no cover - subclass hook
        raise NotImplementedError


class ExternalEnvWorker(RolloutWorker):
    """Rollout worker servicing an :class:`ExternalEnv`.

    ``sample(n)`` pumps the env's pending action requests — batching every
    concurrently-waiting episode into ONE policy call — until ``n``
    transition rows accumulate, then returns them as a flat SampleBatch
    (DQN/SAC layout). Plugs into any replay-based Algorithm via
    ``_worker_cls``.
    """

    def __init__(self, env_spec: Any, num_envs: int = 1,
                 policy_config: Optional[Dict] = None, seed: int = 0,
                 worker_index: int = 0):
        from .connectors import ConnectorContext, \
            create_connectors_for_policy

        env = env_spec() if callable(env_spec) else env_spec
        if not isinstance(env, ExternalEnv):
            raise TypeError("ExternalEnvWorker needs an ExternalEnv "
                            "instance or factory")
        self.env = env
        cfg = policy_config or {}
        self._policy_cfg = cfg
        ctx = ConnectorContext.from_env(env, cfg)
        self.agent_connectors, self.action_connectors = \
            create_connectors_for_policy(ctx, cfg.get("connectors"))
        bad = [type(c).__name__ for c in self.agent_connectors.connectors
               if c.slot_stateful]
        if bad:
            raise ValueError(
                f"slot-stateful connectors {bad} cannot serve external "
                "envs: episodes interleave arbitrarily, so there is no "
                "stable slot layout to key per-slot state on. Apply "
                "frame stacking on the client side instead.")
        # Probe the TRANSFORMED obs shape with a throwaway pipeline so
        # the probe doesn't pollute running statistics (MeanStdObs).
        probe_agent, _ = create_connectors_for_policy(
            ctx, cfg.get("connectors"))
        probe = probe_agent(
            np.zeros((1,) + tuple(env.observation_space_shape),
                     np.float32))
        self._connected_obs_shape = tuple(probe.shape[1:])
        self.policy = self._make_policy(cfg, seed + worker_index)
        self._episode_rewards = np.zeros(1, np.float32)
        self._completed: List[float] = []
        self.worker_index = worker_index
        if not env.is_alive():
            env.start()

    def sample(self, rollout_length: int = 64,
               timeout_s: float = 30.0) -> SampleBatch:
        rows: List[Tuple] = []
        deadline = time.monotonic() + timeout_s
        env = self.env
        while len(rows) < rollout_length:
            if time.monotonic() > deadline:
                if rows:
                    break
                raise TimeoutError(
                    "external env produced no transitions within "
                    f"{timeout_s}s — is its run() loop alive?")
            # Drain every episode currently waiting on an action.
            waiting = []
            try:
                waiting.append(env._pending.get(timeout=0.05))
                while True:
                    waiting.append(env._pending.get_nowait())
            except queue.Empty:
                pass
            if waiting:
                obs = self.agent_connectors(
                    np.stack([o for _, o in waiting]))
                actions, _, _ = self.policy.compute_actions(obs)
                actions = self.action_connectors(actions)
                for (ep, _), a in zip(waiting, np.asarray(actions)):
                    ep.action_q.put(a.item() if a.shape == () else a)
            with env._lock:
                if env._transitions:
                    rows.extend(env._transitions)
                    env._transitions.clear()
                if env._completed_returns:
                    self._completed.extend(env._completed_returns)
                    env._completed_returns.clear()
        # Build the training batch in EVAL mode: the raw rows were each
        # already seen once at inference time (where running stats
        # update), so the batch pass must not count them again. The batch
        # obs are normalized with stats as-of-now rather than as-of-the-
        # action — the same mild skew the reference accepts when its
        # MeanStdFilter advances during sampling.
        self.agent_connectors.in_eval()
        try:
            obs = self.agent_connectors(
                np.stack([r[0] for r in rows]).astype(np.float32))
            next_obs = self.agent_connectors(
                np.stack([r[3] for r in rows]).astype(np.float32))
            rewards = self.agent_connectors.transform_reward(
                np.asarray([r[2] for r in rows], np.float32))
        finally:
            self.agent_connectors.in_training()
        return SampleBatch({
            OBS: obs,
            ACTIONS: np.asarray([r[1] for r in rows]),
            REWARDS: rewards,
            NEXT_OBS: next_obs,
            DONES: np.asarray([r[4] for r in rows], bool),
        })

    def episode_stats(self, clear: bool = True) -> Dict:
        with self.env._lock:
            self._completed.extend(self.env._completed_returns)
            self.env._completed_returns.clear()
        return super().episode_stats(clear)


class ExternalDQNWorker(ExternalEnvWorker):
    """External env paired with the DQN epsilon-greedy Q policy."""

    def _make_policy(self, cfg: Dict, seed: int):
        from .dqn import DQNRolloutWorker

        return DQNRolloutWorker._make_policy(self, cfg, seed)

    def set_epsilon(self, epsilon: float) -> None:
        self.policy.epsilon = float(epsilon)


# ---------------------------------------------------------------------------
# Policy server / client (reference: policy_server_input.py, policy_client.py)
# ---------------------------------------------------------------------------

_COMMANDS = ("START_EPISODE", "GET_ACTION", "LOG_ACTION", "LOG_RETURNS",
             "END_EPISODE")


class PolicyServerInput(ExternalEnv):
    """An ExternalEnv driven by HTTP clients instead of a local run loop.

    Start it as the env of an :class:`ExternalEnvWorker`-based algorithm;
    point any number of :class:`PolicyClient` processes at
    ``http://host:port``. Reference: ``PolicyServerInput``
    (policy_server_input.py:29) — same command protocol, minus the
    local-inference weight sync.

    .. warning:: Requests are **unpickled** (as in the reference), which
       is remote code execution for anyone who can reach the port. Bind
       to localhost (the default) or a trusted network only — never
       expose this port publicly.
    """

    def __init__(self, obs_shape: Tuple[int, ...], num_actions: int,
                 host: str = "127.0.0.1", port: int = 0,
                 max_concurrent: int = 100):
        super().__init__(obs_shape, num_actions, max_concurrent)
        env = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                try:
                    req = pickle.loads(body)
                    out = env._handle(req)
                    payload = pickle.dumps({"ok": True, "result": out})
                    code = 200
                except Exception as e:  # noqa: BLE001 - ship to client
                    payload = pickle.dumps({"ok": False,
                                            "error": repr(e)})
                    code = 500
                self.send_response(code)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.address = (f"http://{self._httpd.server_address[0]}:"
                        f"{self._httpd.server_address[1]}")

    def _handle(self, req: Dict) -> Any:
        cmd = req["command"]
        if cmd == "START_EPISODE":
            return self.start_episode(req.get("episode_id"),
                                      req.get("training_enabled", True))
        if cmd == "GET_ACTION":
            return self.get_action(req["episode_id"], req["observation"])
        if cmd == "LOG_ACTION":
            return self.log_action(req["episode_id"], req["observation"],
                                   req["action"])
        if cmd == "LOG_RETURNS":
            return self.log_returns(req["episode_id"], req["reward"],
                                    req.get("info"))
        if cmd == "END_EPISODE":
            return self.end_episode(req["episode_id"], req["observation"])
        raise ValueError(f"unknown command {cmd!r} "
                         f"(expected one of {_COMMANDS})")

    def run(self):
        self._httpd.serve_forever(poll_interval=0.1)

    def shutdown(self):
        self._httpd.shutdown()
        self._httpd.server_close()


class PolicyClient:
    """Client-side episode API over HTTP (reference: PolicyClient,
    policy_client.py:59, remote inference mode)."""

    def __init__(self, address: str, timeout_s: float = 30.0):
        self.address = address.rstrip("/")
        self.timeout_s = timeout_s

    def _send(self, **req) -> Any:
        import urllib.error
        import urllib.request

        data = pickle.dumps(req)
        http_req = urllib.request.Request(
            self.address, data=data,
            headers={"Content-Type": "application/octet-stream"})
        try:
            with urllib.request.urlopen(http_req,
                                        timeout=self.timeout_s) as resp:
                out = pickle.loads(resp.read())
        except urllib.error.HTTPError as e:
            out = pickle.loads(e.read())
        if not out.get("ok"):
            raise RuntimeError(f"policy server error: {out.get('error')}")
        return out.get("result")

    def start_episode(self, episode_id: Optional[str] = None,
                      training_enabled: bool = True) -> str:
        return self._send(command="START_EPISODE", episode_id=episode_id,
                          training_enabled=training_enabled)

    def get_action(self, episode_id: str, observation) -> Any:
        return self._send(command="GET_ACTION", episode_id=episode_id,
                          observation=np.asarray(observation))

    def log_action(self, episode_id: str, observation, action) -> None:
        self._send(command="LOG_ACTION", episode_id=episode_id,
                   observation=np.asarray(observation), action=action)

    def log_returns(self, episode_id: str, reward: float,
                    info: Optional[Dict] = None) -> None:
        self._send(command="LOG_RETURNS", episode_id=episode_id,
                   reward=float(reward), info=info)

    def end_episode(self, episode_id: str, observation) -> None:
        self._send(command="END_EPISODE", episode_id=episode_id,
                   observation=np.asarray(observation))
