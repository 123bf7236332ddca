"""Request plane hosting a :class:`SlotEngine`: counterpart of the JAX
package's ``llm/serve.py`` (``LLMServer``).

Request schema (a dict, the POST body's JSON):

    {"prompt": [token ids...], "max_tokens": 64, "temperature": 0.0,
     "eos_id": null, "stream": false, "seed": null, "session": null}

Responses: ``{"tokens": [...], "finish_reason": ..., "prompt_len": N,
"timing": {...}}`` (``timing`` is the engine's per-request stage
breakdown), or, with ``stream: true``, an async iterator of token ids.

``tp > 1`` shards the engine over a tp mesh of the initialised process
group (one process a rank, as ``parallel.bootstrap`` starts them): every
rank constructs the server, rank 0 answers requests and the others run
the engine's follower loop.

``checkpoint_path`` is a directory of ``train.checkpoint.save_arrays``
(``arrays.pkl``: the JAX package's Llama pytree as numpy, which either
package writes). ``build_llm_app`` wraps the server in a Serve module the
caller passes (``serve=``; ``ray_tpu.serve`` is one).

Telemetry goes to the observability module the caller passes
(``observability=``, the port's own by default; ``ray_tpu.observability``
behind ``ray_tpu.serve``, whose replica binds each request's trace context
in that module and whose exporter ships that module's registry): each
request hands the engine the context bound to its task, so the engine's
``llm.*`` spans join the request's trace.
"""

from __future__ import annotations

import asyncio
from typing import Mapping, Optional

import torch

from ..device import default_device
from ..models import llama
from ..models.convert import llama_params_from_numpy
from .engine import SlotEngine


def _build_params(model: str, seed: int,
                  checkpoint_path: Optional[str] = None,
                  params: Optional[Mapping] = None, device=None):
    """The served ``Llama``, in ``cfg.dtype``: random weights drawn from a
    ``torch.Generator`` seeded with ``seed`` on the device (other numbers
    than the JAX package's ``init_params(PRNGKey(seed))``: the generators
    differ), or ``params``: a state dict of the module, or the JAX
    package's pytree with numpy leaves, or the pytree restored from
    ``checkpoint_path``."""
    if checkpoint_path:
        from ..train.checkpoint import restore_arrays

        params = restore_arrays(checkpoint_path)
    cfg = llama.CONFIGS[model]
    dev = default_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        m = llama.Llama(cfg, gen, dev)
    else:
        m = llama.Llama(cfg, device=dev)
        if isinstance(params.get("blocks"), Mapping):
            params = llama_params_from_numpy(params, cfg)
        m.load_state_dict(params)
    return m.to(cfg.dtype).requires_grad_(False), cfg


def _tp_mesh(tp: int, device):
    """(this rank's device, ``MeshSpec(tp=tp)``'s mesh) over the
    initialised process group, which must have tp ranks; on the card each
    rank takes the card of its rank, and there must be tp of them."""
    import torch.distributed as dist

    from ..parallel.mesh import MeshSpec

    ranks = dist.get_world_size() if dist.is_initialized() else 1
    if ranks < tp:
        raise ValueError(f"tp={tp} needs {tp} ranks, have {ranks} (an "
                         "initialised process group of tp processes)")
    dev = default_device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() < tp:
            raise ValueError(f"tp={tp} needs {tp} devices, have "
                             f"{torch.cuda.device_count()}")
        dev = torch.device("cuda", dist.get_rank())
        torch.cuda.set_device(dev)
    return dev, MeshSpec(tp=tp).build(dev.type)


class LLMServer:
    """One engine per server, asyncio request plane: the engine thread
    drives the card; handlers only bridge tokens into the caller's event
    loop."""

    def __init__(self, model: str = "llama-tiny", num_slots: int = 8,
                 chunk: int = 64, seed: int = 0,
                 checkpoint_path: Optional[str] = None,
                 default_max_tokens: int = 64,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 max_pending: Optional[int] = 256,
                 queue_timeout_s: Optional[float] = 30.0,
                 decode_block: int = 1, tp: int = 1,
                 params: Optional[Mapping] = None, device=None,
                 observability=None):
        mesh = None
        if tp > 1:
            device, mesh = _tp_mesh(tp, device)
        module, _ = _build_params(model, seed, checkpoint_path, params,
                                  device)
        self.default_max_tokens = default_max_tokens
        # Admission control: the pending queue is bounded (max_pending)
        # and queued requests expire after queue_timeout_s, both as a
        # typed OverloadedError.
        self.engine = SlotEngine(module, num_slots=num_slots, chunk=chunk,
                                 seed=seed, page_size=page_size,
                                 num_pages=num_pages,
                                 prefix_cache=prefix_cache,
                                 max_pending=max_pending,
                                 queue_timeout_s=queue_timeout_s,
                                 decode_block=decode_block,
                                 mesh=mesh, device=module.wte.device,
                                 observability=observability)
        if self.engine.is_leader:
            self.engine.warmup()
        self.engine.start()
        self._recoveries: list = []  # crash-path restore latencies (ms)

    def __del__(self):
        try:
            self.engine.stop()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    async def __call__(self, payload):
        self.engine._leader_only("a request")
        if not isinstance(payload, dict) or "prompt" not in payload:
            return {"error": "body must be JSON with a 'prompt' "
                             "token-id list"}
        max_tokens = int(payload.get("max_tokens", self.default_max_tokens))
        eos_id = payload.get("eos_id")
        # A client-pinned seed makes a retry on another server replay the
        # same fold_in sampling stream, and so the same tokens.
        seed = payload.get("seed")
        session_id = payload.get("session")
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        handle = self.engine.submit(
            payload["prompt"], max_new=max_tokens,
            temperature=float(payload.get("temperature", 0.0)),
            eos_id=None if eos_id is None else int(eos_id),
            seed=None if seed is None else int(seed),
            session_id=None if session_id is None else str(session_id),
            on_token=lambda t: loop.call_soon_threadsafe(q.put_nowait, t),
            # The request's trace context, bound to this task by the
            # caller (a Serve replica): the engine thread's spans join it.
            trace_ctx=self.engine._obs.tracing.get_request_context())
        if payload.get("stream"):
            # Hold the response until the first token (or failure), so an
            # admission shed is raised here and not after a stream began.
            first = await q.get()
            if first is None and handle.error is not None:
                raise handle.error

            async def token_stream():
                tok = first
                while tok is not None:
                    yield tok
                    tok = await q.get()
                if handle.error is not None:
                    raise handle.error

            return token_stream()
        while await q.get() is not None:
            pass
        if handle.error is not None:
            raise handle.error
        res = handle.result(timeout=0)
        return {"tokens": res.tokens, "finish_reason": res.finish_reason,
                "prompt_len": res.prompt_len, "timing": res.timing}

    # -- stateful sessions -------------------------------------------------

    def sessions(self) -> list:
        """Resident session ids on this server's engine."""
        return self.engine.sessions()

    def export_sessions(self, session_ids=None) -> list:
        """Snapshot sessions for migration; skips ids with a generation in
        flight (those recover through ``restore_session``)."""
        out = []
        for sid in session_ids or self.engine.sessions():
            try:
                out.append(self.engine.export_session(sid))
            except (KeyError, RuntimeError):
                continue
        return out

    def import_session(self, snapshot) -> dict:
        return self.engine.import_session(snapshot)

    def restore_session(self, session_id, transcript, seed=None,
                        temperature: float = 0.0) -> dict:
        """Crash-path recovery: re-prefill the transcript."""
        info = self.engine.prefill_session(session_id, transcript,
                                           seed=seed,
                                           temperature=temperature)
        self._recoveries.append(round(info["seconds"] * 1e3, 3))
        del self._recoveries[:-64]
        return info

    def stats(self) -> dict:
        return {
            "tokens_generated": self.engine.tokens_generated,
            "requests_completed": self.engine.requests_completed,
            "requests_shed": self.engine.requests_shed,
            "num_slots": self.engine.num_slots,
            "prefix_hits": self.engine.prefix_hits,
            "prefix_misses": self.engine.prefix_misses,
            "prefix_tokens_saved": self.engine.prefix_tokens_saved,
            "pages_used": self.engine.pages_used,
            "pages_free": self.engine.pages_free,
            "sessions_resident": self.engine.session_count,
            "session_recovery_ms": list(self._recoveries),
            "decode_profile": self.engine.decode_profile(),
        }


def build_llm_app(model: str = "llama-tiny", num_slots: int = 8,
                  chunk: int = 64, seed: int = 0,
                  checkpoint_path: Optional[str] = None,
                  name: str = "llm", page_size: int = 16,
                  num_pages: Optional[int] = None,
                  prefix_cache: bool = True,
                  max_pending: Optional[int] = 256,
                  queue_timeout_s: Optional[float] = 30.0,
                  decode_block: int = 1, tp: int = 1, *,
                  serve, device=None, observability=None, **deploy_opts):
    """A Serve application hosting the engine, for ``serve.run``.
    ``serve`` is the Serve module (``deployment``; ``ray_tpu.serve`` is
    one): the port imports no Serve runtime. ``device`` is the replica's
    (CUDA unless the caller asks for the CPU); ``observability`` the
    module its telemetry goes to (``ray_tpu.observability`` behind
    ``ray_tpu.serve``; the port's own when None)."""
    # Mirror the engine's admission knobs into the deployment config so
    # the router sheds at the same bound BEFORE a request crosses into
    # the replica (the engine's own bounded queue stays authoritative
    # for in-replica admission).
    deploy_opts.setdefault("max_pending", max_pending)
    deploy_opts.setdefault("queue_timeout_s", queue_timeout_s)
    dep = serve.deployment(LLMServer, name=name, **deploy_opts)
    return dep.bind(model=model, num_slots=num_slots, chunk=chunk,
                    seed=seed, checkpoint_path=checkpoint_path,
                    page_size=page_size, num_pages=num_pages,
                    prefix_cache=prefix_cache, max_pending=max_pending,
                    queue_timeout_s=queue_timeout_s,
                    decode_block=decode_block, tp=tp, device=device,
                    observability=observability)
