"""Continuous-batching engine over a PAGED KV cache with a radix prefix
cache: counterpart of the JAX package's ``llm/engine.py``.

- The KV cache is a pool of fixed-size pages (``llama.init_paged_kv_cache``)
  reached through a per-slot page table. A request whose prompt prefix is
  resident borrows those pages read-only (refcounted) and starts prefill at
  the matched length; a prefix dying mid-page is copied on write into a
  fresh page at admission. Freed pages return to an LRU free-list; full
  prompt pages are filed in a radix index keyed on page-size token chunks.
- One dispatch is a block of K decode steps for every slot, with one
  prompt chunk of one slot fused into the first step
  (``decode_slots_with_prefill_paged``): the chunk rides the same weight
  reads as the decode batch. Sampled tokens chain from step to step on the
  device; idle slots are parked at ``max_seq``, where their writes go to
  the scratch page. On the card each kind of block (with the prompt
  chunk or decode only) is captured once as a CUDA graph and replayed, as
  the JAX engine compiles each into one program: launched op by op, a
  llama-1b block is bound by the host's launch rate. On the CPU it runs
  eagerly.
- Sampling is deterministic per request: token q of a request is drawn
  with ``fold_in(PRNGKey(request_seed), q)`` (``sampling.sample``, the
  JAX package's draw bit for bit), so a prefix-hit admission produces the
  same tokens as a cold one.
- Lag-1 pipeline: after dispatching block N the host fetches block N-1's
  tokens. Each block's tokens are copied without blocking into pinned host
  memory behind a CUDA event, and the fetch waits on that block's event
  only, so the block just dispatched keeps the card busy meanwhile.

Where JAX donates the cache to a jitted program, the port updates one
preallocated cache tensor in place, on the engine's device and stream
(every ``step()`` enters both, from whichever thread runs it).

tp-sharded serving (``mesh``, ``rules``): the parameters are placed by
their logical axes (``Llama.logical_axes()``) under ``SERVE_RULES``, and
each rank's page pool holds its Hkv/tp heads; the paged functions run on
each rank's shards with sums and gathers over tp (``models/llama.py``).
The JAX engine is one program over every chip; here every rank is a
process. Rank 0 alone schedules: it holds the request plane, the radix
index, the sessions and the clock, and at every operation that touches
the cache (a block, a copy-on-write page copy, a session's page writes or
page gather) it broadcasts that operation's host inputs over the tp
group; the other ranks replay them in the same order (``follow``, or the
thread ``start()`` runs on them) until rank 0's engine stops. Tokens are
fetched on rank 0 only. Under tp > 1 a block runs eagerly, never as a
CUDA graph: a gloo exchange stages through host memory and cannot sit
inside a capture (a graph-captured NCCL path is a later ROADMAP item).

Telemetry, at the JAX engine's points of a request's life: the
``rt_llm_*`` family (``paged.llm_metrics``: prefix hits and tokens saved
at admission, page gauges, TTFT and the token counter at delivery, the
stage and decode-per-token histograms at finish, sessions, migrations and
recoveries, the roofline gauges of measured windows) and, for a request
that carries a trace context, ``llm.request`` with its stage spans laid
out from the request's ``timing``. Both go to the observability module
the caller passes (``observability=``; the port's own by default), and
under tp only rank 0 emits: it alone admits and delivers.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import observability as default_observability
from ..core.config import config
from ..core.exceptions import EngineStoppedError
from ..device import default_device
from ..models import llama
from ..models.convert import tensor_from_numpy, tensor_to_numpy
from ..parallel import sharding as shd
from ..parallel.collective import all_gather
from . import sampling
from .paged import OverloadedError, PagePool, RadixIndex, llm_metrics

_LLM_STAGE_KEYS = {s: (("stage", s),) for s in
                   ("admission", "queue", "prefix_match", "prefill",
                    "decode")}


@dataclass
class GenerationResult:
    tokens: List[int]
    prompt_len: int
    finish_reason: str  # "stop" (eos) | "length"
    # Stage breakdown (seconds): admission_s, queue_s, prefix_match_s,
    # prefill_s, decode_s, decode_per_token_s, total_s, matched_tokens,
    # produced_tokens. None when the request errored before finishing.
    timing: Optional[dict] = None


class RequestHandle:
    """Thread-safe consumer side of one generation request.

    Iterating yields token ids as they are produced; ``result()`` blocks
    for the final :class:`GenerationResult`. ``on_token`` (if given at
    submit) is called from the engine thread instead, to bridge into an
    asyncio loop without a queue hop.
    """

    def __init__(self, prompt_len: int):
        self._q: "queue.Queue" = queue.Queue()
        self._tokens: List[int] = []
        self._prompt_len = prompt_len
        self._done = threading.Event()
        self._finish_reason = "length"
        self.error: Optional[BaseException] = None
        self.timing: Optional[dict] = None  # set by the engine at finish

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                if self.error is not None:
                    raise self.error
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> GenerationResult:
        if not self._done.wait(timeout):
            raise TimeoutError("generation did not finish in time")
        if self.error is not None:
            raise self.error
        return GenerationResult(tokens=list(self._tokens),
                                prompt_len=self._prompt_len,
                                finish_reason=self._finish_reason,
                                timing=self.timing)

    # engine-side
    def _emit(self, tok: int) -> None:
        self._tokens.append(tok)
        self._q.put(tok)

    def _finish(self, reason: str,
                error: Optional[BaseException] = None) -> None:
        self._finish_reason = reason
        self.error = error
        self._done.set()
        self._q.put(None)


@dataclass
class _Slot:
    handle: RequestHandle
    prompt: np.ndarray  # int32 [prompt_len]
    max_new: int
    temperature: float
    eos_id: Optional[int]
    on_token: Optional[Callable[[Optional[int]], None]]
    seed: int = 0  # per-request sampling stream
    # Chat-session identity: at finish the engine records the session's
    # transcript so it can be exported (KV page migration) or re-prefilled.
    session_id: Optional[str] = None
    # (trace_id, parent_span_id) of the request's trace; at finish the
    # stage stamps below become child spans on that trace.
    trace_ctx: Optional[tuple] = None
    submit_t: float = 0.0  # monotonic submit time (TTFT + queue timeout)
    # Stamps (monotonic) + measured prefix-match cost: submit -> admit ->
    # first prefill dispatch -> first token -> finish.
    admit_t: float = 0.0
    prefill_start_t: float = 0.0
    first_tok_t: float = 0.0
    prefix_match_s: float = 0.0
    prefill_offset: int = 0  # next chunk start; == len(prompt) when done
    matched_len: int = 0  # prompt tokens whose prefill the radix skipped
    pos: int = 0  # write position of the NEXT decode step
    last_token: int = 0
    produced: int = 0
    # Physical pages in logical order; the first ``shared_pages`` are
    # borrowed read-only from the radix index (refcounted, never written),
    # the rest are exclusively owned until freed.
    pages: List[int] = field(default_factory=list)
    shared_pages: int = 0
    inserted: bool = False  # prompt pages filed in the radix index
    # True once this slot's current token lives on the device (a row of
    # the previous block's last tokens): its next input chains there.
    on_device_chain: bool = False
    # True between dispatching the FINAL prefill chunk and fetching its
    # sampled first token (lag-1): the slot must not join the decode batch
    # until that token is known on the host.
    first_tok_pending: bool = False

    @property
    def prefill_done(self) -> bool:
        return self.prefill_offset >= len(self.prompt)


class SlotEngine:
    """Continuous-batching generation over a paged KV-cache pool, on
    ``device`` (``cuda`` unless the caller asks for the CPU), which must
    be where ``model``'s parameters live.

    With ``mesh`` (a ``DeviceMesh`` whose only axis of size > 1 is tp,
    built on every rank of its group) the engine places ``model``'s
    parameters on it in place (each rank passes the same values) and
    serves tp-sharded; requests go to rank 0, and the other ranks run the
    follower loop (module docstring).

    ``observability`` is the module the engine's metrics and spans go to:
    any object whose ``metrics`` and ``tracing`` have the calls of
    ``ray_tpu_torch.observability`` (the default); in a Serve replica of
    the JAX package's runtime, ``ray_tpu.observability``."""

    # Rule deltas over parallel.sharding.DEFAULT_RULES: the page pool's
    # heads axis is the KV-heads axis, which the training table leaves
    # replicated; serving maps it to tp so each rank holds 1/tp of every
    # KV page.
    SERVE_RULES = {"kv": "tp"}

    def __init__(self, model: llama.Llama, num_slots: int = 8,
                 chunk: int = 64, seed: int = 0, decode_block: int = 1,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 max_pending: Optional[int] = None,
                 queue_timeout_s: Optional[float] = None,
                 max_sessions: int = 256,
                 mesh=None, rules=None, device=None, observability=None):
        cfg = model.cfg
        if cfg.max_seq % chunk != 0:
            raise ValueError(
                f"chunk ({chunk}) must divide max_seq ({cfg.max_seq}): "
                "a padded tail chunk would clamp past the cache end")
        if cfg.max_seq % page_size != 0:
            raise ValueError(
                f"page_size ({page_size}) must divide max_seq "
                f"({cfg.max_seq})")
        dev = default_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if model.wte.device != dev:
            raise ValueError(f"model lives on {model.wte.device}, the "
                             f"engine on {dev}")
        self.cfg = cfg
        self.num_slots = num_slots
        self.chunk = chunk
        self.page_size = page_size
        # decode_block K > 1: one dispatch advances every slot K tokens,
        # chaining sampled tokens on the device, and the host fetches a
        # block's tokens only after dispatching the next. Tokens stream in
        # bursts of K and EOS is noticed up to 2K-1 tokens late (the
        # overshoot is discarded; its K/V is overwritten before it is
        # ever attended).
        self.decode_block = decode_block
        self.max_pending = max_pending
        self.queue_timeout_s = queue_timeout_s
        self._model = model
        self._device = dev
        self._obs = observability or default_observability
        self._cuda = dev.type == "cuda"
        self._stream = torch.cuda.current_stream(dev) if self._cuda else None
        self._rules = None if mesh is None else self._place(mesh, rules)
        # This rank's shards (the whole model without a mesh): checks the
        # placement against the rules once, here.
        self._shards = llama._shards(model, self._rules)
        self.tp = self._shards.n
        self.rank = self._shards.rank
        self._followers_stopped = False
        # Graph capture only on one rank (module docstring).
        self._graphable = self._cuda and self.tp == 1
        self._pages_per_seq = cfg.max_seq // page_size
        # Pool default: num_slots full sequences plus the scratch page.
        self._num_pages = (num_pages if num_pages is not None
                           else num_slots * self._pages_per_seq + 1)
        self._pool = PagePool(self._num_pages)
        self._radix: Optional[RadixIndex] = (
            RadixIndex(self._pool, page_size) if prefix_cache else None)
        self._tables = np.zeros((num_slots, self._pages_per_seq),
                                dtype=np.int64)
        # The pool's KV-heads axis under the rules: each rank allocates
        # its own heads.
        self.kv_spec = shd.spec_for(llama.PAGED_KV_AXES, self._rules)
        self._cache = llama.init_paged_kv_cache(cfg, self._num_pages,
                                                page_size, dev,
                                                shards=self.tp)
        self._base_seed = seed
        self._req_counter = 0
        # Decode roofline: a decode step streams the params plus the KV
        # pages the live slots attend through HBM once, on every rank.
        self._param_bytes = self.tp * sum(
            t.numel() * t.element_size() for t in (
                p.to_local() if shd.is_dtensor(p) else p
                for p in model.parameters()))
        kv = self._cache["kv"]
        self._kv_page_bytes = self.tp * kv.numel() * kv.element_size() // max(
            1, self._num_pages)
        self._prof_steps = 0
        self._prof_wall = 0.0
        self._prof_bytes = 0.0
        self._prof_t0: Optional[float] = None
        # lag-1 pipeline: (snapshot, pre_info, host tokens, done event)
        self._inflight = None
        # CUDA graphs of the block, by fused or not; see _capture.
        self._graphs: dict = {}
        self._last_dev = torch.zeros((num_slots,), dtype=torch.int32,
                                     device=dev)

        self._slots: List[Optional[_Slot]] = [None] * num_slots
        self._pending: deque = deque()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # Resident chat sessions (LRU-bounded): session_id -> {transcript,
        # seed, temperature, t}. The KV pages live in the radix index.
        self.max_sessions = max_sessions
        self._sessions: "OrderedDict[str, dict]" = OrderedDict()
        # Control ops (export/import) run ON THE ENGINE THREAD at a step
        # boundary: the dispatch path writes the cache outside the lock.
        self._control: deque = deque()
        # counters
        self.tokens_generated = 0
        self.requests_completed = 0
        self.requests_shed = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_saved = 0

    # -- device plumbing ---------------------------------------------------

    def _on_device(self):
        """The engine's device and stream, for whichever thread runs."""
        if not self._cuda:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self._device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On the card the copy is
        made from pinned memory without blocking the host: a blocking copy
        would wait for the block in flight."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if not self._cuda:
            return t.clone()
        return t.pin_memory().to(self._device, non_blocking=True)

    def _to_host_later(self, flat: torch.Tensor):
        """(host tensor, event): ``flat`` copied into pinned memory behind
        an event the fetch waits on; (tensor, None) on the CPU."""
        if not self._cuda:
            return flat, None
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self._stream)
        return host, done

    # -- tp: placement and the follower protocol ------------------------------

    def _place(self, mesh, rules):
        """Place the model's parameters on ``mesh`` under ``SERVE_RULES``
        merged with ``rules`` and pruned for the mesh (as the JAX engine);
        returns the rules. Refuses a mesh that is not a ``DeviceMesh``, a
        mesh with another axis of size > 1 than tp, and a tp that does not
        divide the head counts, d_mlp or the vocab."""
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(
                f"mesh must be a torch DeviceMesh (MeshSpec.build()), not "
                f"{type(mesh).__name__}")
        cfg = self.cfg
        sizes = shd.mesh_sizes(mesh)
        tp = sizes.get("tp", 1)
        others = sorted(a for a, n in sizes.items() if n > 1 and a != "tp")
        if others:
            raise ValueError(f"the engine shards over tp alone; the mesh "
                             f"also splits {others}")
        if tp > 1 and (cfg.num_kv_heads % tp or cfg.num_heads % tp
                       or cfg.d_mlp % tp or cfg.vocab_size % tp):
            raise ValueError(
                f"tp={tp} must divide num_kv_heads ({cfg.num_kv_heads}), "
                f"num_heads ({cfg.num_heads}), d_mlp ({cfg.d_mlp}) and "
                f"vocab ({cfg.vocab_size})")
        rules = shd.prune_rules_for_mesh(
            mesh, dict(self.SERVE_RULES, **(rules or {})))
        shd.place(mesh, self._model, self._model.logical_axes(), rules)
        return rules

    @property
    def is_leader(self) -> bool:
        """Whether this rank schedules (rank 0 of the tp group)."""
        return self.rank == 0

    def _metrics(self):
        """The ``rt_llm_*`` family, or None: telemetry off, or a follower
        (which replays cache operations and must not count them twice)."""
        return llm_metrics(self._obs) if self.is_leader else None

    def _leader_only(self, what: str) -> None:
        if not self.is_leader:
            raise RuntimeError(
                f"{what}: rank {self.rank} of the tp group follows rank 0, "
                "which alone takes requests and schedules")

    def _broadcast(self, msg=None):
        """``msg`` from rank 0 to the tp group (rank 0 passes it, the
        others get it)."""
        sh = self._shards
        group = sh.mesh.get_group(sh.axis)
        box = [msg]
        dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                                   group=group)
        return box[0]

    def _collective(self, op: str, *args):
        """Run cache operation ``op`` on ``args`` (host values) here and,
        under tp, on every rank: rank 0 broadcasts it first."""
        if self.tp > 1:
            self._broadcast((op, args))
        return self._apply(op, args)

    def _apply(self, op: str, args):
        if op == "block":
            return self._run_block(*args)
        if op == "copy":
            src, dst = (self._h2d(np.asarray(a)) for a in args)
            return llama.copy_pages(self._cache, src, dst)
        if op == "write":
            return self._write_local(*args)
        if op == "gather":
            return self._gather_local(*args)
        raise ValueError(f"unknown cache operation {op!r}")

    def follow(self) -> None:
        """The loop of every rank but 0 under tp: replay rank 0's cache
        operations, in its order, until rank 0's engine stops."""
        if self.is_leader:
            raise RuntimeError("rank 0 schedules; it does not follow")
        with self._on_device():
            while True:
                op, args = self._broadcast()
                if op == "stop":
                    return
                self._apply(op, args)

    def _stop_followers(self) -> None:
        if self.tp > 1 and self.is_leader and not self._followers_stopped:
            self._followers_stopped = True
            with self._on_device():
                self._broadcast(("stop", ()))

    # -- public API --------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new: int = 64,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               on_token: Optional[Callable[[Optional[int]], None]] = None,
               seed: Optional[int] = None,
               session_id: Optional[str] = None,
               trace_ctx: Optional[tuple] = None) -> RequestHandle:
        self._leader_only("submit")
        prompt = np.asarray(prompt, dtype=np.int32)
        if prompt.ndim != 1 or len(prompt) == 0:
            raise ValueError("prompt must be a non-empty 1D token list")
        if len(prompt) + max_new > self.cfg.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds "
                f"max_seq ({self.cfg.max_seq})")
        n_total = -(-(len(prompt) + max_new) // self.page_size)
        if n_total > self._num_pages - 1:
            # Admission reserves the worst-case footprint; a request the
            # pool can never cover would block the FIFO queue forever.
            raise ValueError(
                f"request needs {n_total} KV pages but the pool only "
                f"has {self._num_pages - 1} allocatable")
        if trace_ctx is None:
            # A direct submit still joins a trace open on this thread or
            # task.
            trace_ctx = self._obs.tracing.inject_context()
        handle = RequestHandle(len(prompt))
        slot = _Slot(handle=handle, prompt=prompt, max_new=max_new,
                     temperature=float(temperature), eos_id=eos_id,
                     on_token=on_token, submit_t=time.monotonic(),
                     session_id=session_id, trace_ctx=trace_ctx)
        with self._work:
            if (self.max_pending is not None
                    and len(self._pending) >= self.max_pending):
                self.requests_shed += 1
                raise OverloadedError(
                    f"engine overloaded: {len(self._pending)} requests "
                    f"pending (max_pending={self.max_pending})")
            self._req_counter += 1
            # Masked to the int32 range either way: the seed rides an
            # int32 vector to the device.
            slot.seed = (int(seed) if seed is not None else
                         self._base_seed * 1000003
                         + self._req_counter) & 0x7FFFFFFF
            self._pending.append(slot)
            self._work.notify()
        return handle

    def start(self) -> "SlotEngine":
        """Run the scheduler on a thread (rank 0), or the follower loop
        (the other ranks under tp)."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run if self.is_leader else self.follow,
                name="llm-engine", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        if not self.is_leader:
            # The follower loop ends when rank 0's engine stops.
            if self._thread is not None:
                self._thread.join(timeout=30)
                self._thread = None
            return
        with self._work:
            self._stop = True
            self._work.notify()
        stuck = False
        if self._thread is not None:
            self._thread.join(timeout=30)
            stuck = self._thread.is_alive()
            self._thread = None
        # Whether or not a thread ever ran, no caller may be left hanging:
        # flush queued control ops and fail every registered request.
        with self._lock:
            self._drain_control_locked()
            self._fail_all_locked(EngineStoppedError("engine stopped"))
        if not stuck:  # no operation is in flight: release the followers
            self._stop_followers()

    def warmup(self) -> None:
        """Run one short request through both programs (the fused and the
        pure decode block; on the card this captures both graphs) before
        serving traffic. Safe to call whether or not the engine thread is
        running."""
        h = self.submit([1, 2, 3], max_new=2)
        if self._thread is not None:
            h.result(timeout=600)
            return
        while not h._done.is_set():
            if not self.step():
                break
        h.result(timeout=0)

    # -- paged-pool introspection -----------------------------------------

    @property
    def pages_total(self) -> int:
        return self._pool.num_pages

    @property
    def pages_used(self) -> int:
        return self._pool.used_count

    @property
    def pages_free(self) -> int:
        return self._pool.free_count

    def prefix_cache_len(self) -> int:
        return 0 if self._radix is None else len(self._radix)

    def clear_prefix_cache(self) -> int:
        """Drop every radix entry (and the pages only it held). Returns
        pages freed."""
        with self._lock:
            freed = 0 if self._radix is None else self._radix.clear()
            self._publish_page_gauges()
            return freed

    def _publish_page_gauges(self) -> None:
        m = self._metrics()
        if m is not None:
            m["pages_used"].set(float(self._pool.used_count))
            m["pages_free"].set(float(self._pool.free_count))

    # -- stateful sessions (migration & drain) -----------------------------

    def sessions(self) -> List[str]:
        """Resident session ids (LRU order, oldest first)."""
        with self._lock:
            return list(self._sessions.keys())

    @property
    def session_count(self) -> int:
        with self._lock:
            return len(self._sessions)

    def _record_session_locked(self, session_id: str, transcript,
                               seed, temperature: float) -> None:
        self._sessions[session_id] = {
            "transcript": np.asarray(transcript, dtype=np.int32),
            "seed": int(seed or 0) & 0x7FFFFFFF,
            "temperature": float(temperature),
            "t": time.monotonic(),
        }
        self._sessions.move_to_end(session_id)
        while len(self._sessions) > self.max_sessions:
            self._sessions.popitem(last=False)
        m = self._metrics()
        if m is not None:
            m["sessions_resident"].set(float(len(self._sessions)))

    def _run_control(self, fn, timeout: float = 60.0):
        """Run ``fn`` under the engine lock ON THE ENGINE THREAD at a step
        boundary; with no engine thread running the caller runs it."""
        self._leader_only("a session operation")
        thread = self._thread
        if (thread is None or not thread.is_alive()
                or thread is threading.current_thread()):
            with self._lock, self._on_device():
                return fn()
        box: dict = {}
        done = threading.Event()

        def op():
            try:
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001 — relayed below
                box["error"] = e
            finally:
                done.set()

        with self._work:
            self._control.append(op)
            self._work.notify()
        if not done.wait(timeout):
            raise TimeoutError("engine control op timed out")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def export_session(self, session_id: str) -> dict:
        """Snapshot a session between decode steps: transcript, sampling
        seed, and the radix-resident KV pages covering its prefix as one
        host frame ``[L, 2, N, page_size, Hkv, hd]`` (fp32 numpy, bf16
        widened exactly). Raises KeyError for an unknown session and
        RuntimeError while the session has a generation in flight."""
        return self._run_control(
            lambda: self._export_session_locked(session_id))

    def _export_session_locked(self, session_id: str) -> dict:
        sess = self._sessions.get(session_id)
        if sess is None:
            raise KeyError(f"unknown session {session_id!r}")
        live = [s for s in self._slots if s is not None]
        for s in list(self._pending) + live:
            if s.session_id == session_id:
                raise RuntimeError(
                    f"session {session_id!r} has a generation in flight")
        transcript = sess["transcript"]
        pages: List[int] = []
        if self._radix is not None:
            pages, _ = self._radix.match(transcript)
        frames = None
        if pages:
            # Pages stay index-owned: we hold the lock, so no eviction.
            frames = self._collective("gather", list(pages))
        m = self._metrics()
        if m is not None:
            m["session_migrations"].inc(tags={"result": "export"})
        return {
            "session_id": session_id,
            "transcript": np.asarray(transcript, dtype=np.int32),
            "seed": sess["seed"],
            "temperature": sess["temperature"],
            "page_size": self.page_size,
            "covered_tokens": len(pages) * self.page_size,
            "pages_kv": frames,
        }

    def import_session(self, snapshot: dict) -> dict:
        """Rebuild an exported session (from this port or from the JAX
        package's engine) here: prefix chunks already in the local radix
        index are re-matched, the rest are written into fresh pages and
        filed in the index. Out of pool room -> partial import (the
        uncovered tail re-prefills on the session's next turn)."""
        return self._run_control(
            lambda: self._import_session_locked(dict(snapshot)))

    def _import_session_locked(self, snap: dict) -> dict:
        ps = self.page_size
        m = self._metrics()
        try:
            if int(snap["page_size"]) != ps:
                raise ValueError(
                    f"page_size mismatch: snapshot {snap['page_size']} "
                    f"vs engine {ps}")
            transcript = np.asarray(snap["transcript"], dtype=np.int32)
            frames = snap.get("pages_kv")
            n_chunks = int(snap.get("covered_tokens", 0)) // ps
            matched: List[int] = []
            fresh: List[int] = []
            if (self._radix is not None and n_chunks > 0
                    and frames is not None):
                kv_shape = tuple(self._cache["kv"].shape)
                kv_shape = (kv_shape[:4] + (self.cfg.num_kv_heads,)
                            + kv_shape[5:])
                if (tuple(frames.shape[:2]) != kv_shape[:2]
                        or tuple(frames.shape[3:]) != kv_shape[3:]):
                    raise ValueError(
                        f"KV frame shape {tuple(frames.shape)} does not "
                        f"match cache {kv_shape}")
                matched, _ = self._radix.match(transcript[:n_chunks * ps])
                need = n_chunks - len(matched)
                if need > 0 and self._pool.free_count < need:
                    self._radix.evict(need - self._pool.free_count)
                fresh = [self._pool.alloc() for _ in
                         range(min(max(0, need), self._pool.free_count))]
                if fresh:
                    have = len(matched)
                    self._write_frames_locked(
                        fresh, frames[:, :, have:have + len(fresh)])
                pages = matched + fresh
                if pages:
                    self._radix.insert(transcript[:len(pages) * ps], pages)
                # insert() took the index's own refs on NEW nodes; drop
                # our allocation refs so the index is the sole owner.
                for pg in fresh:
                    self._pool.unref(pg)
                self._publish_page_gauges()
            self._record_session_locked(
                snap["session_id"], transcript, snap.get("seed", 0),
                snap.get("temperature", 0.0))
        except Exception:
            if m is not None:
                m["session_migrations"].inc(tags={"result": "error"})
            raise
        if m is not None:
            m["session_migrations"].inc(tags={"result": "import"})
        return {"session_id": snap["session_id"],
                "pages_imported": len(fresh),
                "pages_matched": len(matched),
                "tokens_resident": (len(matched) + len(fresh)) * ps}

    def _write_frames_locked(self, pages: List[int], frames) -> None:
        """Write host KV frames [L, 2, N, ..., Hkv, hd] (numpy of any
        float dtype, the JAX package's bf16 included, or a tensor) into
        ``pages``; under tp each rank writes its own heads."""
        vals = frames if torch.is_tensor(frames) else tensor_from_numpy(
            frames)
        self._collective("write", list(pages), vals.cpu())

    def _write_local(self, pages: List[int], frames) -> None:
        h = self._cache["kv"].shape[4]
        llama.write_pages(self._cache, self._h2d(np.asarray(pages)),
                          frames[:, :, :, :, self.rank * h:(self.rank + 1) * h])

    def _gather_local(self, pages: List[int]) -> np.ndarray:
        """The whole frames of ``pages`` [L, 2, N, page_size, Hkv, hd]
        (fp32 numpy): under tp every rank's heads, gathered."""
        frames = self._cache["kv"][:, :, self._h2d(np.asarray(pages))]
        if self.tp > 1:
            with shd.use_mesh(self._shards.mesh):
                frames = all_gather(frames, self._shards.axis, axis=4,
                                    tiled=True)
        return tensor_to_numpy(frames)

    def prefill_session(self, session_id: str, transcript,
                        seed=None, temperature: float = 0.0,
                        timeout: float = 120.0) -> dict:
        """Crash-path recovery: rebuild a session by re-prefilling its
        transcript (radix hit -> near no-op, cold -> one full prefill).
        The single sampled token is discarded; the transcript's pages land
        in the radix index so the session's next turn admits warm."""
        t0 = time.monotonic()
        toks = np.asarray(transcript, dtype=np.int32)
        if toks.ndim != 1 or len(toks) == 0:
            raise ValueError("transcript must be a non-empty token list")
        toks = toks[:self.cfg.max_seq - 1]
        h = self.submit(toks, max_new=1,
                        seed=None if seed is None else int(seed))
        if self._thread is not None and self._thread.is_alive():
            h.result(timeout=timeout)
        else:
            while not h._done.is_set():
                if not self.step():
                    break
        res = h.result(timeout=0)
        with self._lock:
            self._record_session_locked(
                session_id, np.asarray(transcript, dtype=np.int32),
                seed, temperature)
        dt = time.monotonic() - t0
        m = self._metrics()
        if m is not None:
            m["session_recovery"].observe(dt)
        return {"session_id": session_id, "seconds": dt,
                "matched_tokens": (res.timing or {}).get(
                    "matched_tokens", 0),
                "transcript_len": int(len(toks))}

    # -- engine loop -------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._work:
                while not self._stop and not self._has_work_locked():
                    self._work.wait()
                if self._stop:
                    self._drain_control_locked()
                    self._fail_all_locked(
                        EngineStoppedError("engine stopped"))
                    return
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — device fault is fatal
                with self._work:
                    self._drain_control_locked()
                    self._fail_all_locked(e)
                return

    def _has_work_locked(self) -> bool:
        return (bool(self._pending) or self._inflight is not None
                or bool(self._control)
                or any(s is not None for s in self._slots))

    def _drain_control_locked(self) -> None:
        # Control-op wrappers trap their own exceptions into the caller's
        # result box, so draining never throws.
        while self._control:
            self._control.popleft()()

    def _release_slot_pages_locked(self, s: _Slot) -> None:
        for pg in s.pages:
            self._pool.unref(pg)
        s.pages = []
        s.shared_pages = 0

    def _fail_all_locked(self, err: BaseException) -> None:
        self._inflight = None
        for i, s in enumerate(self._slots):
            if s is not None:
                self._release_slot_pages_locked(s)
                self._tables[i] = 0
                s.handle._finish("error", err)
                if s.on_token:
                    s.on_token(None)
                self._slots[i] = None
        while self._pending:
            s = self._pending.popleft()
            s.handle._finish("error", err)
            if s.on_token:
                s.on_token(None)
        self._publish_page_gauges()

    # -- admission (paged + radix match) -----------------------------------

    def _shed_expired_locked(self) -> None:
        if self.queue_timeout_s is None:
            return
        now = time.monotonic()
        while self._pending and (now - self._pending[0].submit_t
                                 > self.queue_timeout_s):
            s = self._pending.popleft()
            self.requests_shed += 1
            s.handle._finish("error", OverloadedError(
                f"engine overloaded: request queued longer than "
                f"queue_timeout_s={self.queue_timeout_s}"))
            if s.on_token:
                s.on_token(None)

    def _admit_locked(self, idx: int, s: _Slot) -> bool:
        """Install a pending request into slot ``idx``: radix-match its
        prompt, borrow the matched pages read-only, copy a partial tail
        page on write, and allocate the rest of its worst-case footprint
        (prompt + max_new). Returns False (the request stays pending, FIFO
        order kept) when even after LRU eviction the pool cannot cover
        it."""
        ps = self.page_size
        n_total = -(-(len(s.prompt) + s.max_new) // ps)
        full_pages: List[int] = []
        partial = None
        if self._radix is not None:
            match_t0 = time.monotonic()
            full_pages, partial = self._radix.match(s.prompt)
            s.prefix_match_s = time.monotonic() - match_t0
            # The last prompt token's logits sample the first output, so
            # at least one prompt token must prefill.
            while len(full_pages) * ps >= len(s.prompt):
                full_pages.pop()
                partial = None
            if partial is not None:
                cap = len(s.prompt) - 1 - len(full_pages) * ps
                if min(partial[1], cap) <= 0:
                    partial = None
                else:
                    partial = (partial[0], min(partial[1], cap))
        # Borrow refs BEFORE any eviction so the matched nodes stop being
        # eviction candidates.
        for pg in full_pages:
            self._pool.ref(pg)
        if partial is not None:
            self._pool.ref(partial[0])
        n_fresh = n_total - len(full_pages)
        if self._pool.free_count < n_fresh and self._radix is not None:
            self._radix.evict(n_fresh - self._pool.free_count)
        if self._pool.free_count < n_fresh and partial is not None:
            # The partial borrow pins its source without reducing n_fresh
            # (the COW copy lands in a fresh page): for a request needing
            # the whole pool that pin makes admission impossible forever,
            # so drop the partial match and retry before giving up.
            self._pool.unref(partial[0])
            partial = None
            if self._radix is not None:
                self._radix.evict(n_fresh - self._pool.free_count)
        if self._pool.free_count < n_fresh:
            for pg in full_pages:  # roll the borrow back; stay pending
                self._pool.unref(pg)
            if partial is not None:
                self._pool.unref(partial[0])
            return False
        fresh = [self._pool.alloc() for _ in range(n_fresh)]
        s.pages = full_pages + fresh
        s.shared_pages = len(full_pages)
        s.matched_len = len(full_pages) * ps
        if partial is not None:
            # Copy-on-write: reuse the borrowed page's first n tokens in
            # this slot's own fresh page, then drop the temporary borrow.
            src, n_tok = partial
            self._collective("copy", [src], [fresh[0]])
            self._pool.unref(src)
            s.matched_len += n_tok
        self._tables[idx, :n_total] = s.pages
        self._tables[idx, n_total:] = 0
        s.prefill_offset = s.matched_len
        s.pos = 0
        hit = s.matched_len > 0
        if hit:
            self.prefix_hits += 1
            self.prefix_tokens_saved += s.matched_len
        else:
            self.prefix_misses += 1
        m = self._metrics()
        if m is not None:
            m["prefix"].inc(tags={"result": "hit" if hit else "miss"})
            if hit:
                m["prefix_tokens"].inc(s.matched_len)
        self._publish_page_gauges()
        s.admit_t = time.monotonic()
        self._slots[idx] = s
        return True

    def step(self) -> bool:
        """One scheduler iteration: admit, dispatch a block, then fetch the
        PREVIOUS block's tokens (lag-1). Returns True if any work ran."""
        self._leader_only("step")
        with self._on_device():
            return self._step()

    def _step(self) -> bool:
        ran_control = False
        with self._lock:
            # Session export/import run HERE, between blocks.
            while self._control:
                self._control.popleft()()
                ran_control = True
            self._shed_expired_locked()
            for i in range(self.num_slots):
                if self._slots[i] is None and self._pending:
                    if not self._admit_locked(i, self._pending[0]):
                        break  # pool exhausted; FIFO order preserved
                    self._pending.popleft()
            prefill_idx = next(
                (i for i, s in enumerate(self._slots)
                 if s is not None and not s.prefill_done), None)
            active = [(i, s) for i, s in enumerate(self._slots)
                      if s is not None and s.prefill_done
                      and not s.first_tok_pending]
        ran = ran_control
        had_fetch = self._inflight is not None
        new_block = (self._dispatch_block(active, prefill_idx)
                     if (active or prefill_idx is not None) else None)
        # Pages the block's live slots attend by its last step (each pos
        # has moved past the block; overshoot past a slot's footprint
        # reads no page of its own), counted before the fetch frees any.
        attended = sum(min(-(-s.pos // self.page_size), len(s.pages))
                       for _, s in active)
        if had_fetch:
            self._process_fetch()
            ran = True
        if new_block is not None:
            self._inflight = new_block
            ran = True
        # Roofline accounting: only steady pipeline intervals count (a
        # step that dispatched a block with active decode slots AND
        # fetched the previous one spans decode_block device steps).
        if new_block is not None and had_fetch and active:
            now = time.monotonic()
            if self._prof_t0 is not None:
                steps = self.decode_block
                self._prof_wall += now - self._prof_t0
                self._prof_steps += steps
                self._prof_bytes += steps * (
                    self._param_bytes + attended * self._kv_page_bytes)
            self._prof_t0 = now
        else:
            self._prof_t0 = None
        return ran

    def _decode_steps(self, toks, pos, inp, k: int):
        """k chained decode steps from tokens ``toks`` at ``pos``: each
        step's sampled tokens (qpos = pos + 1) feed the next. Returns the
        k token vectors."""
        out = []
        for _ in range(k):
            logits, _ = llama.decode_slots_paged(
                self._model, self._cache, inp["tables"], toks, pos,
                self.page_size, self._rules)
            pos = pos + 1
            toks = sampling.sample(logits, inp["temps"], inp["seeds"], pos)
            out.append(toks)
        return out

    def _block_fn(self, inp: dict, fused: bool):
        """One K-step block on device tensors ``inp`` (the JAX engine's
        ``block_fn`` when ``fused``, else ``decode_only_fn``): the first
        step carries the prompt chunk when fused. Writes the block's last
        tokens into ``inp["last"]`` (the chain into the next block) and
        returns the block's tokens flat, [K * rows] int32, followed by the
        chunk's sampled token when fused."""
        tokens0 = torch.where(inp["override_mask"], inp["override_vals"],
                              inp["last"])
        pos = inp["pos"]
        if fused:
            dec_logits, pre_logits, _ = \
                llama.decode_slots_with_prefill_paged(
                    self._model, self._cache, inp["tables"], tokens0, pos,
                    inp["pre_tokens"], inp["pre_slot"], inp["pre_p0"],
                    inp["pre_n_valid"], self.page_size, self._rules)
            pos = pos + 1
            tok1 = sampling.sample(dec_logits, inp["temps"], inp["seeds"],
                                   pos)
            pre_tok = sampling.sample(pre_logits[None], inp["pre_temp"],
                                      inp["pre_seed"],
                                      inp["pre_p0"] + inp["pre_n_valid"])
            toks = [tok1] + self._decode_steps(tok1, pos, inp,
                                               self.decode_block - 1)
        else:
            toks = self._decode_steps(tokens0, pos, inp, self.decode_block)
        inp["last"].copy_(toks[-1])
        flat = torch.stack(toks).reshape(-1)
        return torch.cat([flat, pre_tok]) if fused else flat

    def _capture(self, fused: bool, names):
        """CUDA graph of ``_block_fn`` for ``fused``, captured on first
        use: one replay then launches the whole block,
        as one jitted program does in the JAX engine. Inputs live in
        static device buffers, filled before each replay; the capture is
        preceded by one eager run on values that write only the scratch
        page (every row parked, no valid chunk token) and chain into a
        decoy buffer, so live slots are untouched."""
        rows, cfg = self.num_slots, self.cfg
        dev = self._device
        shapes = {"tables": ((rows, self._pages_per_seq), torch.int64),
                  "override_vals": ((rows,), torch.int32),
                  "override_mask": ((rows,), torch.bool),
                  "pos": ((rows,), torch.int64),
                  "temps": ((rows,), torch.float32),
                  "seeds": ((rows,), torch.int32),
                  "pre_tokens": ((self.chunk,), torch.int32),
                  "pre_slot": ((1,), torch.int64),
                  "pre_p0": ((1,), torch.int64),
                  "pre_n_valid": ((1,), torch.int64),
                  "pre_temp": ((1,), torch.float32),
                  "pre_seed": ((1,), torch.int32)}
        static = {n: torch.zeros(shapes[n][0], dtype=shapes[n][1],
                                 device=dev) for n in names}
        static["pos"].fill_(cfg.max_seq)
        static["override_mask"].fill_(True)
        warm = dict(static, last=torch.zeros_like(self._last_dev))
        side = torch.cuda.Stream(dev)
        side.wait_stream(self._stream)
        with torch.cuda.stream(side):
            self._block_fn(warm, fused)
        self._stream.wait_stream(side)
        static["last"] = self._last_dev
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self._block_fn(static, fused)
        self._graphs[fused] = (graph, static, out)
        return self._graphs[fused]

    def _run_block(self, host: dict, fused: bool):
        """Launch one block on host inputs; returns its flat tokens on the
        device."""
        if not self._graphable:
            inp = {n: self._h2d(a) for n, a in host.items()}
            inp["last"] = self._last_dev
            return self._block_fn(inp, fused)
        graph, static, out = (self._graphs.get(fused)
                              or self._capture(fused, list(host)))
        for n, a in host.items():
            static[n].copy_(torch.from_numpy(a).pin_memory(),
                            non_blocking=True)
        graph.replay()
        return out

    def _dispatch_block(self, active, prefill_idx):
        """Dispatch one K-step block: every active slot decodes K tokens
        and (when a slot is mid-prompt) ONE prefill chunk rides the first
        step. Continuing slots chain their input token on the device;
        freshly prefilled slots inject theirs through the override
        vector."""
        rows = self.num_slots
        override_vals = np.zeros((rows,), dtype=np.int32)
        override_mask = np.ones((rows,), dtype=bool)
        # Parked rows sit AT max_seq: the paged scatter routes any write
        # at pos >= max_seq to the scratch page.
        pos = np.full((rows,), self.cfg.max_seq, dtype=np.int64)
        temps = np.zeros((rows,), dtype=np.float32)
        seeds = np.zeros((rows,), dtype=np.int32)
        for i, s in active:
            pos[i] = s.pos
            temps[i] = s.temperature
            seeds[i] = s.seed
            if s.on_device_chain:
                override_mask[i] = False
            else:
                override_vals[i] = s.last_token
        host = {"tables": self._tables, "override_vals": override_vals,
                "override_mask": override_mask, "pos": pos, "temps": temps,
                "seeds": seeds}
        pre_info = None
        if prefill_idx is not None:
            # Prefill lane: one chunk of one slot's prompt rides the
            # first step.
            pre_buf = np.zeros((self.chunk,), dtype=np.int32)
            s = self._slots[prefill_idx]
            if s.prefill_start_t == 0.0:
                s.prefill_start_t = time.monotonic()
            p0 = s.prefill_offset
            piece = s.prompt[p0:p0 + self.chunk]
            pre_buf[:len(piece)] = piece
            s.prefill_offset = p0 + len(piece)
            if s.prefill_done:
                s.first_tok_pending = True
            pre_info = (prefill_idx, s, s.prefill_done)
            host.update(pre_tokens=pre_buf,
                        pre_slot=np.asarray([prefill_idx], np.int64),
                        pre_p0=np.asarray([p0], np.int64),
                        pre_n_valid=np.asarray([len(piece)], np.int64),
                        pre_temp=np.asarray([s.temperature], np.float32),
                        pre_seed=np.asarray([s.seed], np.int32))
        flat = self._collective("block", host, prefill_idx is not None)
        for i, s in active:
            s.pos += self.decode_block
            s.on_device_chain = True
        return (list(active), pre_info) + self._to_host_later(flat)

    def _process_fetch(self) -> None:
        snapshot, pre_info, host, done = self._inflight
        self._inflight = None
        if done is not None:
            done.synchronize()  # this block only; the next one runs on
        flat = host.numpy()
        k, rows = self.decode_block, self.num_slots
        arr = flat[:k * rows].reshape(k, rows)
        for idx, s in snapshot:
            if self._slots[idx] is not s:
                continue  # finished in an earlier block; rows are garbage
            for j in range(k):
                self._deliver(idx, s, int(arr[j, idx]))
                if self._slots[idx] is not s:
                    break  # eos / length hit mid-block; drop overshoot
        if pre_info is not None:
            idx, s, final = pre_info
            if final and self._slots[idx] is s:
                # Prefill complete: file the prompt's full pages in the
                # radix index NOW, so a concurrent same-prefix admission
                # already hits them.
                if self._radix is not None and not s.inserted:
                    with self._lock:
                        self._radix.insert(
                            s.prompt, s.pages[:len(s.prompt)
                                              // self.page_size])
                    s.inserted = True
                # The first token arrives with this fetch; the slot joins
                # the decode batch next dispatch (override lane).
                s.first_tok_pending = False
                s.pos = len(s.prompt)
                s.on_device_chain = False
                self._deliver(idx, s, int(flat[k * rows]))

    def _request_timing(self, s: _Slot) -> dict:
        """Stage decomposition of one finished request: admission =
        waiting for a slot + pages; queue = admitted but not yet in the
        prefill lane; prefill = first chunk dispatch to first token;
        decode = the rest. Sums to ~total by construction."""
        end = time.monotonic()
        admit = s.admit_t or s.submit_t
        pre0 = s.prefill_start_t or admit
        first = s.first_tok_t or end
        timing = {
            "admission_s": max(0.0, admit - s.submit_t),
            "queue_s": max(0.0, pre0 - admit),
            "prefix_match_s": s.prefix_match_s,
            "prefill_s": max(0.0, first - pre0),
            "decode_s": max(0.0, end - first),
            "decode_per_token_s": (max(0.0, end - first)
                                   / max(1, s.produced - 1)),
            "total_s": max(0.0, end - s.submit_t),
            "matched_tokens": s.matched_len,
            "produced_tokens": s.produced,
        }
        m = self._metrics()
        if m is not None:
            st = m["stage"]
            for stage in ("admission", "queue", "prefix_match", "prefill",
                          "decode"):
                st.observe_key(_LLM_STAGE_KEYS[stage], timing[f"{stage}_s"])
            m["decode_per_token"].observe(timing["decode_per_token_s"])
        return timing

    def _emit_trace_spans(self, s: _Slot, timing: dict) -> None:
        """The finished request's ``timing`` as spans on its trace: an
        ``llm.request`` span parented to the caller's span, with
        admission/queue/prefill/decode children laid end to end from the
        same durations (and ``llm.prefix_match`` where the match took
        time), so the span tree and ``timing`` agree by construction. The
        stamps are monotonic; the wall-clock offset lines them up with
        the caller's spans."""
        tracing = self._obs.tracing
        if not tracing.get_tracer().enabled:
            return
        off = time.time() - time.monotonic()
        t0 = s.submit_t + off
        trace_id, parent = s.trace_ctx
        root = tracing.record_span(
            "llm.request", trace_id=trace_id, parent_id=parent,
            start_s=t0, end_s=t0 + timing["total_s"],
            prompt_len=int(len(s.prompt)), produced=int(s.produced),
            matched_tokens=int(s.matched_len))
        if root is None:
            return
        cur = t0
        for stage in ("admission", "queue", "prefill", "decode"):
            dur = timing[f"{stage}_s"]
            tracing.record_span(f"llm.{stage}", trace_id=trace_id,
                                parent_id=root.span_id, start_s=cur,
                                end_s=cur + dur)
            cur += dur
        if timing["prefix_match_s"] > 0.0:
            # The match runs at admission into the prefill lane, across
            # the queue/prefill boundary: its own child.
            match_t0 = t0 + timing["admission_s"] + timing["queue_s"]
            tracing.record_span("llm.prefix_match", trace_id=trace_id,
                                parent_id=root.span_id, start_s=match_t0,
                                end_s=match_t0 + timing["prefix_match_s"])

    def reset_decode_profile(self) -> None:
        """Zero the roofline window, so each phase measures its own
        steady-state interval."""
        self._prof_steps = 0
        self._prof_wall = 0.0
        self._prof_bytes = 0.0
        self._prof_t0 = None

    def decode_profile(self) -> dict:
        """Achieved-vs-peak HBM accounting for the decode loop: bytes a
        step must stream on every rank (params + the KV pages live slots
        attend) over host wall time of steady pipeline intervals.
        ``hbm_gbps`` is one card's bandwidth (``core.config``'s
        ``hbm_bandwidth_gbps``, an H100 SXM's 3350 GB/s by default) and
        ``devices`` the tp degree; the roof is their product (ranks that
        share one card still count one roof each), and a roof <= 0 gives
        ``roofline_frac`` 0.0. Publishes the ``rt_llm_roofline_frac`` and
        ``rt_llm_decode_steps_per_s`` gauges of a measured window."""
        steps, wall = self._prof_steps, self._prof_wall
        hbm_gbps = float(config().hbm_bandwidth_gbps)
        devices = self.tp
        peak_gbps = hbm_gbps * devices
        if steps == 0 or wall <= 0.0:
            prof = {"steps": 0, "wall_s": 0.0, "avg_step_ms": 0.0,
                    "steps_per_s": 0.0, "bytes_per_step": 0,
                    "achieved_gbps": 0.0, "hbm_gbps": hbm_gbps,
                    "devices": devices, "roofline_frac": 0.0}
        else:
            achieved_gbps = self._prof_bytes / wall / 1e9
            prof = {
                "steps": steps,
                "wall_s": round(wall, 6),
                "avg_step_ms": round(wall / steps * 1e3, 4),
                "steps_per_s": round(steps / wall, 2),
                "bytes_per_step": int(self._prof_bytes / steps),
                "achieved_gbps": round(achieved_gbps, 4),
                "hbm_gbps": hbm_gbps,
                "devices": devices,
                "roofline_frac": (achieved_gbps / peak_gbps
                                  if peak_gbps > 0 else 0.0),
            }
        # Only measured windows are published: an idle engine's zero
        # would overwrite the last measured value of the gauges.
        m = self._metrics()
        if m is not None and steps > 0:
            m["roofline_frac"].set(prof["roofline_frac"])
            m["decode_steps"].set(prof["steps_per_s"])
        return prof

    def _deliver(self, idx: int, s: _Slot, tok: int) -> None:
        s.last_token = tok
        s.produced += 1
        self.tokens_generated += 1
        m = self._metrics()
        if m is not None:
            m["tokens"].inc(1.0)
        if s.produced == 1:
            s.first_tok_t = time.monotonic()
            if m is not None:
                m["ttft"].observe(s.first_tok_t - s.submit_t)
        s.handle._emit(tok)
        if s.on_token:
            s.on_token(tok)
        hit_eos = s.eos_id is not None and tok == s.eos_id
        out_of_room = (len(s.prompt) + s.produced) >= self.cfg.max_seq
        if hit_eos or s.produced >= s.max_new or out_of_room:
            s.handle.timing = self._request_timing(s)
            if s.trace_ctx is not None:
                self._emit_trace_spans(s, s.handle.timing)
            s.handle._finish("stop" if hit_eos else "length")
            if s.on_token:
                s.on_token(None)
            self.requests_completed += 1
            with self._lock:
                if s.session_id is not None:
                    # Transcript = prompt + everything produced: the
                    # session's next turn reconstructs from exactly this.
                    self._record_session_locked(
                        s.session_id,
                        np.concatenate([
                            s.prompt,
                            np.asarray(s.handle._tokens, np.int32)]),
                        s.seed, s.temperature)
                self._release_slot_pages_locked(s)
                self._tables[idx] = 0
                self._slots[idx] = None
                self._publish_page_gauges()
