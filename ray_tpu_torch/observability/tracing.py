"""Spans with explicit or thread-local parents, and the request context
that joins them into one trace: the port's own copy of the JAX package's
``observability/tracing.py`` (its tracer, span API and context
propagation; not the trace store, the telemetry exporter or the chrome
timeline, which belong to the actor runtime).

The LLM engine records its ``llm.*`` spans through whichever of the two
modules its caller passes (``SlotEngine(observability=)``): in a Serve
replica of the JAX package's runtime the request's context is bound in
that runtime's tracing module, and its exporter ships only that module's
spans. Enable with ``get_tracer().enable()``.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_local = threading.local()

# Async-safe request context: the serve replica's event loop interleaves
# many requests on ONE thread, so the thread-local span stack cannot
# carry a per-request trace context across awaits. A ContextVar is
# task-local under asyncio — each request's handler task sees only its
# own (trace_id, span_id).
_request_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "rt_request_trace_ctx", default=None)


@dataclass
class Span:
    name: str
    span_id: str
    parent_id: Optional[str]
    trace_id: str
    start_s: float
    end_s: Optional[float] = None
    attributes: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration_ms(self) -> Optional[float]:
        if self.end_s is None:
            return None
        return (self.end_s - self.start_s) * 1000.0


class Tracer:
    """Process-wide span collector (bounded ring)."""

    def __init__(self, max_spans: int = 10_000):
        self.enabled = False
        self.max_spans = max_spans
        # deque(maxlen): a full ring drops the oldest span in O(1).
        self._spans: deque = deque(maxlen=max_spans)
        self._lock = threading.Lock()
        # Export plane: a caller that ships spans elsewhere flips
        # export_enabled and drains finished spans (drain_export);
        # bounded the same way, so a stalled drain cannot grow the
        # process.
        self.export_enabled = False
        self._export: deque = deque(maxlen=max_spans)
        # Spans the full ring pushed out (oldest first).
        self.dropped = 0

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def record(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self.max_spans:
                self.dropped += 1  # deque drops the oldest on append
            self._spans.append(span)
            if self.export_enabled:
                if len(self._export) == self.max_spans:
                    self.dropped += 1
                self._export.append(span)

    def drain_export(self) -> List[Span]:
        """Finished spans recorded since the last drain (while
        ``export_enabled``)."""
        with self._lock:
            out = list(self._export)
            self._export.clear()
        return out

    def spans(self, name_prefix: str = "") -> List[Span]:
        with self._lock:
            return [s for s in self._spans if s.name.startswith(name_prefix)]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._export.clear()  # cleared means cleared: nothing ships


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def enable() -> None:
    _tracer.enable()


def disable() -> None:
    _tracer.disable()


def current_span() -> Optional[Span]:
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


class _NullSpanCtx:
    """Shared no-op CM for the tracing-disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpanCtx()


class _SpanCtx:
    """Hand-rolled context manager (cheaper than the @contextmanager
    generator form on a hot path)."""

    __slots__ = ("_name", "_attributes", "_span")

    def __init__(self, name: str, attributes: Dict[str, Any]):
        self._name = name
        self._attributes = attributes
        self._span: Optional[Span] = None

    def __enter__(self) -> Span:
        # Parent resolution happens HERE, not in __init__: a caller may
        # build the span CM before entering remote_context, so resolving
        # eagerly would miss the adopted context.
        parent = current_span()
        # Same fallback chain as inject_context: thread-local remote
        # ctx (worker executing a task), then the asyncio request ctx
        # (serve replica handler) — so a span opened inside an async
        # handler joins the request's trace instead of minting a fresh
        # id.
        remote_ctx = (getattr(_local, "remote_context", None)
                      or _request_ctx.get())
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif remote_ctx is not None:
            trace_id, parent_id = remote_ctx
        else:
            trace_id, parent_id = os.urandom(16).hex(), None
        s = self._span = Span(
            name=self._name, span_id=os.urandom(8).hex(),
            parent_id=parent_id, trace_id=trace_id, start_s=time.time(),
            attributes=self._attributes)
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(s)
        return s

    def __exit__(self, *exc):
        s = self._span
        s.end_s = time.time()
        _local.stack.pop()
        _tracer.record(s)
        return False


def span(name: str, **attributes):
    """Context-managed span; nests under the thread's current span and
    continues a propagated remote context when present."""
    if not _tracer.enabled:
        return _NULL_SPAN
    return _SpanCtx(name, attributes)


# -- context propagation ------------------------------------------------------

def inject_context() -> Optional[tuple]:
    """Capture (trace_id, span_id) to hand to work done elsewhere (another
    thread, a task, the engine thread).

    Resolution order mirrors :func:`span`: the thread's current span,
    then a remote context adopted with :func:`remote_context`, then the
    async request context a request handler bound, so work submitted
    inside an async handler still joins the request's trace even though
    no thread-local span is open across the await."""
    if not _tracer.enabled:
        return None
    s = current_span()
    if s is not None:
        return (s.trace_id, s.span_id)
    remote_ctx = getattr(_local, "remote_context", None)
    if remote_ctx is not None:
        return tuple(remote_ctx)
    req_ctx = _request_ctx.get()
    return tuple(req_ctx) if req_ctx is not None else None


class _RemoteCtx:
    """Class CM (not @contextmanager): adopts a context for a block."""

    __slots__ = ("_ctx",)

    def __init__(self, ctx: Optional[tuple]):
        self._ctx = ctx

    def __enter__(self):
        if self._ctx is not None:
            _local.remote_context = tuple(self._ctx)
        return None

    def __exit__(self, *exc):
        if self._ctx is not None:
            _local.remote_context = None
        return False


def remote_context(ctx: Optional[tuple]) -> "_RemoteCtx":
    """Adopt a submitter's trace context for the block, so spans opened
    in it join the submitter's trace."""
    return _RemoteCtx(ctx)


def set_request_context(ctx: Optional[tuple]):
    """Bind a request's (trace_id, span_id) to the CURRENT asyncio task
    (or thread, outside a loop). Returns a token for
    :func:`reset_request_context`. No-op (returns None) without a ctx."""
    if ctx is None:
        return None
    return _request_ctx.set(tuple(ctx))


def reset_request_context(token) -> None:
    if token is not None:
        _request_ctx.reset(token)


def get_request_context() -> Optional[tuple]:
    """The (trace_id, span_id) bound to this task/thread, if any."""
    return _request_ctx.get()


def new_span_id() -> str:
    return os.urandom(8).hex()


def record_span(name: str, trace_id: str,
                parent_id: Optional[str] = None,
                start_s: Optional[float] = None,
                end_s: Optional[float] = None,
                span_id: Optional[str] = None,
                **attributes) -> Optional[Span]:
    """Record a finished span with EXPLICIT identity and timestamps.

    The context-managed :func:`span` cannot express spans synthesized
    after the fact from stage stamps (the LLM engine's timing breakdown):
    they know their trace id and wall-clock bounds up front, and this
    records them without touching the thread-local stack."""
    if not _tracer.enabled:
        return None
    now = time.time()
    s = Span(name=name, span_id=span_id or new_span_id(),
             parent_id=parent_id, trace_id=trace_id,
             start_s=now if start_s is None else start_s,
             end_s=now if end_s is None else end_s,
             attributes=attributes)
    _tracer.record(s)
    return s
