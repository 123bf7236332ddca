"""Spans with explicit or thread-local parents, and the request context
that joins them into one trace: the port's own copy of the JAX package's
``observability/tracing.py`` (its tracer, span API and context
propagation; not the trace store, the telemetry exporter or the chrome
timeline, which belong to the actor runtime).

The LLM engine records its ``llm.*`` spans through whichever of the two
modules its caller passes (``SlotEngine(observability=)``): in a Serve
replica of the JAX package's runtime the request's context is bound in
that runtime's tracing module, and its exporter ships only that module's
spans. Enable with ``get_tracer().enable()``; ``span``, ``record_span``
and ``inject_context`` record only then.

``device_span`` times work on the card: the training step's phases
(``train.step``, ``train.forward``, ``train.backward``,
``train.optimizer``) and the attention op (``attn.forward``,
``attn.backward``). It records whenever the tracer is enabled or a torch
profiler is recording, so a ``torch.profiler`` trace of any job holds the
port's phases as host ranges, on the profiler's clock beside the device
activity they launched, and the ring holds them as spans whose
``device_ms`` two CUDA events on the stream measure. The spans stay in
the ring (``Tracer.spans``) for whoever reads them; nothing ships them.

``count`` lets an op count its calls on the trace it runs in, onto the
trace's outermost open span (the training step's ``train.step``), so that
no layer above it needs to know the op.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

_local = threading.local()
# True while a torch profiler records on this thread (autograd's worker
# threads inherit it from the thread that runs the backward).
_profiler_enabled = torch._C._autograd._profiler_enabled

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
    # A device span's (start, end) CUDA events until ``device_ms`` is read.
    _events: Optional[tuple] = field(default=None, repr=False,
                                     compare=False)
    _device_ms: Optional[float] = field(default=None, repr=False,
                                        compare=False)

    @property
    def duration_ms(self) -> Optional[float]:
        if self.end_s is None:
            return None
        return (self.end_s - self.start_s) * 1000.0

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds on the card's clock between the span's two CUDA
        events, waiting for the later one on first read; None for a span
        that recorded none (a host span, or a device span off the card)."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms


class Tracer:
    """Process-wide span collector (bounded ring), and the spans open in
    each trace."""

    def __init__(self, max_spans: int = 10_000):
        self.enabled = False
        self.max_spans = max_spans
        # deque(maxlen): a full ring drops the oldest span in O(1).
        self._spans: deque = deque(maxlen=max_spans)
        self._lock = threading.Lock()
        # Spans the full ring pushed out (oldest first).
        self.dropped = 0
        # trace id -> its open context-managed spans, in the order opened.
        self._open: Dict[str, List[Span]] = {}

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def record(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self.max_spans:
                self.dropped += 1  # deque drops the oldest on append
            self._spans.append(span)

    def opened(self, span: Span) -> None:
        with self._lock:
            self._open.setdefault(span.trace_id, []).append(span)

    def closed(self, span: Span) -> None:
        with self._lock:
            spans = self._open[span.trace_id]
            for i in range(len(spans) - 1, -1, -1):
                if spans[i] is span:
                    del spans[i]
                    break
            if not spans:
                del self._open[span.trace_id]

    def innermost(self, trace_id: str) -> Optional[Span]:
        """The span of ``trace_id`` opened last and still open, on any
        thread."""
        with self._lock:
            spans = self._open.get(trace_id)
            return spans[-1] if spans else None

    def spans(self, name_prefix: str = "") -> List[Span]:
        with self._lock:
            return [s for s in self._spans if s.name.startswith(name_prefix)]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


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

    def _parent(self) -> tuple:
        """(trace_id, parent_id) of the span being opened."""
        parent = current_span()
        # Same fallback chain as inject_context: thread-local remote
        # ctx (worker executing a task), then the asyncio request ctx
        # (serve replica handler) — so a span opened inside an async
        # handler joins the request's trace instead of minting a fresh
        # id.
        remote_ctx = (getattr(_local, "remote_context", None)
                      or _request_ctx.get())
        if parent is not None:
            return parent.trace_id, parent.span_id
        if remote_ctx is not None:
            return tuple(remote_ctx)
        return os.urandom(16).hex(), None

    def __enter__(self) -> Span:
        # Parent resolution happens HERE, not in __init__: a caller may
        # build the span CM before entering remote_context, so resolving
        # eagerly would miss the adopted context.
        trace_id, parent_id = self._parent()
        s = self._span = Span(
            name=self._name, span_id=os.urandom(8).hex(),
            parent_id=parent_id, trace_id=trace_id, start_s=time.time(),
            attributes=self._attributes)
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(s)
        _tracer.opened(s)
        return s

    def __exit__(self, *exc):
        s = self._span
        s.end_s = time.time()
        _local.stack.pop()
        _tracer.closed(s)
        _tracer.record(s)
        return False


def span(name: str, **attributes):
    """Context-managed span; nests under the thread's current span and
    continues a propagated remote context when present."""
    if not _tracer.enabled:
        return _NULL_SPAN
    return _SpanCtx(name, attributes)


class _DeviceSpanCtx(_SpanCtx):
    """A span that is also a profiler range and, on a card, two timing
    events on the current stream."""

    __slots__ = ("_device", "_trace", "_range", "_start")

    def __init__(self, name: str, device, trace: Optional[str]):
        super().__init__(name, {})
        self._device = device
        self._trace = trace
        self._start = None

    def _parent(self) -> tuple:
        if self._trace is None:
            return super()._parent()
        # Work that runs on another thread than the one that opened the
        # trace (autograd's CUDA worker runs the backward) joins the
        # trace's innermost open span.
        parent = current_span()
        if parent is None or parent.trace_id != self._trace:
            parent = _tracer.innermost(self._trace)
        return self._trace, None if parent is None else parent.span_id

    def __enter__(self) -> Span:
        s = super().__enter__()
        self._range = torch.autograd.profiler.record_function(self._name)
        self._range.__enter__()
        self._start = _event(self._device)
        return s

    def __exit__(self, *exc):
        if self._start is not None:
            self._span._events = (self._start, _event(self._device))
        self._range.__exit__(*exc)
        return super().__exit__(*exc)


def _event(device):
    """A timing CUDA event recorded on ``device``'s current stream; None
    off the card and while the stream is being captured into a graph."""
    if device is None or device.type != "cuda" \
            or torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def device_span(name: str, where=None, trace: Optional[str] = None):
    """A span around work launched on a device, as a context manager that
    yields the ``Span`` (add attributes to it) or None when inactive.

    Active while the tracer is enabled or a torch profiler is recording.
    Then it nests as :func:`span` does, opens a ``record_function`` range
    named ``name`` and, where ``where`` (a tensor or a device) is on a card,
    records a timing event on its current stream at entry and at exit
    (``Span.device_ms``); nothing waits for them. ``trace`` (a trace id
    captured where the work was launched) joins a span opened on another
    thread to that trace, under its innermost open span. Inactive, it
    returns the shared no-op context and creates nothing."""
    if not (_tracer.enabled or _profiler_enabled()):
        return _NULL_SPAN
    if isinstance(where, torch.Tensor):
        where = where.device
    return _DeviceSpanCtx(name, where, trace)


def count(counts: Dict[str, int], trace: Optional[str] = None
          ) -> Optional[str]:
    """Adds ``counts`` ({attribute: n}) to the attributes of the outermost
    open span of a trace: ``trace``, else the current thread's. Returns
    that trace's id, for work the call hands to another thread (autograd's
    on a card) to count into; None, counting nothing, where no span of it
    is open."""
    if not _tracer._open:  # nothing traced anywhere: the untraced step's path
        return None
    if trace is None:
        stack = getattr(_local, "stack", None)
        if not stack:
            return None
        trace = stack[-1].trace_id
    with _tracer._lock:
        spans = _tracer._open.get(trace)
        if not spans:
            return None
        attrs = spans[0].attributes
        for name, n in counts.items():
            attrs[name] = attrs.get(name, 0) + n
    return trace


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
