"""Error types of the port's serving path: the port's own copy of the two
the JAX package's ``core/exceptions.py`` defines for it.

Both derive from ``RuntimeError_``, the framework's base error (kept
distinct from the builtin ``RuntimeError``), as they do there, so a
caller that catches the base catches both.
"""

from __future__ import annotations


class RuntimeError_(Exception):
    """Base class for framework errors (kept distinct from builtin
    RuntimeError)."""


class OverloadedError(RuntimeError_):
    """Typed admission-shed error: a bounded pending queue is full or a
    request waited past the queue timeout. An HTTP front end maps it to a
    503 so clients can back off instead of reading a generic 500."""


class EngineStoppedError(RuntimeError_):
    """The LLM engine was stopped (or its device loop died) with requests
    still in flight. Every pending/active RequestHandle is failed with
    this promptly at ``stop()``: callers blocked in ``result()`` see a
    typed error, never a hang past their timeout."""
