"""The port's own observability: metrics and tracing (counterparts of the
JAX package's ``observability.metrics`` and ``observability.tracing``,
with the same API).

The LLM engine and server take an observability module as an argument
(``observability=``): any object whose ``metrics`` and ``tracing`` have
these calls. This package is the default; a Serve replica of the JAX
package's runtime passes ``ray_tpu.observability``, whose exporter ships
that module's registry and spans.
"""

from . import metrics, tracing
from .metrics import Counter, Gauge, Histogram, get_or_create, registry

__all__ = ["Counter", "Gauge", "Histogram", "get_or_create", "metrics",
           "registry", "tracing"]
