"""Counter, Gauge and Histogram in a process-wide registry: the port's
own copy of the JAX package's ``observability/metrics.py`` (its registry
and metric types; not its runtime metrics, which only the actor runtime
emits, nor the telemetry exporter's delta merge).

The metric names, tag keys and the Prometheus text are the JAX
package's, so a scrape reads either package's series the same way.
"""

from __future__ import annotations

import bisect
import re
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

_TagKey = Tuple[Tuple[str, str], ...]

# Prometheus line-format rules: metric names admit [a-zA-Z0-9_:], label
# names only [a-zA-Z0-9_]; label VALUES are free-form but must escape
# backslash, double-quote and newline.
_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize_name(name: str) -> str:
    safe = _NAME_BAD.sub("_", name)
    if not safe or safe[0].isdigit():
        safe = "_" + safe
    return safe


def _sanitize_label(name: str) -> str:
    safe = _LABEL_BAD.sub("_", name)
    if not safe or safe[0].isdigit():
        safe = "_" + safe
    return safe


def _escape_label_value(value) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_num(v) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(pairs) -> str:
    body = ",".join(f'{_sanitize_label(k)}="{_escape_label_value(v)}"'
                    for k, v in pairs)
    return "{" + body + "}" if body else ""


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._lock = threading.Lock()
        registry.register(self)

    def _tags_key(self, tags: Optional[Dict[str, str]]) -> _TagKey:
        if not tags:
            return ()
        return tuple(sorted(tags.items()))


class Counter(Metric):
    def __init__(self, name, description="", tag_keys=()):
        self._values: Dict[_TagKey, float] = defaultdict(float)
        super().__init__(name, description, tag_keys)

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[self._tags_key(tags)] += value

    def inc_key(self, key: _TagKey, value: float = 1.0) -> None:
        """Hot-path increment with a precomputed tag key (skips the
        per-call dict build and sort)."""
        with self._lock:
            self._values[key] += value

    def collect(self):
        with self._lock:
            return ("counter", dict(self._values))


class Gauge(Metric):
    def __init__(self, name, description="", tag_keys=()):
        self._values: Dict[_TagKey, float] = {}
        super().__init__(name, description, tag_keys)

    def set(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[self._tags_key(tags)] = value

    def set_key(self, key: _TagKey, value: float) -> None:
        """Hot-path set with a precomputed tag key."""
        with self._lock:
            self._values[key] = value

    def collect(self):
        with self._lock:
            return ("gauge", dict(self._values))


class Histogram(Metric):
    def __init__(self, name, description="", boundaries: Sequence[float] = (),
                 tag_keys=()):
        self.boundaries = sorted(boundaries) or [
            0.001, 0.01, 0.1, 1, 10, 100, 1000
        ]
        self._counts: Dict[_TagKey, List[int]] = {}
        self._sums: Dict[_TagKey, float] = defaultdict(float)
        self._totals: Dict[_TagKey, int] = defaultdict(int)
        super().__init__(name, description, tag_keys)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        self.observe_key(self._tags_key(tags), value)

    def observe_key(self, key: _TagKey, value: float,
                    count: int = 1) -> None:
        """Hot-path observe with a precomputed tag key; ``count`` folds
        a coalesced batch of identical observations into one lock round."""
        with self._lock:
            if key not in self._counts:
                self._counts[key] = [0] * (len(self.boundaries) + 1)
            idx = bisect.bisect_left(self.boundaries, value)
            self._counts[key][idx] += count
            self._sums[key] += value * count
            self._totals[key] += count

    def collect(self):
        with self._lock:
            return ("histogram", {
                k: {"buckets": list(v), "sum": self._sums[k],
                    "count": self._totals[k]}
                for k, v in self._counts.items()
            })


class MetricsRegistry:
    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: Metric) -> None:
        with self._lock:
            self._metrics[metric.name] = metric

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect_all(self) -> Dict[str, tuple]:
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.collect() for m in metrics}

    def prometheus_text(self) -> str:
        """Prometheus exposition format (reference: prometheus_exporter.py).

        Strictly line-format clean: metric/label names sanitized with one
        rule everywhere, label values escaped, and the open histogram
        bucket labeled ``le="+Inf"`` (the spec spelling — a bare ``inf``
        is rejected by prometheus scrapers)."""
        lines = []
        for name, (kind, data) in sorted(self.collect_all().items()):
            safe = _sanitize_name(name)
            lines.append(f"# TYPE {safe} "
                         f"{'counter' if kind == 'counter' else 'gauge' if kind == 'gauge' else 'histogram'}")
            if kind in ("counter", "gauge"):
                for tags, value in data.items():
                    lines.append(f"{safe}{_fmt_labels(tags)} {_fmt_num(value)}")
            else:
                for tags, h in data.items():
                    metric = self._metrics.get(name)
                    cumulative = 0
                    bounds = [_fmt_num(b) for b in metric.boundaries]
                    bounds.append("+Inf")
                    for b, c in zip(bounds, h["buckets"]):
                        cumulative += c
                        lbl = _fmt_labels(list(tags) + [("le", b)])
                        lines.append(f"{safe}_bucket{lbl} {cumulative}")
                    lbl = _fmt_labels(tags)
                    lines.append(f"{safe}_sum{lbl} {_fmt_num(h['sum'])}")
                    lines.append(f"{safe}_count{lbl} {h['count']}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


registry = MetricsRegistry()


_create_lock = threading.Lock()


def get_or_create(cls, name: str, *args, **kwargs):
    """Atomic get-or-construct by name: reuse the registered metric when
    its type matches, else construct (which registers). Lazy factories
    (``llm.paged.llm_metrics``) route through here under one lock, so
    racing constructions cannot ``register``-overwrite each other and
    leave a caller holding an unregistered orphan."""
    with _create_lock:
        existing = registry.get(name)
        if type(existing) is cls:
            return existing
        return cls(name, *args, **kwargs)
