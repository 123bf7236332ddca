"""The port's flag table: its own copy of the two flags of the JAX
package's ``core/config.py`` that the serving path reads.

As there, a process-wide ``config()``, each flag overridable by the
environment variable ``RT_<NAME>`` (read when the instance is first made;
``Config.reset()`` reads them again) or by ``apply_overrides``. The names
are the JAX package's, so one variable (``RT_TELEMETRY_ENABLED=0``) turns
telemetry off in both packages of a process.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict


def _parse_bool(v: str) -> bool:
    return v.lower() in ("1", "true", "yes", "on")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    float: float,
}


@dataclass
class _Flag:
    name: str
    type: type
    default: Any
    doc: str


_FLAGS: Dict[str, _Flag] = {}


def _define(name: str, type_: type, default: Any, doc: str) -> None:
    _FLAGS[name] = _Flag(name, type_, default, doc)


_define("telemetry_enabled", bool, True,
        "The LLM engine's rt_llm_* metrics (llm.paged.llm_metrics returns "
        "None when off). 0 disables them for overhead A/B runs.")
_define("hbm_bandwidth_gbps", float, 3350.0,
        "Peak HBM bandwidth of one card in GB/s, the roofline denominator "
        "of decode_profile() and rt_llm_roofline_frac (the roof is this "
        "times the tp degree). The default is one H100 SXM's HBM3 (data "
        "sheet); set it per deployment for another card. <= 0 reads as "
        "no roof: roofline_frac 0.0.")

_ENV_PREFIX = "RT_"


class Config:
    """Process-wide config singleton."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self._values: Dict[str, Any] = {}
        for flag in _FLAGS.values():
            env = os.environ.get(_ENV_PREFIX + flag.name.upper())
            if env is not None:
                self._values[flag.name] = _PARSERS[flag.type](env)
            else:
                self._values[flag.name] = flag.default

    @classmethod
    def instance(cls) -> "Config":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._instance = None

    def apply_overrides(self, overrides: Dict[str, Any]) -> None:
        for k, v in overrides.items():
            if k not in _FLAGS:
                raise KeyError(f"Unknown config flag: {k}")
            self._values[k] = v

    def __getattr__(self, name: str) -> Any:
        try:
            return self.__dict__["_values"][name]
        except KeyError:
            raise AttributeError(name) from None


def config() -> Config:
    return Config.instance()
