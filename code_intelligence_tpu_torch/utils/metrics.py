"""Prometheus text-format metrics registry (counters, gauges, histograms).

The part of the JAX package's ``utils/metrics.py`` that the server's
``/metrics`` route and the slot scheduler's gauges use; rendered in
Prometheus text exposition format 0.0.4.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

log = logging.getLogger(__name__)

# request-latency-shaped default buckets (seconds)
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_Labels = Tuple[Tuple[str, str], ...]


def _escape_label_value(v) -> str:
    # exposition-format escapes: a stray newline in a label value would
    # break the line-oriented format and corrupt every metric after it
    return (str(v)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: _Labels) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in labels)
    return "{" + inner + "}"


class Registry:
    """Thread-safe metric registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._meta: Dict[str, Tuple[str, str]] = {}  # name -> (help, type)
        self._values: Dict[Tuple[str, _Labels], float] = {}
        # (name, labels) -> [bucket counts..., sum, count]
        self._hists: Dict[Tuple[str, _Labels], List[float]] = {}
        self._buckets: Dict[str, Sequence[float]] = {}

    # -- declaration ------------------------------------------------------

    def _declare_locked(self, name: str, help_: str, type_: str) -> None:
        self._meta.setdefault(name, (help_, type_))
        if type_ == "histogram":
            self._buckets.setdefault(name, DEFAULT_BUCKETS)

    def counter(self, name: str, help_: str = "") -> None:
        with self._lock:
            self._declare_locked(name, help_, "counter")

    def gauge(self, name: str, help_: str = "") -> None:
        with self._lock:
            self._declare_locked(name, help_, "gauge")

    def histogram(self, name: str, help_: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        with self._lock:
            if name not in self._meta:  # first declaration wins, buckets too
                self._meta[name] = (help_, "histogram")
                self._buckets[name] = tuple(buckets)
            elif tuple(buckets) != tuple(self._buckets.get(name, ())):
                log.warning(
                    "histogram %r was already declared with buckets %s; "
                    "ignoring the new buckets %s",
                    name, tuple(self._buckets.get(name, ())), tuple(buckets))

    # -- updates ----------------------------------------------------------

    @staticmethod
    def _key(labels: Optional[Dict[str, str]]) -> _Labels:
        return tuple(sorted((labels or {}).items()))

    def inc(self, name: str, value: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        k = (name, self._key(labels))
        with self._lock:
            self._declare_locked(name, "", "counter")
            self._values[k] = self._values.get(k, 0.0) + value

    def set(self, name: str, value: float,
            labels: Optional[Dict[str, str]] = None) -> None:
        k = (name, self._key(labels))
        with self._lock:
            self._declare_locked(name, "", "gauge")
            self._values[k] = float(value)

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        k = (name, self._key(labels))
        with self._lock:
            self._declare_locked(name, "", "histogram")
            buckets = self._buckets[name]
            h = self._hists.setdefault(k, [0.0] * (len(buckets) + 2))
            for i, b in enumerate(buckets):
                if value <= b:
                    h[i] += 1
            h[-2] += value  # sum
            h[-1] += 1      # count

    # -- render -----------------------------------------------------------

    def render(self) -> str:
        with self._lock:
            lines: List[str] = []
            for name, (help_, type_) in sorted(self._meta.items()):
                if help_:
                    lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {type_}")
                if type_ == "histogram":
                    buckets = self._buckets.get(name, DEFAULT_BUCKETS)
                    for (n, labels), h in sorted(self._hists.items()):
                        if n != name:
                            continue
                        for i, b in enumerate(buckets):
                            lbl = _fmt_labels(labels + (("le", f"{b}"),))
                            lines.append(f"{name}_bucket{lbl} {h[i]}")
                        lbl_inf = _fmt_labels(labels + (("le", "+Inf"),))
                        lines.append(f"{name}_bucket{lbl_inf} {h[-1]}")
                        lines.append(f"{name}_sum{_fmt_labels(labels)} {h[-2]}")
                        lines.append(f"{name}_count{_fmt_labels(labels)} {h[-1]}")
                else:
                    for (n, labels), v in sorted(self._values.items()):
                        if n == name:
                            lines.append(f"{name}{_fmt_labels(labels)} {v}")
            return "\n".join(lines) + "\n"
