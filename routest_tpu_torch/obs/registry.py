"""Process-wide metrics registry: counters, gauges, log-bucket histograms.

Copied from ``routest_tpu/obs/registry.py``: one registry per process
(``get_registry()``) behind one API with two export formats, a JSON
snapshot and Prometheus exposition text (``text/plain; version=0.0.4``).
The batcher, the fast lane, dispatch and the WSGI layer register their
metrics here, and ``register_build_info`` the build-identity gauges
(labelled with ``torch`` and its version where the JAX package names
``jax``). Trace exemplars arrive with the observability slice, which
brings the tracer they read.

Histograms use FIXED log-scale buckets (1–2.5–5 per decade) rather than
reservoirs: observation is O(log buckets) with no RNG, series from
different processes aggregate by bucket addition, and quantiles come
from the standard cumulative-bucket interpolation every Prometheus stack
applies. Registries are also instantiable (``MetricsRegistry()``) for
per-component isolation.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Latency seconds, 500 µs … 60 s: the serving stack's observed range.
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labelnames: Sequence[str], labelvalues: Sequence[str],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [f'{k}="{_escape_label(v)}"'
             for k, v in list(zip(labelnames, labelvalues)) + list(extra)]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Child:
    __slots__ = ("_lock",)

    def __init__(self) -> None:
        self._lock = threading.Lock()


class Counter(_Child):
    __slots__ = ("value",)

    def __init__(self) -> None:
        super().__init__()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += n


class Gauge(_Child):
    __slots__ = ("value",)

    def __init__(self) -> None:
        super().__init__()
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self.value -= n


class Histogram(_Child):
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]) -> None:
        super().__init__()
        self.buckets = tuple(buckets)          # upper bounds, ascending
        self.counts = [0] * (len(self.buckets) + 1)  # + the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        if not math.isfinite(v):
            return  # a NaN observation would poison sum forever
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(upper_bound, cumulative_count), …, (inf, total)]."""
        out, running = [], 0
        with self._lock:
            counts = list(self.counts)
        for bound, c in zip(self.buckets, counts):
            running += c
            out.append((bound, running))
        out.append((math.inf, running + counts[-1]))
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Prometheus-style histogram_quantile: linear interpolation
        inside the covering bucket (uniformity assumption). None when
        empty; the top bucket clamps to its lower bound rather than
        inventing an upper edge for +Inf."""
        with self._lock:
            counts = list(self.counts)
            total = self.count
        if total == 0:
            return None
        rank = q * total
        running = 0.0
        for i, c in enumerate(counts):
            if running + c >= rank and c > 0:
                lower = self.buckets[i - 1] if i > 0 else 0.0
                if i == len(self.buckets):  # +Inf bucket: no upper edge
                    return self.buckets[-1]
                upper = self.buckets[i]
                return lower + (upper - lower) * ((rank - running) / c)
            running += c
        return self.buckets[-1]


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Metric:
    """One named family: type, help text, labelnames, children by
    label-value tuple (the unlabeled family has the () child)."""

    def __init__(self, name: str, kind: str, help_: str,
                 labelnames: Tuple[str, ...],
                 buckets: Optional[Sequence[float]]) -> None:
        self.name = name
        self.kind = kind
        self.help = help_
        self.labelnames = labelnames
        self.buckets = tuple(buckets) if buckets is not None else None
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got {tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = (Histogram(self.buckets) if self.kind == "histogram"
                         else _TYPES[self.kind]())
                self._children[key] = child
            return child

    def items(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return sorted(self._children.items())

    # Unlabeled conveniences: metric.inc()/set()/observe() hit the
    # () child directly.
    def _default(self):
        return self.labels()

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._default().dec(n)

    def set(self, v: float) -> None:
        self._default().set(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, kind: str, help_: str,
                       labelnames: Iterable[str],
                       buckets: Optional[Sequence[float]]) -> _Metric:
        labelnames = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = _Metric(name, kind, help_, labelnames, buckets)
                self._metrics[name] = m
                return m
        if m.kind != kind or m.labelnames != labelnames:
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}"
                f"{m.labelnames}, requested {kind}{labelnames}")
        return m

    def counter(self, name: str, help_: str = "",
                labelnames: Iterable[str] = ()) -> _Metric:
        return self._get_or_create(name, "counter", help_, labelnames, None)

    def gauge(self, name: str, help_: str = "",
              labelnames: Iterable[str] = ()) -> _Metric:
        return self._get_or_create(name, "gauge", help_, labelnames, None)

    def histogram(self, name: str, help_: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS) -> _Metric:
        return self._get_or_create(name, "histogram", help_, labelnames,
                                   buckets)

    def get(self, name: str) -> Optional[_Metric]:
        """Registered family by name, or None (read-side consumers must
        not create families as a side effect of looking)."""
        with self._lock:
            return self._metrics.get(name)

    # ── export ────────────────────────────────────────────────────────

    def snapshot(self) -> dict:
        """JSON-shaped dump: name → {type, help, series:[{labels, …}]}.
        Histogram series carry count/sum plus interpolated p50/p95/p99
        (same unit as observed)."""
        out = {}
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            series = []
            for key, child in m.items():
                labels = dict(zip(m.labelnames, key))
                if m.kind == "histogram":
                    assert isinstance(child, Histogram)
                    entry = {"labels": labels, "count": child.count,
                             "sum": round(child.sum, 6)}
                    if child.count:
                        for q, label in ((0.5, "p50"), (0.95, "p95"),
                                         (0.99, "p99")):
                            entry[label] = round(child.quantile(q), 6)
                    series.append(entry)
                else:
                    series.append({"labels": labels, "value": child.value})
            out[name] = {"type": m.kind, "help": m.help, "series": series}
        return out

    def prometheus_text(self) -> str:
        """Exposition format 0.0.4: HELP/TYPE per family; histograms as
        cumulative ``_bucket{le=…}`` + ``_sum`` + ``_count``."""
        lines: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, child in m.items():
                base = _fmt_labels(m.labelnames, key)
                if m.kind == "histogram":
                    assert isinstance(child, Histogram)
                    for bound, running in child.cumulative():
                        le = "+Inf" if math.isinf(bound) else repr(bound)
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels(m.labelnames, key, (('le', le),))}"
                            f" {running}")
                    with child._lock:
                        hsum, hcount = child.sum, child.count
                    lines.append(f"{name}_sum{base} {hsum}")
                    lines.append(f"{name}_count{base} {hcount}")
                else:
                    lines.append(f"{name}{base} {child.value}")
        return "\n".join(lines) + "\n"


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every layer records into."""
    return _default_registry


_PROCESS_START = time.time()


def _git_sha() -> str:
    """Best-effort build identity: the deploy platforms' env stamps
    first (``RENDER_GIT_COMMIT`` / ``GIT_COMMIT_SHA``, as the health
    version field), then the working tree's ``.git/HEAD`` (a file read,
    no subprocess at serve boot)."""
    import os

    for name in ("RENDER_GIT_COMMIT", "GIT_COMMIT_SHA"):
        sha = os.environ.get(name)
        if sha:
            return sha[:40]
    try:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        with open(os.path.join(root, ".git", "HEAD")) as f:
            head = f.read().strip()
        if head.startswith("ref:"):
            with open(os.path.join(root, ".git", head.split(None, 1)[1])) as f:
                return f.read().strip()[:40]
        return head[:40]
    except OSError:
        return "unknown"


def build_info() -> Dict[str, str]:
    """The ``rtpu_build_info`` identity labels as a plain dict (also
    ``/api/version``'s ``build``): the package version, the runtime
    (``torch`` and its version) and the git sha."""
    import torch

    from routest_tpu_torch import __version__ as version

    return {"version": version, "torch": torch.__version__,
            "git_sha": _git_sha()}


def register_build_info(registry: Optional[MetricsRegistry] = None) -> None:
    """Register the standard identity gauges on ``registry`` (default:
    the process registry): ``rtpu_build_info`` — constant 1 with
    version/torch/git-sha labels, the Prometheus ``*_build_info``
    convention — and ``rtpu_process_start_time_seconds``. Idempotent;
    called from serving bring-up."""
    reg = registry if registry is not None else _default_registry
    reg.gauge(
        "rtpu_build_info",
        "Build identity: constant 1, carried in the labels.",
        ("version", "torch", "git_sha"),
    ).labels(**build_info()).set(1)
    reg.gauge(
        "rtpu_process_start_time_seconds",
        "Unix time this process imported the metrics registry.",
    ).set(_PROCESS_START)
