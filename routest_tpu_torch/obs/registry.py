"""Process-wide metrics registry: counters, gauges, log-bucket histograms.

Copied from ``routest_tpu/obs/registry.py``: one registry per process
(``get_registry()``) behind one API with two export formats, a JSON
snapshot and Prometheus exposition text (``text/plain; version=0.0.4``).
The batcher, the fast lane, dispatch and the WSGI layer register their
metrics here, and ``register_build_info`` the build-identity gauges
(labelled with ``torch`` and its version where the JAX package names
``jax``). Each histogram bucket keeps its most recent exemplar: the
trace id of an observation made inside a sampled trace.

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

# Exemplar capture reads the ambient trace context lazily (obs.trace
# imports nothing from this module, so the deferred import cannot
# cycle; deferring keeps registry importable standalone).
_current_context = None


def _ambient_trace_context():
    global _current_context
    if _current_context is None:
        from routest_tpu_torch.obs.trace import current_context

        _current_context = current_context
    return _current_context()

# Latency seconds, 500 µs … 60 s: the serving stack's observed range
# (sub-ms batcher waits up to multi-second cold road solves).
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
    __slots__ = ("buckets", "counts", "sum", "count", "exemplars")

    def __init__(self, buckets: Sequence[float]) -> None:
        super().__init__()
        self.buckets = tuple(buckets)          # upper bounds, ascending
        self.counts = [0] * (len(self.buckets) + 1)  # + the +Inf bucket
        self.sum = 0.0
        self.count = 0
        # Per-bucket exemplars: the most recent (trace_id, value,
        # unix_ms) observation made inside a SAMPLED trace — the link
        # from "p99 spiked" to a dumpable trace (/api/trace?trace_id=).
        self.exemplars: List[Optional[Tuple[str, float, int]]] = \
            [None] * (len(self.buckets) + 1)

    def observe(self, v: float) -> None:
        if not math.isfinite(v):
            return  # a NaN observation would poison sum forever
        i = bisect.bisect_left(self.buckets, v)
        ctx = _ambient_trace_context()
        exemplar = (ctx.trace_id, v, int(time.time() * 1000)) \
            if ctx is not None and ctx.sampled else None
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            if exemplar is not None:
                self.exemplars[i] = exemplar

    def exemplar_list(self) -> List[dict]:
        """Non-empty bucket exemplars, one dict per bucket:
        ``{le, trace_id, value, unix_ms}`` (``le`` = the bucket's upper
        bound; the overflow bucket reports ``inf``)."""
        with self._lock:
            pairs = list(zip(list(self.buckets) + [math.inf],
                             self.exemplars))
        return [{"le": le, "trace_id": ex[0], "value": round(ex[1], 6),
                 "unix_ms": ex[2]}
                for le, ex in pairs if ex is not None]

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
        empty; the top bucket clamps to its lower bound + sum/count cap
        rather than inventing an upper edge for +Inf."""
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
        """Registered family by name, or None (read-side consumers —
        the SLO engine's rollup sources — must not create families as a
        side effect of looking)."""
        with self._lock:
            return self._metrics.get(name)

    # ── export ────────────────────────────────────────────────────────

    def cumulative_sample(self) -> dict:
        """Raw cumulative state for delta-based consumers (the timeline
        store): ``name → {kind, labelnames, buckets, series}`` where
        ``series`` maps the label-value tuple to the counter/gauge
        value or, for histograms, ``(bucket counts tuple, sum, count)``.
        Rawer and cheaper than :meth:`snapshot` — no quantile math, no
        exemplar copies — because it runs on every timeline tick."""
        out = {}
        with self._lock:
            metrics = list(self._metrics.items())
        for name, m in metrics:
            series = {}
            for key, child in m.items():
                if m.kind == "histogram":
                    assert isinstance(child, Histogram)
                    with child._lock:
                        series[key] = (tuple(child.counts), child.sum,
                                       child.count)
                else:
                    series[key] = child.value
            out[name] = {"kind": m.kind, "labelnames": m.labelnames,
                         "buckets": m.buckets, "series": series}
        return out

    def snapshot(self) -> dict:
        """JSON-shaped dump: name → {type, help, series:[{labels, …}]}.
        Histogram series carry count/sum plus interpolated p50/p95/p99
        (ms-free: same unit as observed)."""
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
                        exemplars = child.exemplar_list()
                        if exemplars:
                            entry["exemplars"] = exemplars
                    series.append(entry)
                else:
                    series.append({"labels": labels, "value": child.value})
            out[name] = {"type": m.kind, "help": m.help, "series": series}
        return out

    def prometheus_text(self) -> str:
        """Exposition format 0.0.4 + OpenMetrics exemplar annotations:
        HELP/TYPE per family; histograms as cumulative
        ``_bucket{le=…}`` + ``_sum`` + ``_count``, each bucket carrying
        its most recent sampled exemplar as the OpenMetrics
        ``# {trace_id="…"} value timestamp`` suffix — the link from a
        p99 bucket to a dumpable trace survives the text exposition,
        not only the JSON snapshot (exemplar-aware scrapers parse it;
        classic parsers that reject exemplars should scrape the JSON
        surface instead — docs/OBSERVABILITY.md "Exemplars")."""
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
                    bounds = list(child.buckets) + [math.inf]
                    with child._lock:
                        counts = list(child.counts)
                        exemplars = list(child.exemplars)
                        hsum, hcount = child.sum, child.count
                    running = 0
                    for bound, c, ex in zip(bounds, counts, exemplars):
                        running += c
                        le = "+Inf" if math.isinf(bound) else repr(bound)
                        line = (
                            f"{name}_bucket"
                            f"{_fmt_labels(m.labelnames, key, (('le', le),))}"
                            f" {running}")
                        if ex is not None:
                            line += (f' # {{trace_id="{ex[0]}"}} '
                                     f"{ex[1]:g} {ex[2] / 1000.0:.3f}")
                        lines.append(line)
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
    first (the names ``core/config.py`` already honors for the health
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
