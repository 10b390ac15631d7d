"""The tracing spine: the port's ``obs.trace`` / ``obs.export`` /
``obs.registry`` exemplars / ``utils.logging`` correlation against the
JAX package's on the same calls.

The same span calls (seeded head sampling, the same attrs, errors,
remote parents) give the same span trees and the same Chrome-trace and
JSONL structure once ids, clocks and thread ids are renamed; the tail
sampler keeps the same traces for the same reasons; ``traceparent``
parsing and formatting agree on valid and malformed headers; histogram
exemplars and their OpenMetrics suffixes carry the sampled trace the
same way. The port's batcher nests its four stage spans as the JAX
batcher does, and ``maybe_device_trace`` writes a ``torch.profiler``
Chrome trace for a sampled span (CPU activity: there is no card here),
within its budget, and names a refused capture on the span."""

import json
import os
import random
import threading
import time

import numpy as np
import pytest
import torch

from routest_tpu.obs import export as jexport
from routest_tpu.obs import registry as jregistry
from routest_tpu.obs import trace as jtrace
from routest_tpu.utils import logging as jlogging
from routest_tpu_torch.obs import export as texport
from routest_tpu_torch.obs import registry as tregistry
from routest_tpu_torch.obs import trace as ttrace
from routest_tpu_torch.utils import logging as tlogging

PACKAGES = {"jax": (jtrace, jexport, jregistry, jlogging),
            "torch": (ttrace, texport, tregistry, tlogging)}


@pytest.fixture(scope="module", autouse=True)
def _no_threads_left():
    """Fails the module if a thread its tests started is still alive
    (transient threads of other modules' apps end within seconds)."""
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()]
    deadline = time.monotonic() + 10.0
    for t in left:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not [t.name for t in left if t.is_alive()]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tracers():
    """A fresh, seeded tracer per package, private to the test (a
    process tracer would also record other threads' spans)."""
    out = {}
    for k, mods in PACKAGES.items():
        out[k] = mods[0].Tracer(sample_rate=1.0, buffer_size=512)
        out[k]._rng = random.Random(7)
    return out


def _normalize(spans):
    """Ids → first-seen indexes; clocks and thread ids dropped."""
    ids = {}

    def name(v):
        if v is None:
            return None
        return ids.setdefault(v, len(ids))

    out = []
    for s in spans:
        s = dict(s)
        for k in ("start_unix", "duration_ms", "thread"):
            s.pop(k, None)
        for k in ("trace_id", "span_id", "parent_id"):
            s[k] = name(s.get(k))
        out.append(s)
    return out


def _normalize_chrome(doc):
    ids = {}
    events = []
    for e in doc["traceEvents"]:
        e = dict(e)
        for k in ("ts", "dur", "pid", "tid"):
            e.pop(k)
        args = dict(e["args"])
        for k in ("trace_id", "span_id", "parent_id"):
            v = args.get(k)
            args[k] = None if v is None else ids.setdefault(v, len(ids))
        e["args"] = args
        events.append(e)
    return {"traceEvents": events, "displayTimeUnit": doc["displayTimeUnit"]}


def _workload(mod, tracer):
    """One fixed script of span calls: roots sampled by the seeded coin,
    nested children, an error, a remote parent, an explicit parent."""
    remote = mod.parse_traceparent(
        "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01")
    for i in range(6):
        with tracer.span("root", i=i, path="/api/predict_eta") as r:
            with tracer.span("child", depth=1):
                with tracer.span("grandchild", depth=2) as g:
                    g.set_attr("rows", i * 3)
            try:
                with tracer.span("failing"):
                    raise ValueError("boom")
            except ValueError:
                pass
            r.set_attr("status", 200 + i)
    with tracer.span("replica.request", parent=remote, method="POST"):
        with tracer.span("replica.handler", route="POST /x"):
            pass
    with tracer.span("detached", parent=None):
        pass


@pytest.mark.parametrize("rate", [1.0, 0.5, 0.0])
def test_span_trees_match(tracers, rate):
    spans = {}
    for k, mods in PACKAGES.items():
        tracers[k].sample_rate = rate
        _workload(mods[0], tracers[k])
        spans[k] = tracers[k].buffer.snapshot()
    assert _normalize(spans["torch"]) == _normalize(spans["jax"])
    if rate == 1.0:
        assert len(spans["torch"]) == 6 * 4 + 3


def test_chrome_and_jsonl_structure_match(tracers):
    docs = {}
    for k, mods in PACKAGES.items():
        _workload(mods[0], tracers[k])
        spans = tracers[k].buffer.snapshot()
        docs[k] = (_normalize_chrome(mods[1].to_chrome_trace(spans)),
                   _normalize([json.loads(line) for line in
                               mods[1].to_jsonl(spans).splitlines()]))
    assert docs["torch"] == docs["jax"]


def test_trace_ids_flow_through_the_remote_parent(tracers):
    tr = tracers["torch"]
    ctx = ttrace.parse_traceparent(
        "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01")
    with tr.span("replica.request", parent=ctx) as s:
        headers = {}
        tr.inject(headers)
    assert s.trace_id == "0af7651916cd43dd8448eb211c80319c"
    assert headers["traceparent"].startswith(
        "00-0af7651916cd43dd8448eb211c80319c-")
    assert tr.buffer.snapshot()[0]["parent_id"] == "b7ad6b7169203331"


@pytest.mark.parametrize("header", [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00",
    "  00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-03  ",
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331",
    "garbage", "", None,
])
def test_traceparent_parse_and_format_match(header):
    got = ttrace.parse_traceparent(header)
    want = jtrace.parse_traceparent(header)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.span_id, got.sampled, got.remote) == \
            (want.trace_id, want.span_id, want.sampled, want.remote)
        assert ttrace.format_traceparent(got) == \
            jtrace.format_traceparent(want)


def test_request_ids_share_the_jax_shape():
    assert ttrace.REQUEST_ID_RE.pattern == jtrace.REQUEST_ID_RE.pattern
    for _ in range(20):
        rid = ttrace.mint_request_id()
        assert ttrace.REQUEST_ID_RE.match(rid)
        assert len(rid) == len(jtrace.mint_request_id())


def _tail_records(n_traces):
    """Hand-built finished span records: per trace one child and one
    root, with durations and errors that exercise every verdict."""
    recs = []
    for i in range(n_traces):
        tid = f"{i:032x}"
        err = i % 5 == 0
        recs.append({"name": "child", "trace_id": tid, "span_id": f"{i:015x}a",
                     "parent_id": f"{i:015x}b", "status":
                     "error" if err else "ok", "duration_ms": 1.0,
                     "attrs": {}})
        recs.append({"name": "replica.request", "trace_id": tid,
                     "span_id": f"{i:015x}b", "parent_id": None,
                     "status": "ok", "duration_ms": [5.0, 900.0, 3000.0][i % 3],
                     "attrs": {"path": ["/api/predict_eta", "/api/optimize_route",
                                        "/x"][i % 3],
                               **({"probe": "eta"} if i % 7 == 3 else {})}})
    return recs


@pytest.mark.parametrize("reservoir", [0.0, 0.3, 1.0])
def test_tail_sampler_keeps_the_same_traces(reservoir):
    kept = {}
    for k, mods in PACKAGES.items():
        ts = mods[1].TailSampler(
            thresholds=[("/api/optimize_route", 800.0),
                        ("/api/predict_eta", 300.0)],
            default_slow_ms=1000.0, reservoir=reservoir)
        ts._rng = random.Random(3)
        out = []
        for rec in _tail_records(40):
            v = ts.offer(dict(rec))
            if v is not None:
                out.append((v[0], [s["name"] for s in v[1]]))
        kept[k] = (out, ts.snapshot())
    assert kept["torch"] == kept["jax"]


def test_exemplars_and_openmetrics_suffix_match(tracers):
    texts = {}
    for k, mods in PACKAGES.items():
        reg = mods[2].MetricsRegistry()
        h = reg.histogram("lat_seconds", "Latency.", ("route",))
        with tracers[k].span("req") as s:
            h.labels(route="a").observe(0.004)
            tid = s.trace_id
        tracers[k].sample_rate = 0.0
        with tracers[k].span("unsampled"):
            h.labels(route="a").observe(0.2)   # no exemplar
        snap = reg.snapshot()["lat_seconds"]["series"][0]
        ex = snap["exemplars"]
        assert [e["trace_id"] for e in ex] == [tid]
        text = reg.prometheus_text().replace(tid, "<trace>")
        texts[k] = "\n".join(
            line.rsplit(" ", 1)[0] if "# {" in line else line
            for line in text.splitlines())
        texts[k + "_ex"] = [(e["le"], e["value"]) for e in ex]
    assert texts["torch"] == texts["jax"]
    assert texts["torch_ex"] == texts["jax_ex"]


def test_cumulative_sample_matches():
    samples = {}
    for k, mods in PACKAGES.items():
        reg = mods[2].MetricsRegistry()
        reg.counter("c_total", "C.", ("x",)).labels(x="1").inc(3)
        reg.gauge("g", "G.").set(2.5)
        h = reg.histogram("h_seconds", "H.")
        for v in (0.001, 0.01, 0.3, 7.0):
            h.observe(v)
        samples[k] = reg.cumulative_sample()
    assert samples["torch"] == samples["jax"]


def test_log_lines_carry_trace_ids_and_reach_the_tee(tracers, capsys):
    seen = []
    tlogging.set_log_tee(seen.append)
    try:
        log = tlogging.JsonLogger("t")
        with tracers["torch"].span("req") as s:
            log.info("inside", n=1)
        log.info("outside")
    finally:
        tlogging.set_log_tee(None)
    # the tee is process-wide: other threads' lines may pass it too
    inside, outside = [r for r in seen if r.get("logger") == "t"]
    assert inside["trace_id"] == s.trace_id
    assert inside["span_id"] == s.span_id
    assert "trace_id" not in outside
    err = [json.loads(line) for line in capsys.readouterr().err.splitlines()
           if line.startswith("{")]
    assert [r["trace_id"] for r in err if r.get("event") == "inside"] == \
        [s.trace_id]


def test_batcher_stage_spans_nest_under_concurrency(tracers, monkeypatch):
    from routest_tpu_torch.serve.ml_service import DynamicBatcher

    tracer = tracers["torch"]
    monkeypatch.setattr(ttrace, "_tracer", tracer)   # the batcher's spans
    batcher = DynamicBatcher(lambda x: np.asarray(x)[:, 0],
                             buckets=(8, 64), max_batch=64,
                             max_wait_ms=5.0)
    n_threads = 8
    errs = []

    def worker(i):
        try:
            with tracer.span(f"req{i}"):
                assert len(batcher.submit(
                    np.full((4, 3), i, np.float32))) == 4
        except Exception as e:  # reported below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
    assert not errs and not any(t.is_alive() for t in threads)
    # only these requests' traces (other threads may trace meanwhile)
    mine = {s["trace_id"] for s in tracer.buffer.snapshot()
            if s["name"].startswith("req")}
    spans = [s for s in tracer.buffer.snapshot() if s["trace_id"] in mine]
    by_id = {s["span_id"]: s for s in spans}
    named = {n: [s for s in spans if s["name"] == n]
             for n in ("batcher.queue_wait", "batcher.flush",
                       "batcher.pad", "batcher.device_compute")}
    assert len(named["batcher.queue_wait"]) == n_threads
    assert named["batcher.flush"]
    assert len(named["batcher.device_compute"]) == \
        len(named["batcher.flush"]) == len(named["batcher.pad"])
    for s in named["batcher.device_compute"] + named["batcher.pad"]:
        parent = by_id[s["parent_id"]]
        assert parent["name"] == "batcher.flush"
        assert parent["trace_id"] == s["trace_id"]
    for f in named["batcher.flush"]:
        assert by_id[f["parent_id"]]["name"] == "batcher.queue_wait"
    for w in named["batcher.queue_wait"]:
        assert by_id[w["parent_id"]]["name"].startswith("req")


@pytest.fixture
def device_trace_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("RTPU_OBS_DEVICE_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("RTPU_OBS_DEVICE_TRACE_MAX", "1")
    monkeypatch.setattr(texport, "_device_traces_taken", 0)
    return tmp_path


def test_device_trace_of_a_sampled_span(tracers, device_trace_dir):
    tracer = tracers["torch"]
    ran = []
    with tracer.span("batcher.device_compute") as ds:
        with texport.maybe_device_trace(ds, "cpu"):
            ran.append(torch.ones(64, 64) @ torch.ones(64, 64))
    d = ds.attrs["device_trace_dir"]
    assert os.path.basename(d) == f"torch_{ds.trace_id}_{ds.span_id}"
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert "device_trace_error" not in ds.attrs and ran
    # the budget (1) is spent: the next sampled span runs uncaptured
    with tracer.span("batcher.device_compute") as ds2:
        with texport.maybe_device_trace(ds2, "cpu"):
            pass
    assert "device_trace_dir" not in ds2.attrs


def test_device_trace_refused_while_the_profiler_is_held(
        tracers, device_trace_dir):
    from routest_tpu_torch.utils.profiling import profiler_slot

    ran = []
    with profiler_slot("a kernel count"):
        with tracers["torch"].span("batcher.device_compute") as ds:
            with texport.maybe_device_trace(ds, "cpu"):
                ran.append(1)
    assert ran == [1]
    assert "a kernel count" in ds.attrs["device_trace_error"]
    assert not os.path.exists(
        os.path.join(ds.attrs["device_trace_dir"], "trace.json"))


def test_unsampled_span_takes_no_device_trace(tracers, device_trace_dir):
    tracers["torch"].sample_rate = 0.0
    with tracers["torch"].span("batcher.device_compute") as ds:
        with texport.maybe_device_trace(ds, "cpu"):
            pass
    assert texport._device_traces_taken == 0
    assert not os.listdir(device_trace_dir)
