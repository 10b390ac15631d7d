"""The flight recorder: the port's ``obs/recorder.py`` against the JAX
package's on the same records and triggers.

The same requests, logs and events give bundles with the same files and
the same rows (clocks aside); 5xx bursts and deadline spikes trigger at
the same record, rate limiting suppresses the same triggers, bundles
prune under the same bounds, and a registered change ledger ranks the
same suspects into ``suspects.json`` and ``/api/incidents``' roll-up.
The configuration fingerprint snapshots the port's own runtime
prefixes (``CUDA_``, ``PYTORCH_``, ``TORCH_``, where the JAX package
snapshots ``JAX_`` and ``XLA_``), secrets redacted. Every recorder
writes under the test's temporary directory."""

import json
import os
import signal
import threading
import time

import pytest
import torch

from routest_tpu.core.config import LedgerConfig as JLedgerConfig
from routest_tpu.core.config import RecorderConfig as JRecorderConfig
from routest_tpu.core.config import \
    load_recorder_config as jload_recorder_config
from routest_tpu.obs import ledger as jledger
from routest_tpu.obs import recorder as jrecorder
from routest_tpu.obs import trace as jtrace
from routest_tpu_torch.core.config import (LedgerConfig, RecorderConfig,
                                           load_recorder_config)
from routest_tpu_torch.obs import ledger as tledger
from routest_tpu_torch.obs import recorder as trecorder
from routest_tpu_torch.obs import trace as ttrace

PACKAGES = {"jax": (jrecorder, JRecorderConfig, jledger, JLedgerConfig,
                    jtrace),
            "torch": (trecorder, RecorderConfig, tledger, LedgerConfig,
                      ttrace)}


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


@pytest.fixture(autouse=True)
def _empty_tracers():
    """Bundles carry the process tracer's spans: give both packages an
    empty one, so the span rings compare."""
    old = {k: mods[4]._tracer for k, mods in PACKAGES.items()}
    for mods in PACKAGES.values():
        mods[4].configure_tracer(mods[4].Tracer(sample_rate=1.0))
    yield
    for k, mods in PACKAGES.items():
        mods[4]._tracer = old[k]


def _recorder(k, tmp_path, **kw):
    mod, cfg_cls = PACKAGES[k][:2]
    cfg = dict(dir=str(tmp_path / k), min_interval_s=0.0, burst_5xx=3,
               burst_window_s=5.0, deadline_spike=4, followup_s=0.0)
    cfg.update(kw)
    return mod.FlightRecorder(cfg_cls(**cfg))


def _bundles(root):
    if not os.path.isdir(root):
        return []
    return sorted(d for d in os.listdir(root) if d.startswith("pm_"))


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _feed(rec):
    statuses = [200, 200, 503, 200, 500, 502, 504, 504, 504, 504, 200,
                500, 500, 500]
    bundles = []
    for i, status in enumerate(statuses):
        rec.record_request(tier="replica", method="POST",
                           path=f"/api/r{i % 3}", status=status,
                           duration_ms=1.5 * i, request_id=f"rid{i}",
                           trace_id=f"{i:032x}",
                           deadline_ms=500.0 if i % 2 else None,
                           extra={"probe": "eta"} if i == 1 else None)
        bundles.append(rec.bundles_written)
    rec.add_log({"event": "something_happened", "trace_id": "t" * 32})
    rec.record_event("autoscale", {"to": 3})
    return bundles


def _strip_rows(rows):
    return [{k: v for k, v in r.items() if k not in ("ts",)} for r in rows]


def test_triggers_and_bundle_rows_match(tmp_path):
    out = {}
    for k in PACKAGES:
        rec = _recorder(k, tmp_path)
        fired = _feed(rec)
        path = rec.trigger("unit_test", {"why": "test"}, force=True)
        files = sorted(os.listdir(path))
        manifest = json.load(open(os.path.join(path, "manifest.json")))
        rows = {name: _strip_rows(_read_jsonl(os.path.join(path, name)))
                for name in ("requests.jsonl", "logs.jsonl",
                             "events.jsonl", "spans.jsonl")}
        snap = rec.snapshot()
        snap.pop("dir")
        out[k] = (fired, files, rows, manifest["reason"],
                  manifest["detail"], manifest["counts"], snap)
    assert out["torch"] == out["jax"]
    fired, *_ = out["torch"]
    assert fired[-1] >= 2          # a 5xx burst and a deadline spike


def test_rate_limit_suppresses_the_same_triggers(tmp_path):
    out = {}
    for k in PACKAGES:
        rec = _recorder(k, tmp_path, min_interval_s=60.0)
        got = [rec.trigger("first") is not None,
               rec.trigger("second") is not None,
               rec.trigger("forced", force=True) is not None]
        _feed(rec)
        out[k] = (got, rec.bundles_written, rec.triggers_suppressed)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == [True, False, True]


def test_bundles_prune_to_the_bound(tmp_path):
    for k in PACKAGES:
        rec = _recorder(k, tmp_path, max_bundles=3)
        for i in range(5):
            assert rec.trigger(f"t{i}", force=True)
            time.sleep(0.002)   # bundle names carry a millisecond stamp
        assert len(_bundles(str(tmp_path / k))) == 3


def _ledger(k, now):
    led_mod, led_cfg = PACKAGES[k][2:4]
    led = led_mod.ChangeLedger(led_cfg(publish=False, window_s=600.0))
    led._source = "src"
    led.record("model.swap", replica="r1", detail={"generation": 2},
               ts=now - 30)
    led.record("live.flip", detail={"epoch": 5}, ts=now - 300)
    led.record("model.swap", replica="r2", ts=now - 10)
    led.record("model.swap", replica="r1", ts=now - 5000)  # too old
    return led


def test_suspects_and_incidents_match(tmp_path):
    out = {}
    now = time.time()
    for k in PACKAGES:
        rec = _recorder(k, tmp_path)
        rec.register_change_ledger(_ledger(k, now))
        path = rec.trigger("slo_page", {"slo": "availability:/api/x",
                                        "replica": "r1"})
        with open(os.path.join(path, "suspects.json")) as f:
            suspects = json.load(f)
        for s in suspects["suspects"]:
            s.pop("age_s")
            s.pop("proximity")
            s.pop("score")
        incidents = rec.incidents_snapshot()
        for inc in incidents:
            inc.pop("ts")
            inc.pop("bundle")
            for s in inc["suspects"]:
                for key in ("age_s", "proximity", "score"):
                    s.pop(key)
        out[k] = (suspects, incidents)
    assert out["torch"] == out["jax"]
    ranked = [s["event"]["replica"] for s in out["torch"][0]["suspects"]
              if "replica" in s["event"]]
    assert ranked[0] == "r1"


def test_config_fingerprint_takes_the_port_prefixes(monkeypatch):
    for name, value in (("CUDA_VISIBLE_DEVICES", "0"),
                        ("PYTORCH_CUDA_ALLOC_CONF", "expandable"),
                        ("TORCH_LOGS", "x"), ("JAX_PLATFORMS", "cpu"),
                        ("XLA_FLAGS", "--x"), ("RTPU_SECRET_TOKEN", "s3"),
                        ("ROUTEST_DEVICE", "cpu")):
        monkeypatch.setenv(name, value)
    env = trecorder._config_fingerprint()["env"]
    assert env["CUDA_VISIBLE_DEVICES"] == "0"
    assert env["PYTORCH_CUDA_ALLOC_CONF"] == "expandable"
    assert env["TORCH_LOGS"] == "x" and env["ROUTEST_DEVICE"] == "cpu"
    assert env["RTPU_SECRET_TOKEN"] == "<redacted>"
    assert "JAX_PLATFORMS" not in env and "XLA_FLAGS" not in env
    jenv = jrecorder._config_fingerprint()["env"]
    assert "JAX_PLATFORMS" in jenv and "CUDA_VISIBLE_DEVICES" not in jenv


@pytest.mark.parametrize("env", [
    {}, {"RTPU_RECORDER": "0", "RTPU_RECORDER_DIR": "/x",
         "RTPU_RECORDER_BURST_5XX": "nope", "RTPU_RECORDER_FOLLOWUP_S": "0"},
])
def test_config_loader_matches(env):
    assert load_recorder_config(env).__dict__ == \
        jload_recorder_config(env).__dict__


def test_process_recorder_tees_the_logs(tmp_path):
    from routest_tpu_torch.utils.logging import JsonLogger

    rec = _recorder("torch", tmp_path)
    trecorder.configure_recorder(rec)
    try:
        with ttrace.get_tracer().span("req") as s:
            JsonLogger("t", stream=open(os.devnull, "w")).info("inside")
    finally:
        trecorder.configure_recorder(None)
    path = rec.trigger("manual", force=True)
    logs = [r for r in _read_jsonl(os.path.join(path, "logs.jsonl"))
            if r.get("event") == "inside"]   # the tee is process-wide
    assert [r["trace_id"] for r in logs] == [s.trace_id]


def test_sigusr2_writes_a_bundle(tmp_path):
    rec = _recorder("torch", tmp_path)
    previous = signal.getsignal(signal.SIGUSR2)
    trecorder.configure_recorder(rec)
    try:
        assert trecorder.install_sigusr2_trigger()
        os.kill(os.getpid(), signal.SIGUSR2)
        deadline = time.monotonic() + 10.0
        while rec.bundles_written == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        signal.signal(signal.SIGUSR2, previous)
        trecorder.configure_recorder(None)
    assert rec.bundles_written == 1
    assert "sigusr2" in _bundles(str(tmp_path / "torch"))[0]
