"""Triggered profiling: the port's ``obs/profiler.py`` against the JAX
package's on the same arm sequences.

Arming answers the same way under the same budgets, spacing and
one-at-a-time rule, and the suppression counts agree; a capture writes
the same bundle files (folded stacks + ``profile.json``) with the same
metadata keys. Under ``RTPU_PROFILE_DEVICE=1`` the port's capture adds a
``torch.profiler`` Chrome trace to the bundle (CPU activity here: there
is no card), and a capture that finds the process's profiler taken
names the refusal in ``profile.json``, in the snapshot and so in
``POST /api/debug/profile``'s answer, while the stack capture still
lands. Captures last 50 ms and every capture thread is joined."""

import json
import os
import threading
import time

import pytest
import torch

from routest_tpu.core.config import ProfileConfig as JProfileConfig
from routest_tpu.core.config import RecorderConfig as JRecorderConfig
from routest_tpu.core.config import \
    load_profile_config as jload_profile_config
from routest_tpu.obs import profiler as jprofiler
from routest_tpu.obs import recorder as jrecorder
from routest_tpu_torch.core.config import (ProfileConfig, RecorderConfig,
                                           load_profile_config)
from routest_tpu_torch.obs import profiler as tprofiler
from routest_tpu_torch.obs import recorder as trecorder
from routest_tpu_torch.utils.profiling import profiler_slot

PACKAGES = {"jax": (jprofiler, JProfileConfig, jrecorder, JRecorderConfig),
            "torch": (tprofiler, ProfileConfig, trecorder, RecorderConfig)}


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


def _profiler(k, tmp_path, **cfg_kw):
    mod, cfg_cls, rec_mod, rec_cfg = PACKAGES[k]
    recorder = rec_mod.FlightRecorder(rec_cfg(dir=str(tmp_path / k),
                                              min_interval_s=0.0,
                                              followup_s=0.0))
    cfg = cfg_cls(**{"duration_s": 0.05, "interval_ms": 5.0,
                     "min_interval_s": 0.0, **cfg_kw})
    kw = {"device": "cpu"} if k == "torch" else {}
    return mod.TriggeredProfiler(cfg, recorder, **kw), recorder


def _join_captures(timeout=10.0):
    for t in threading.enumerate():
        if t.name == "triggered-profiler":
            t.join(timeout)
            assert not t.is_alive()


@pytest.mark.parametrize("cfg_kw,arms", [
    ({"max_captures": 1, "min_interval_s": 3600.0}, 3),
    ({"max_captures": 10, "min_interval_s": 3600.0}, 3),
    ({"enabled": False}, 2),
    ({"max_captures": 2}, 4),
])
def test_arm_answers_match(tmp_path, cfg_kw, arms):
    out = {}
    for k in PACKAGES:
        prof, _ = _profiler(k, tmp_path, **cfg_kw)
        got = []
        for i in range(arms):
            got.append(prof.arm(f"t{i}"))
            got.append(prof.arm(f"t{i}-again"))   # one at a time
            _join_captures()
        snap = prof.snapshot()
        snap.pop("last_bundle")
        snap.pop("device_trace_error", None)
        out[k] = (got, snap)
    assert out["torch"] == out["jax"]


def test_capture_bundles_match(tmp_path):
    out = {}
    for k in PACKAGES:
        prof, _ = _profiler(k, tmp_path)
        assert prof.arm("unit_test", {"why": "test"})
        _join_captures()
        bundle = prof.snapshot()["last_bundle"]
        meta = json.load(open(os.path.join(bundle, "profile.json")))
        folded = open(os.path.join(bundle, "profile.folded")).read()
        lines = [ln for ln in folded.splitlines() if ln.strip()]
        assert lines and all(ln.rsplit(" ", 1)[1].isdigit()
                             for ln in lines)
        assert meta["samples"] > 0 and meta["top_self"]
        out[k] = (sorted(os.listdir(bundle)), sorted(meta),
                  meta["trigger"], meta["detail"], meta["component"])
    assert out["torch"] == out["jax"]


def test_slo_warn_edge_arms_a_capture(tmp_path):
    prof, _ = _profiler("torch", tmp_path)
    prof.on_slo_edge("latency:/api/predict_eta",
                     {"from": "ok", "to": "warn", "burn_fast": 9.0,
                      "burn_slow": 7.0, "route": "/api/predict_eta",
                      "ignored": 1})
    _join_captures()
    snap = prof.snapshot()
    assert snap["last_reason"] == "slo_warn"
    meta = json.load(open(os.path.join(snap["last_bundle"],
                                       "profile.json")))
    assert meta["detail"] == {"slo": "latency:/api/predict_eta",
                              "from": "ok", "to": "warn",
                              "burn_fast": 9.0, "burn_slow": 7.0,
                              "route": "/api/predict_eta"}


def test_device_trace_lands_in_the_bundle(tmp_path):
    prof, _ = _profiler("torch", tmp_path, device_trace=True)
    stop = threading.Event()

    def work():   # ops for the capture to see
        a = torch.ones(32, 32)
        while not stop.is_set():
            a = a @ torch.ones(32, 32) / 32.0
            time.sleep(0.001)

    worker = threading.Thread(target=work, name="matmuls")
    worker.start()
    try:
        assert prof.arm("manual_api", wait_start_s=30.0)
        assert prof.snapshot()["device_trace_error"] is None
        _join_captures()
    finally:
        stop.set()
        worker.join(timeout=5.0)
    bundle = prof.snapshot()["last_bundle"]
    assert "device_trace.json" in os.listdir(bundle)
    with open(os.path.join(bundle, "device_trace.json")) as f:
        doc = json.load(f)
    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
    meta = json.load(open(os.path.join(bundle, "profile.json")))
    assert meta["device_trace_error"] is None
    # the working copy under the recorder's profiles/ dir is gone
    root = os.path.join(str(tmp_path / "torch"), "profiles")
    assert not os.path.isdir(root) or not any(
        os.path.exists(os.path.join(root, d, "trace.json"))
        for d in os.listdir(root))


def test_refused_device_trace_is_named(tmp_path):
    prof, _ = _profiler("torch", tmp_path, device_trace=True)
    with profiler_slot("a sampled span's device trace"):
        assert prof.arm("manual_api", wait_start_s=30.0)
        err = prof.snapshot()["device_trace_error"]
        _join_captures()
    assert "ProfilerBusy" in err and "sampled span" in err
    bundle = prof.snapshot()["last_bundle"]
    assert "device_trace.json" not in os.listdir(bundle)
    meta = json.load(open(os.path.join(bundle, "profile.json")))
    assert meta["device_trace_error"] == err and meta["samples"] > 0


@pytest.mark.parametrize("env", [
    {}, {"RTPU_PROFILE": "0", "RTPU_PROFILE_DEVICE": "1",
         "RTPU_PROFILE_MAX": "x", "RTPU_PROFILE_DURATION_S": "0.5"},
])
def test_config_loader_matches(env):
    assert load_profile_config(env).__dict__ == \
        jload_profile_config(env).__dict__
