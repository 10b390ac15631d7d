"""The port's acceptance scripts (``scripts/bench_{fleet,rollout,probing,
region_failover}_cuda.py`` and ``bench_pace_cuda.py``) against the JAX
scripts they port, on the CPU: each imports with neither ``jax`` nor
``routest_tpu`` loaded, answers ``--help`` and exits 2 without a card
and without ``--cpu``; their pure helpers give the JAX scripts' results
on the same inputs (the region failover's ``_median_ratio`` and
``_tracker_body``, the harness's ``judge_fault_bundle`` with and
without ``require_dimensions`` and ``zero_pages``); and the rollout
forge's artifacts are the JAX forge's bytes, each bad one rejected by
the port's swap gate with the generation unchanged."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS_DIR = os.path.join(REPO, "scripts")
ARTIFACT = os.path.join(REPO, "artifacts", "eta_mlp.msgpack")
SCRIPTS = ("bench_fleet_cuda.py", "bench_rollout_cuda.py",
           "bench_probing_cuda.py", "bench_region_failover_cuda.py",
           "bench_pace_cuda.py")


def _load(name):
    """A script as a module, by path (``scripts/`` on ``sys.path`` for
    its sibling imports)."""
    if SCRIPTS_DIR not in sys.path:
        sys.path.append(SCRIPTS_DIR)
    key = f"_acceptance_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(SCRIPTS_DIR, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


# ── the scripts as programs ──────────────────────────────────────────


def test_scripts_import_no_jax():
    code = (
        "import importlib.util, os, sys\n"
        f"repo = {REPO!r}\n"
        "sys.path.insert(0, os.path.join(repo, 'scripts'))\n"
        f"for name in {SCRIPTS!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name[:-3], os.path.join(repo, 'scripts', name))\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import load_test_cuda, bench_dispatch_cuda\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'routest_tpu.')) or m == 'routest_tpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_help(script):
    out = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS_DIR, script), "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--cpu" in out.stdout and "--out" in out.stdout


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_refuses_without_a_card(script, tmp_path):
    out_path = tmp_path / "record.json"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS_DIR, script),
         "--out", str(out_path)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 2, out.stderr[-2000:]
    assert "no CUDA device" in out.stderr and "--cpu" in out.stderr
    assert not out_path.exists()


# ── region failover's helpers ────────────────────────────────────────


@pytest.mark.parametrize("argv,seconds", [
    ([], 36.0), (["--quick"], 36.0), (["--quick", "--fault-seconds", "24"],
                                      24.0), (["--fault-seconds", "18"], 18.0)])
def test_fleet_fault_segment_length(argv, seconds):
    # --quick shortens the load phases but never the fault segment
    args = _load("bench_fleet_cuda").build_parser().parse_args(argv)
    assert args.fault_seconds == seconds


class _StubProc:
    pid = 4242

    def send_signal(self, sig):
        self.sig = sig


class _StubSupervisor:
    """r0 restarts ``up_after`` seconds after its kill (never if None)."""

    def __init__(self, up_after):
        self.proc = _StubProc()
        self._replicas = [types.SimpleNamespace(proc=self.proc, port=1)]
        self.up_after = up_after
        self.killed_at = None

    def replica_status(self, i):
        if self.killed_at is None and hasattr(self.proc, "sig"):
            self.killed_at = time.monotonic()
        up = (self.up_after is not None and self.killed_at is not None
              and time.monotonic() - self.killed_at >= self.up_after)
        return {"restarts": 1 if up else 0}


@pytest.mark.parametrize("up_after,back", [(0.0, True), (None, False),
                                           (3.5, False)])
def test_fleet_fault_segment_reads_the_tail_after_the_victim(
        monkeypatch, up_after, back):
    """The tail is read from max(kill + 2, end - 3) s: a victim up later
    than that (or never) leaves ``victim_back_before_tail`` false, so a
    recovered throughput of the survivor alone does not pass."""
    bf = _load("bench_fleet_cuda")
    sup = _StubSupervisor(up_after)
    monkeypatch.setattr(bf, "_up", lambda port: True)
    monkeypatch.setattr(bf, "RESTART_READ_ON_S", 3.0)
    monkeypatch.setattr(bf.harness, "post",
                        lambda *a, **k: time.sleep(0.01))
    gw = types.SimpleNamespace(snapshot=lambda: {
        "fleet": {"retries": 0, "restarts": 1}, "replicas": {}})
    fault = bf.fault_injection_segment(sup, gw, "http://stub", 3.0,
                                       n_threads=2)
    assert fault["killed_replica"]["at_second"] == 1
    assert fault["tail_from_s"] == 3
    assert (fault["victim_up_again_s"] is None) == (up_after is None)
    assert fault["victim_back_before_tail"] is back
    assert fault["requests_err"] == 0


def test_region_failover_constants_and_helpers_equal_jax():
    jrf, trf = _load("bench_region_failover"), \
        _load("bench_region_failover_cuda")
    for name in ("DRIVERS", "JAM_SPEED_FACTOR", "JAM_WIDTH_M", "JAM_RATIO",
                 "CALM_RATIO", "CONVERGE_BOUND_S", "PAGE_BOUND_S",
                 "SLO_RECOVER_BOUND_S", "CATCHUP_BOUND_S", "CLEAN_S",
                 "STALE_BOUND_S", "K_WRITES", "SLO_FAST_S", "SLO_SLOW_S"):
        assert getattr(trf, name) == getattr(jrf, name), name
    rng = np.random.default_rng(11)
    for n in (5, 64, 1000):
        base = rng.uniform(0.0, 50.0, n)
        base[rng.random(n) < 0.1] = 0.0          # the 1e-6 floor
        now = base * rng.uniform(0.5, 4.0, n)
        idx = rng.choice(n, size=max(1, n // 3), replace=False)
        assert trf._median_ratio(base, now, idx) \
            == jrf._median_ratio(base, now, idx)
    for i in (0, 1, 7, 23, 24, 1000):
        assert json.dumps(trf._tracker_body(i)) \
            == json.dumps(jrf._tracker_body(i))


# ── probing's helpers ────────────────────────────────────────────────


def _failure(rid, *, request=True, served=True, expected=True,
             divergence=0.5, dimensions=None, verdict="divergent"):
    f = {"probe": "fanout", "verdict": verdict, "replicas": [rid]}
    if request:
        f["request"] = {"path": "/api/predict_eta_batch"}
    if served:
        f["served"] = [1.0, 2.0]
    if expected:
        f["expected"] = [1.0, 2.5]
    if divergence is not None:
        f["divergence"] = divergence
    if dimensions is not None:
        f["dimensions"] = dimensions
    return f


BUNDLE_LISTS = {
    "none": [],
    "other_replica": [{"name": "pm_1_correctness", "evidence": {
        "replicas": ["r0"], "failures": [_failure("r0")]}}],
    "divergent_answer": [{"name": "pm_2_correctness", "evidence": {
        "replicas": ["r2"], "failures": [_failure("r2")]}}],
    "epoch_skew_last": [{"name": "pm_3_correctness", "evidence": {
        "replicas": ["r2"], "failures": [
            _failure("r2"),
            _failure("r2", expected=False, divergence=None,
                     dimensions=["epoch"], verdict="skew")]}}],
    "epoch_skew_first": [
        {"name": "pm_4_correctness", "evidence": {
            "replicas": ["r2"], "failures": [
                _failure("r2", expected=False, divergence=None,
                         dimensions=["epoch", "model"], verdict="skew"),
                _failure("r2")]}}],
    "not_embedded": [{"name": "pm_5_correctness", "evidence": {
        "replicas": ["r2"], "failures": [
            _failure("r2", served=False),
            _failure("r2", expected=False, divergence=None,
                     dimensions=["model"], verdict="skew")]}}],
    "no_failures": [{"name": "pm_6_correctness", "evidence": {
        "replicas": ["r2"]}}],
}


@pytest.mark.parametrize("require", [None, ("epoch",), ("reach", "model")])
@pytest.mark.parametrize("bundles", sorted(BUNDLE_LISTS))
def test_judge_fault_bundle_equals_jax(bundles, require):
    jbp, h = _load("bench_probing"), _load("cuda_harness")
    lst = BUNDLE_LISTS[bundles]
    for rid in ("r0", "r2"):
        assert h.judge_fault_bundle(lst, rid, require_dimensions=require) \
            == jbp.judge_fault_bundle(lst, rid, require_dimensions=require)
    if require is None:
        # the callers that pass no dimensions get what they got before
        assert h.judge_fault_bundle(lst, "r2") \
            == jbp.judge_fault_bundle(lst, "r2")


def _write_bundle(root, name, evidence):
    path = os.path.join(root, name)
    os.makedirs(path)
    with open(os.path.join(path, "probe_evidence.json"), "w") as f:
        json.dump(evidence, f)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"reason": "correctness_page", "detail": {"n": 1}}, f)


@pytest.mark.parametrize("states,with_bundle", [
    (("ok", "ok"), False), (("ok", "page"), False), (("ok", "ok"), True),
    (("warn", "ok"), True)])
def test_zero_pages_equals_jax(tmp_path, states, with_bundle):
    jbp, h = _load("bench_probing"), _load("cuda_harness")
    root = str(tmp_path / "pm")
    os.makedirs(root)
    _write_bundle(root, "pm_1_other_page", {"replicas": ["r0"]})
    if with_bundle:
        _write_bundle(root, "pm_2_correctness_page_1",
                      {"replicas": ["r1"], "failures": [_failure("r1")]})
    snap = {"objectives": {"correctness:golden": {"state": states[0]},
                           "correctness:fanout": {"state": states[1]}}}
    prober = types.SimpleNamespace(
        slo=types.SimpleNamespace(snapshot=lambda: snap))
    got = h.zero_pages(prober, root)
    assert got == jbp.zero_pages(prober, root)
    assert got["ok"] is (states == ("ok", "ok") and not with_bundle)
    assert h.correctness_bundles(root) == jbp.correctness_bundles(root)


def test_probing_constants_equal_jax():
    jbp, tbp, h = (_load("bench_probing"), _load("bench_probing_cuda"),
                   _load("cuda_harness"))
    for name in ("SWAP_MAX_DIV_MIN", "PROBE_INTERVAL_S", "DETECT_BOUND_S",
                 "OVERHEAD_PCT", "OVERHEAD_FLOOR_MS"):
        assert getattr(tbp, name) == getattr(jbp, name), name
    assert (h.PROBE_FAST_S, h.PROBE_SLOW_S) == (jbp.PROBE_FAST_S,
                                               jbp.PROBE_SLOW_S)


def test_scaled_artifact_equals_the_jax_scaling(tmp_path):
    import jax

    from routest_tpu.train.checkpoint import load_model, save_model

    tbp = _load("bench_probing_cuda")
    for factor in (1.5, 1.0 + 1e-4):
        model, params = load_model(ARTIFACT)
        want = str(tmp_path / f"jax_{factor}.msgpack")
        save_model(want, model, jax.tree_util.tree_map(
            lambda x: x * factor, params))
        got = str(tmp_path / f"port_{factor}.msgpack")
        tbp._scaled_artifact(ARTIFACT, got, factor)
        with open(got, "rb") as g, open(want, "rb") as w:
            assert g.read() == w.read(), factor


# ── the rollout forge ────────────────────────────────────────────────


@pytest.fixture(scope="module")
def forges(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_forge"))
    tdir = str(tmp_path_factory.mktemp("port_forge"))
    return (_load("bench_rollout").ModelForge(jdir),
            _load("bench_rollout_cuda").ModelForge(tdir))


VARIANTS = {
    "perturbed": lambda f: f.perturbed("v.msgpack", 2e-4),
    "nan": lambda f: f.nan("v.msgpack"),
    "divergent": lambda f: f.divergent("v.msgpack"),
    "corrupt": lambda f: f.corrupt("v.bin"),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forge_variants_equal_jax_bitwise(forges, variant):
    jforge, tforge = forges
    with open(VARIANTS[variant](jforge), "rb") as f:
        want = f.read()
    with open(VARIANTS[variant](tforge), "rb") as f:
        got = f.read()
    assert got == want


@pytest.mark.parametrize("variant,accepted", [
    ("perturbed", True), ("nan", False), ("divergent", False),
    ("corrupt", False)])
def test_port_swap_gate_on_forge_variants(forges, tmp_path, variant,
                                          accepted):
    from routest_tpu_torch.core.config import ServeConfig
    from routest_tpu_torch.serve.ml_service import EtaService

    _, tforge = forges
    live = str(tmp_path / "live.msgpack")
    shutil.copyfile(ARTIFACT, live)
    svc = EtaService(ServeConfig(batch_buckets=(8, 64)), model_path=live,
                     device="cpu")
    try:
        assert svc.available
        gen0, fp0 = svc.generation, svc.fingerprint
        shutil.copyfile(VARIANTS[variant](tforge), f"{live}.stage")
        os.replace(f"{live}.stage", live)
        st = os.stat(live)
        os.utime(live, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
        assert svc.reload_if_changed() is accepted
        if accepted:
            assert svc.generation > gen0 and svc.fingerprint != fp0
        else:
            assert svc.available and svc.generation == gen0
            assert svc.fingerprint == fp0
            eta, _ = svc.predict_eta_minutes(
                weather="Sunny", traffic="Low", distance_m=10_000,
                pickup_time=None)
            assert eta is not None and np.isfinite(eta)
    finally:
        close = getattr(svc, "close", None)
        if close is not None:
            close()
