"""The port's acceptance proofs (``scripts/bench_{chaos,slo_detection,
efficiency,live_traffic}_cuda.py``) against the JAX scripts they port,
on the CPU: each imports with neither ``jax`` nor ``routest_tpu``
loaded, answers ``--help`` and exits 2 without a card and without
``--cpu``; its scenario tables, bodies, chaos specs, bounds, check
names and the staleness-bound formula are the JAX script's; and each
judge the twins keep a copy of gives the JAX judge's verdict on the
JAX records' own inputs (``artifacts/{chaos_matrix,slo_detection,
efficiency,live_traffic}.json``), scenario by scenario. No fleet runs
here: the ``--cpu --quick`` rehearsals are ``slow``."""

import ast
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS_DIR = os.path.join(REPO, "scripts")
ARTIFACTS = os.path.join(REPO, "artifacts")
TWINS = {"chaos": "bench_chaos", "slo": "bench_slo_detection",
         "efficiency": "bench_efficiency", "live": "bench_live_traffic"}
SCRIPTS = tuple(f"{name}_cuda.py" for name in TWINS.values())
RECORDS = {"chaos": "chaos_matrix.json", "slo": "slo_detection.json",
           "efficiency": "efficiency.json", "live": "live_traffic.json"}


def _load(name):
    """A script as a module, by path (``scripts/`` on ``sys.path`` for
    its sibling imports)."""
    if SCRIPTS_DIR not in sys.path:
        sys.path.append(SCRIPTS_DIR)
    key = f"_proof_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(SCRIPTS_DIR, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def _twin(kind):
    return _load(f"{TWINS[kind]}_cuda")


def _source(kind):
    with open(os.path.join(SCRIPTS_DIR, f"{TWINS[kind]}.py")) as f:
        return f.read()


def _record(kind):
    with open(os.path.join(ARTIFACTS, RECORDS[kind])) as f:
        return json.load(f)


def _argparse_defaults(src):
    """``{"--flag": default}`` of every ``add_argument`` call with a
    literal default in a script's source."""
    out = {}
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "add_argument":
            flag = node.args[0].value
            for kw in node.keywords:
                if kw.arg == "default":
                    try:
                        out[flag] = ast.literal_eval(kw.value)
                    except ValueError:
                        pass     # a computed default (a path)
    return out


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
    assert "--quick" in out.stdout


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_refuses_without_a_card(script, tmp_path):
    out_path = tmp_path / "record.json"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS_DIR, script), "--quick",
         "--out", str(out_path)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 2, out.stderr[-2000:]
    assert "no CUDA device" in out.stderr and "--cpu" in out.stderr
    assert not out_path.exists()


# ── scenario tables, bodies, specs, bounds ───────────────────────────


def test_chaos_tables_equal_jax():
    jc, tc, src = _load("bench_chaos"), _twin("chaos"), _source("chaos")
    assert list(tc.SCENARIOS) == list(jc.SCENARIOS)
    for name in ("PREDICT_BODY", "ROUTE_BODY", "TRACKER_BODY"):
        assert getattr(tc, name) == getattr(jc, name), name
    # the injections, gateway settings and loads the JAX scenarios
    # write inline
    for spec in (tc.SLOW_SPEC, tc.STORE_SPEC, tc.DEVICE_SPEC):
        assert f'"{spec}"' in src, spec
    assert f"latency=1.0/{tc.SLOW_MS}" in tc.SLOW_SPEC
    for key, value in tc.STORE_ENV.items():
        assert f'"{key}": "{value}"' in src, key
    for key, value in tc.GATEWAY_CFG.items():
        assert f'"{key}": {value!r}' in src, key
    assert "args.n = 40 if args.quick else 120" in src
    assert (tc.load_per_scenario(True), tc.load_per_scenario(False)) \
        == (40, 120)
    assert f"concurrency={tc.CONCURRENCY}" in src
    assert tc.NOTE in src.replace('"\n                 "', "").replace(
        ' "\n                 "', " ")


def test_slo_tables_equal_jax():
    js, ts, src = (_load("bench_slo_detection"), _twin("slo"),
                   _source("slo"))
    assert list(ts.SCENARIOS) == list(js.SCENARIOS)
    for name in ("PREDICT_BODY", "ROUTE_BODY", "DEVICE_SPEC",
                 "DEVICE_SEED", "SLOW_WINDOW_BOUND_S"):
        assert getattr(ts, name) == getattr(js, name), name
    assert f'"RTPU_CHAOS_SPEC": "{ts.STORE_SPEC}"' in src
    assert f'"RTPU_CHAOS_SEED": "{ts.STORE_SEED}"' in src
    for key, value in ts.STORE_ENV.items():
        assert f'"{key}": "{value}"' in src, key
    assert f'"RTPU_TIMELINE_RES"] = "{ts.TIMELINE_RES}"' in src
    assert f"self._stop.wait({ts.POLL_S})" in src
    assert "args.healthy_n = 10 if args.quick else 25" in src
    assert "args.detect_timeout = 45.0 if args.quick else 90.0" in src
    assert ts.phase_sizes(True) == (10, 45.0)
    assert ts.phase_sizes(False) == (25, 90.0)
    assert ts.SLO_DEFAULTS == _record("slo")["slo_defaults"]
    assert ts.NOTE == _record("slo")["note"]


def test_efficiency_tables_equal_jax():
    je, te, src = (_load("bench_efficiency"), _twin("efficiency"),
                   _source("efficiency"))
    for name in ("DETECT_BOUND_S", "EFF_ENV", "BATCH_ROWS", "OVERHEAD_PCT",
                 "OVERHEAD_FLOOR_MS"):
        assert getattr(te, name) == getattr(je, name), name
    assert f'"RTPU_CHAOS_SPEC": "{te.SLOWDOWN_OVERLAY["RTPU_CHAOS_SPEC"]}"' \
        in src
    assert f'"RTPU_CHAOS_SEED": "{te.SLOWDOWN_OVERLAY["RTPU_CHAOS_SEED"]}"' \
        in src
    assert f'overlay={te.PADDING_OVERLAY!r}'.replace("'", '"') in src
    jd, td = _argparse_defaults(src), \
        {a.option_strings[0]: a.default
         for a in te.build_parser()._actions if a.option_strings}
    for flag in ("--nodes", "--rate"):
        assert td[flag] == jd[flag], flag
    assert "args.nodes = min(args.nodes, 4000)" in src
    for prog in te.PROGRAMS:
        assert f'"{prog}"' in src


def test_live_tables_equal_jax():
    tl, src = _twin("live"), _source("live")
    jd = _argparse_defaults(src)
    td = {a.option_strings[0]: a.default
          for a in tl.build_parser()._actions if a.option_strings}
    for flag, value in jd.items():
        assert td[flag] == value, flag
    for key, cap in tl.QUICK.items():
        literal = f"{cap:_}" if isinstance(cap, int) else f"{cap}"
        assert f"args.{key} = min(args.{key}, {literal})" in src, key
    assert f"corridor_width = {tl.CORRIDOR_WIDTH_M}" in src
    assert f"speed_factor={tl.JAM_SPEED_FACTOR}" in src
    assert f'channel = "{tl.CHANNEL}"' in src
    for kind, weight in tl.MIX.items():
        assert f'"{kind}": {weight}' in src, kind
    assert f"base_dur * {tl.SHIFT_THRESHOLD:.2f}" in src
    assert '"pass": rel < 2e-3' in src and tl.ORACLE_REL == 2e-3
    assert (f"(SEED_LOCATIONS[{tl.CORRIDOR_SITES[0]}][1]" in src
            and f"(SEED_LOCATIONS[{tl.CORRIDOR_SITES[1]}][1]" in src)
    assert tl.slo_spec(8000.0) in src.replace(
        '"\n                f"', "").replace("{args.slo_ms:.0f}", "8000")


@pytest.mark.parametrize("half_life,customize,quick", [
    (15.0, 8.0, False), (15.0, 6.0, True), (10.0, 3.0, False),
    (15.0, 8.0, True)])
def test_staleness_bound_formula_equals_jax(half_life, customize, quick):
    tl, src = _twin("live"), _source("live")
    # the JAX script's formula, as it stands in its source
    assert ("args.staleness_bound = (2 * args.half_life_s\n"
            "                                + 2 * args.customize_s + 15.0)"
            in src)
    args = tl.build_parser().parse_args(
        ["--half-life-s", str(half_life), "--customize-s", str(customize)]
        + (["--quick"] if quick else []))
    tl.apply_quick(args)
    customize_used = min(customize, 6.0) if quick else customize
    assert args.staleness_bound == 2 * half_life + 2 * customize_used + 15.0
    assert args.customize_s == customize_used
    if (half_life, customize, quick) == (15.0, 8.0, False):
        assert args.staleness_bound == _record("live")["staleness_bound_s"]


# ── judges on the JAX records' inputs ────────────────────────────────


@pytest.mark.parametrize("scenario", sorted(_record("chaos")["scenarios"]))
def test_chaos_judge_on_the_jax_record(scenario):
    rec = _record("chaos")
    out = rec["scenarios"][scenario]
    assert _twin("chaos").judge(scenario, out, rec["load_per_scenario"]) \
        is out["pass"]


@pytest.mark.parametrize("statuses", [
    {200: 40}, {200: 12, 503: 28}, {200: 30, 504: 8, 429: 2},
    {200: 1, -1: 2, 502: 1}, {}])
def test_chaos_summarize_equals_jax(statuses):
    gw = types.SimpleNamespace(shed_count=3, retries=2, hedges=5,
                               hedge_wins=1)
    lat = sorted(float(i) * 1.7 for i in range(sum(statuses.values())))
    assert _twin("chaos").summarize(statuses, lat, gw) \
        == _load("bench_chaos").summarize(statuses, lat, gw)


@pytest.mark.parametrize("scenario", sorted(_record("slo")["scenarios"]))
def test_slo_judge_on_the_jax_record(scenario):
    out = _record("slo")["scenarios"][scenario]
    assert _twin("slo").judge(out) is out["pass"]


@pytest.mark.parametrize("paged", [False, True])
def test_slo_detection_summary_equals_jax(paged):
    runs = [_load("bench_slo_detection").DetectionRun("http://x", 45.0),
            _twin("slo").DetectionRun("http://x", 45.0)]
    for run in runs:
        run.t_inject = 100.0
        run.paged_at = 103.875 if paged else 0.0
        run.page_objective = "availability:" if paged else ""
        run.page_component = "gateway" if paged else ""
        run.offending = {"a", "b"}
        run.statuses = {200: 110, 504: 2}
    assert runs[1].summary() == runs[0].summary()


def _pm(root, name, reason, trace_ids=(), frames=None):
    path = os.path.join(root, name)
    os.makedirs(path)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"reason": reason}, f)
    with open(os.path.join(path, "requests.jsonl"), "w") as f:
        for tid in trace_ids:
            f.write(json.dumps({"trace_id": tid}) + "\n")
    if frames is not None:
        with open(os.path.join(path, "timeline.json"), "w") as f:
            json.dump({"replica": {"frames": [{"t": t} for t in frames]}},
                      f)


BUNDLE_DIRS = {
    "offender_and_timeline": [
        ("workers", "pm_1_slo_page_1", "slo_page", ("t1", "t9"),
         [99.0, 101.0])],
    "no_offender": [("gateway", "pm_1_slo_page_1", "slo_page", ("t9",),
                     [101.0])],
    "timeline_before_incident": [
        ("workers", "pm_1_slo_page_1", "slo_page", ("t1",), [90.0])],
    "second_page_bundle_bare": [
        ("workers", "pm_1_slo_page_1", "slo_page", ("t1",), [101.0]),
        ("gateway", "pm_2_slo_page_2", "slo_page", (), None)],
    "no_page_bundle": [("workers", "pm_1_breaker_1", "store_breaker",
                        ("t1",), [101.0])],
}


@pytest.mark.parametrize("layout", sorted(BUNDLE_DIRS))
def test_slo_bundle_scans_equal_jax(tmp_path, layout):
    for tier, name, reason, ids, frames in BUNDLE_DIRS[layout]:
        _pm(str(tmp_path / tier), name, reason, ids, frames)
    dirs = [str(tmp_path / "workers"), str(tmp_path / "gateway")]
    js, ts = _load("bench_slo_detection"), _twin("slo")
    offending = {"t1", "t2"}
    assert ts._wait_bundle_with_offender(dirs, offending, timeout_s=0.3) \
        == js._wait_bundle_with_offender(dirs, offending, timeout_s=0.3)
    assert ts._page_bundle_timelines(dirs, 100.0, timeout_s=0.3) \
        == js._page_bundle_timelines(dirs, 100.0, timeout_s=0.3)


def _eff_bundle(label, check, bucket, curve, program="eta_score"):
    return {"name": f"pm_{check}_{bucket}", "evidence": {
        "replica": label, "check": check, "bucket": bucket,
        "program": program, "expected_vs_measured": curve}}


_CURVE = [{"bucket": 8, "expected_rows_per_s": 30000.0,
           "measured_rows_per_s": 18.3},
          {"bucket": 4096, "expected_rows_per_s": 50000.0,
           "measured_rows_per_s": None}]
EFF_BUNDLES = {
    "throughput_named": [_eff_bundle("vm:1", "throughput", 8, _CURVE)],
    "padding_unmeasured_bucket": [
        _eff_bundle("vm:1", "padding:eta_score", 4096, _CURVE)],
    "other_replica": [_eff_bundle("vm:2", "throughput", 8, _CURVE)],
    "unknown_program": [_eff_bundle("vm:1", "throughput", 8, _CURVE,
                                    program="nope")],
    "no_curve": [_eff_bundle("vm:1", "throughput", 8, [])],
    "curve_without_expectation": [_eff_bundle(
        "vm:1", "throughput", 8, [{"bucket": 8, "measured_rows_per_s": 1}])],
    "second_matches": [_eff_bundle("vm:1", "throughput", 99, _CURVE),
                       _eff_bundle("vm:1", "throughput", 8, _CURVE)],
    "none": [],
}


@pytest.mark.parametrize("prefix", ["throughput", "padding"])
@pytest.mark.parametrize("bundles", sorted(EFF_BUNDLES))
def test_efficiency_bundle_judge_equals_jax(bundles, prefix):
    lst = EFF_BUNDLES[bundles]
    assert _twin("efficiency").judge_efficiency_bundle(lst, "vm:1", prefix) \
        == _load("bench_efficiency").judge_efficiency_bundle(
            lst, "vm:1", prefix)


def test_efficiency_bundle_scan_equals_jax(tmp_path):
    root = str(tmp_path)
    for i, (name, ev) in enumerate((
            ("pm_1_efficiency_page_1", {"replica": "vm:1"}),
            ("pm_2_slo_page_2", {"replica": "vm:1"}),
            ("pm_3_efficiency_page_3", None))):
        os.makedirs(os.path.join(root, name))
        with open(os.path.join(root, name, "manifest.json"), "w") as f:
            json.dump({"reason": name[5:]}, f)
        if ev is not None:
            with open(os.path.join(root, name, "efficiency_evidence.json"),
                      "w") as f:
                json.dump(ev, f)
    got = _twin("efficiency").efficiency_bundles(root)
    assert got == _load("bench_efficiency").efficiency_bundles(root)
    assert [b["name"] for b in got] == ["pm_1_efficiency_page_1"]


@pytest.mark.parametrize("scenario",
                         sorted(_record("efficiency")["scenarios"]))
def test_efficiency_checks_on_the_jax_record(scenario):
    te = _twin("efficiency")
    out = _record("efficiency")["scenarios"][scenario]
    if scenario == "clean":
        got = te.clean_checks(
            out["metric_flips"], out["swaps_accepted"], out["replicas"],
            {"fleet": out["fleet_rollup"]}, out["timeline_replica"],
            out["timeline_gateway"], out["efficiency_bundles"])
    elif scenario == "overhead":
        got = {"ledger_within_p95_budget": te.overhead_ok(
            out["p95_off_ms"], out["p95_on_ms"])}
    else:
        got = te.fault_checks(out["page"], out["bundle"],
                              out["healthy_pages"])
    assert got == out["checks"]
    assert all(got.values()) is out["pass"]


def test_live_checks_on_the_jax_record():
    rec = _record("live")
    tl = rec["timeline"]
    got = _twin("live").live_checks(
        eta_shift=tl["eta_shift_frac"],
        route_shift=(abs(tl["post_detect_median_distance_m"]
                         - tl["baseline_median_distance_m"])
                     / tl["baseline_median_distance_m"] > 0.002
                     or tl["post_detect_corridor_overlap"]
                     <= tl["baseline_corridor_overlap"] - 0.05),
        staleness_s=tl["injection_to_served_effect_s"],
        bound_s=rec["staleness_bound_s"],
        oracle_pass=rec["oracle"]["pass"], client_5xx=rec["client_5xx"],
        slo_green=rec["slo"]["green"], flips=rec["live"]["flips"],
        swaps_accepted=rec["live"]["swaps_accepted"],
        customize_s=rec["live"]["customize_s_last"],
        full_build_s=rec["live"]["full_build_s"])
    assert got == rec["checks"]
    assert all(got.values()) is rec["pass"]


def _timeline(durations, t_inject_at, dist=None, overlap=None):
    out = []
    for i, d in enumerate(durations):
        out.append({"t": 1000.0 + 1.5 * i, "duration_s": d,
                    "distance_m": (dist or {}).get(i, 5000.0),
                    "overlap": (overlap or {}).get(i, 0.8)})
    return out, 1000.0 + 1.5 * t_inject_at


@pytest.mark.parametrize("case", ["jam", "blip", "never", "detour"])
def test_live_analysis(case):
    """The JAX script's analysis: two consecutive samples at 1.10× the
    baseline median detect the jam; a single one does not."""
    base = [600.0] * 10
    if case == "jam":
        durs = base + [610.0, 700.0, 720.0, 730.0, 725.0]
    elif case == "blip":
        durs = base + [700.0, 600.0, 605.0, 700.0, 600.0]
    elif case == "never":
        durs = base + [620.0] * 5
    else:
        durs = base + [610.0, 680.0, 690.0, 690.0, 690.0]
    dist = {i: 5600.0 for i in range(12, 15)} if case == "detour" else None
    samples, t_inject = _timeline(durs, 10, dist=dist)
    samples.insert(3, {"t": 1004.0, "error": "URLError"})
    an = _twin("live").analyze(samples, t_inject)
    assert an["samples"] == len(durs)
    assert an["base_dur"] == 600.0
    if case in ("blip", "never"):
        assert an["staleness_s"] is None
        assert an["eta_shift"] != an["eta_shift"] or an["eta_shift"] == 0
        assert not an["route_shift"]
    else:
        assert an["staleness_s"] == pytest.approx(1.5)
        assert an["eta_shift"] == pytest.approx(
            (725.0 if case == "jam" else 690.0) / 600.0 - 1.0)
        assert an["route_shift"] is (case == "detour")


# ── the rehearsals (slow): the scripts on CPU replicas ──────────────


def _rehearse(script, args, tmp_path, timeout):
    out = tmp_path / "record.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS_DIR, script), "--cpu",
         "--quick", *args, "--out", str(out)], cwd=REPO,
        capture_output=True, text=True, timeout=timeout)
    assert out.exists(), proc.stderr[-3000:]
    return json.loads(out.read_text()), proc


@pytest.mark.slow
def test_chaos_rehearsal_store_outage_and_netbus(tmp_path):
    rec, proc = _rehearse("bench_chaos_cuda.py", [
        "--scenarios", "store_outage", "netbus_kill"], tmp_path, 900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert rec["scenarios"]["store_outage"]["lost_writes_after_replay"] == 0
    assert rec["scenarios"]["netbus_kill"]["events_lost"] == 0


@pytest.mark.slow
def test_slo_rehearsal_device_error_burst(tmp_path):
    rec, proc = _rehearse("bench_slo_detection_cuda.py", [
        "--scenarios", "device_error_burst"], tmp_path, 900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert rec["scenarios"]["device_error_burst"]["bundle_has_offender"]


@pytest.mark.slow
def test_efficiency_rehearsal_device_slowdown(tmp_path):
    rec, _proc = _rehearse("bench_efficiency_cuda.py", [
        "--scenario", "device_slowdown", "--cache-dir",
        str(tmp_path / "cache")], tmp_path, 1200)
    assert rec["scenarios"]["device_slowdown"]["checks"][
        "detected_and_paged"]


@pytest.mark.slow
def test_live_rehearsal_runs_to_a_record(tmp_path):
    t0 = time.time()
    rec, _proc = _rehearse("bench_live_traffic_cuda.py", [
        "--nodes", "4000", "--duration", "60", "--cache-dir",
        str(tmp_path / "cache")], tmp_path, 1500)
    assert rec["checks"]["oracle_parity"], rec["oracle"]
    assert rec["trainer"]["device"] == "cpu"
    assert time.time() - t0 < 1500


# ── the JAX chaos script's repeated body (ROADMAP Queue C 26) ────────


def test_fast_lane_answers_a_repeated_body_without_the_device():
    """Why the chaos twin's ``deadline_storm`` doomed requests and its
    ``device_error_burst`` carry rows of their own: in both packages a
    body answered once is answered again by the fast-lane cache — 200
    under a 1 ms budget and under ``device.compute:error=1.0`` — while a
    new row under that fault reaches the device and fails (503). The
    JAX script's single body therefore never meets either fault."""
    from werkzeug.test import Client

    from routest_tpu import chaos as jchaos
    from routest_tpu.core.config import Config as JConfig
    from routest_tpu.core.config import ServeConfig as JServeConfig
    from routest_tpu.serve.app import create_app as jax_create_app
    from routest_tpu.serve.ml_service import EtaService as JEtaService
    from routest_tpu_torch import chaos as tchaos
    from routest_tpu_torch.core.config import Config, ServeConfig
    from routest_tpu_torch.serve.app import create_app
    from routest_tpu_torch.serve.ml_service import EtaService

    def quiet(cfg):
        # no SLO, timeline or profiler ticker, no reopt loop: the
        # 503s below would page, and the JAX app has no close()
        return dataclasses.replace(cfg, **{
            name: dataclasses.replace(getattr(cfg, name), enabled=False)
            for name in ("slo", "timeline", "profile", "dispatch")})

    tc = _twin("chaos")
    model = os.path.join(ARTIFACTS, "eta_mlp.msgpack")
    apps = {
        "jax": (jax_create_app(quiet(JConfig()), eta_service=JEtaService(
            JServeConfig(batch_buckets=(8, 64)), model_path=model)), jchaos),
        "port": (create_app(quiet(Config()), eta_service=EtaService(
            ServeConfig(batch_buckets=(8, 64)), model_path=model,
            device="cpu")), tchaos),
    }
    seen = {}
    try:
        for name, (app, chaos) in apps.items():
            client = Client(app)
            first = client.post("/api/predict_eta", json=tc.PREDICT_BODY)
            chaos.configure(chaos.ChaosEngine(
                spec="device.compute:error=1.0", seed=tc.load_per_scenario(
                    True)))
            try:
                doomed = client.post("/api/predict_eta",
                                     json=tc.PREDICT_BODY,
                                     headers={"X-Deadline-Ms": "1"})
                cached = client.post("/api/predict_eta",
                                     json=tc.PREDICT_BODY)
                fresh = client.post("/api/predict_eta",
                                    json=tc.unique_body(1))
            finally:
                chaos.configure(None)
            seen[name] = (first.status_code, doomed.status_code,
                          cached.status_code, fresh.status_code,
                          cached.get_json()["eta_minutes_ml"]
                          == first.get_json()["eta_minutes_ml"])
    finally:
        for app, _chaos in apps.values():
            close = getattr(app, "close", None)
            if close is not None:
                close()
    assert seen["port"] == seen["jax"] == (200, 200, 200, 503, True)


# ── the deadline storm on a fast replica (ROADMAP Queue C 27) ────────


class _DeadlineStub:
    """A replica that refuses a request whose ``X-Deadline-Ms`` is under
    5 ms with 504, as a replica's edge or batcher refuses an expired
    budget, and answers every other one 200."""

    def __init__(self):
        import http.server
        import threading

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, code, payload):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._send(200, {"ok": True})

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length")
                                    or 0))
                budget = self.headers.get("X-Deadline-Ms")
                if budget is not None and float(budget) < 5.0:
                    return self._send(504, {"error": "deadline exceeded"})
                return self._send(200, {"eta_minutes_ml": 12.5})

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.httpd.daemon_threads = True
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.port = self.httpd.server_address[1]

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def _gateway_post(base, headers=None):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"{base}/api/predict_eta", data=b"{}", method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


@pytest.mark.parametrize("package", ["jax", "port"])
def test_deadline_refusals_eject_the_only_replica(package):
    """Why the chaos twin's ``deadline_storm`` fails on the card: in both
    packages the gateway charges a replica's 504 — its refusal of a
    budget the client let expire — to the replica's breaker (every 5xx
    does), so three doomed requests in a row eject a fleet's only
    replica and the healthy requests behind them get 503 until the
    cooldown ends. The JAX record's slow host never put three in a
    row; a replica on the card refuses them at once."""
    if package == "jax":
        from routest_tpu.core.config import FleetConfig
        from routest_tpu.serve.fleet.gateway import Gateway
    else:
        from routest_tpu_torch.core.config import FleetConfig
        from routest_tpu_torch.serve.fleet.gateway import Gateway

    tc = _twin("chaos")
    stub = _DeadlineStub()
    gw = Gateway([("127.0.0.1", stub.port)],
                 FleetConfig(**{**tc.GATEWAY_CFG, "hedge": False}))
    httpd = gw.serve("127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        seen = [_gateway_post(base)]
        seen += [_gateway_post(base, {"X-Deadline-Ms": "1"})
                 for _ in range(tc.GATEWAY_CFG["eject_after"])]
        seen += [_gateway_post(base), _gateway_post(base)]
        time.sleep(tc.GATEWAY_CFG["cooldown_s"] + 0.3)
        seen.append(_gateway_post(base))
    finally:
        gw.drain(timeout=5)
        stub.stop()
    assert seen == [200, 504, 504, 504, 503, 503, 200]


@pytest.mark.parametrize("answer,want", [
    ({"replica_metrics": {
        "r0": {"registry": {"rtpu_fused_launches": {"series": [
            {"value": 40}]}}},
        "r1": {"registry": {"rtpu_fused_launches": {"series": [
            {"value": 2}]}}},
        "r2": {"error": "unreachable"}}}, 42),
    ({"replica_metrics": {}}, 0), (OSError("refused"), 0)])
def test_harness_fleet_launches(monkeypatch, answer, want):
    """The twins' launch count: the sum of ``replica_launches`` over a
    gateway's ``?replicas=1`` scrape (the harness helper the chaos and
    SLO twins share; the JAX scripts count none)."""
    h = _load("cuda_harness")
    seen = []

    def fetch(url, timeout=30.0):
        seen.append(url)
        if isinstance(answer, Exception):
            raise answer
        return answer

    monkeypatch.setattr(h, "fetch", fetch)
    assert h.fleet_launches("http://gw") == want
    assert seen == ["http://gw/api/metrics?replicas=1"]
