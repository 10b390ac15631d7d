"""The port's last two acceptance proofs (``scripts/bench_{incidents,
wire}_cuda.py``) against the JAX scripts they port, on the CPU: each
imports with neither ``jax`` nor ``routest_tpu`` loaded, answers
``--help`` and exits 2 without a card and without ``--cpu``; its
scenario tables, gate constants, quick sizes, stub worker and
``_thin_suspects`` are the JAX script's; each judge gives the JAX
verdict on the JAX records' own inputs (``artifacts/{incidents,
wire}.json``), scenario by scenario; and for a seeded ledger and page
scope per attribution scenario the port's ``rank_suspects`` orders the
suspects as the JAX one does. The committed card records
(``artifacts/{incidents,wire}_cuda.json``) keep the JAX check names,
judged at the JAX bounds; the wire record fails exactly the two gates
ROADMAP Queue C 30 and 31 record and ``chip_smoke.py``'s phase 24
prints. The incidents twin rehearses here with ``--cpu --quick`` (a
few seconds: stub fleets, a tiny model); no wire fleet runs here."""

import ast
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS_DIR = os.path.join(REPO, "scripts")
ARTIFACTS = os.path.join(REPO, "artifacts")
TWINS = {"incidents": "bench_incidents", "wire": "bench_wire"}
SCRIPTS = tuple(f"{name}_cuda.py" for name in TWINS.values())
RECORDS = {"incidents": "incidents.json", "wire": "wire.json"}


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


def _jax(kind):
    return _load(TWINS[kind])


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


def _twin_defaults(kind):
    return {a.option_strings[0]: a.default
            for a in _twin(kind).build_parser()._actions
            if a.option_strings}


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
    for flag in ("--cpu", "--out", "--quick", "--cache-dir"):
        assert flag in out.stdout, flag


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_refuses_without_a_card(script, tmp_path):
    out_path = tmp_path / "record.json"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS_DIR, script), "--quick",
         "--out", str(out_path), "--cache-dir", str(tmp_path / "cache")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2, out.stderr[-2000:]
    assert "no CUDA device" in out.stderr and "--cpu" in out.stderr
    assert not out_path.exists()


# ── tables, constants, sizes, the stub worker ────────────────────────


def test_incidents_tables_equal_jax():
    ji, ti, src = _jax("incidents"), _twin("incidents"), \
        _source("incidents")
    assert list(ti.SCENARIOS) == list(ji.SCENARIOS)
    assert ti._STUB_WORKER == ji._STUB_WORKER
    assert inspect.getsource(ti._thin_suspects) \
        == inspect.getsource(ji._thin_suspects)
    assert "args.clean_ticks = 8 if args.quick else 15" in src
    assert "args.clean_flips = 20 if args.quick else 30" in src
    assert ti.phase_sizes(True) == (8, 20)
    assert ti.phase_sizes(False) == (15, 30)
    for key, value in ti.ROLLOUT.items():
        assert f"{key}={value!r}" in src, key
    assert f'"{ti.BAD_VERSION}"' in src
    assert f'spec="{ti.JAM_SPEC}"' in src
    assert "jam_kinds = {" + ", ".join(
        f'"{k}"' for k in ti.JAM_KINDS) + "}" in src
    assert f'kill_region("{ti.DEAD_REGION}")' in src
    assert f"range({ti.PAGE_TICKS})" in src
    assert f"max(args.clean_flips, {ti.MIN_FLIPS})" in src
    assert f'out["flips"] >= {ti.MIN_FLIPS}' in src
    assert f"swaps >= {ti.MIN_SWAPS}" in src
    jd, td = _argparse_defaults(src), _twin_defaults("incidents")
    for flag in ("--seed", "--scenarios"):
        assert td[flag] == jd[flag], flag


@pytest.mark.parametrize("suspects", [
    [],
    [{"score": 1.25, "matched": ["version"], "mismatched": [],
      "age_s": 0.1, "event": {"kind": "rollout.phase", "version": "v2",
                              "replica": "", "ts": 1.0}},
     {"score": 0.2, "matched": [], "mismatched": ["region"], "age_s": 3,
      "event": {"kind": "region.kill", "region": "west"}}] * 3,
])
def test_thin_suspects_equals_jax(suspects):
    assert _twin("incidents")._thin_suspects(suspects) \
        == _jax("incidents")._thin_suspects(suspects)


def test_wire_tables_equal_jax():
    jw, tw, src = _jax("wire"), _twin("wire"), _source("wire")
    for name in ("SPEEDUP_MIN", "GW_OVERHEAD_P95_MS",
                 "SUSTAINED_ROWS_PER_S", "WIRE_CT"):
        assert getattr(tw, name) == getattr(jw, name), name
    quick, full = tw.phase_sizes(True), tw.phase_sizes(False)
    assert (f"window_s = {quick['window_s']} if quick else "
            f"{full['window_s']}") in src
    assert (f"n = {quick['overhead_samples']} if quick else "
            f"{full['overhead_samples']}") in src
    assert (f"duration = {quick['sustained_s']} if quick else "
            f"{full['sustained_s']}") in src
    assert (f"duration = {quick['probe_s']} if quick else "
            f"{full['probe_s']}") in src
    assert (f"time.time() + ({quick['transition_s']} if quick else "
            f"{full['transition_s']})") in src
    assert f"for rows in {tw.SMALL_BATCHES}" in src
    assert f"rows = {tw.SUSTAINED_ROWS}" in src
    assert f"rate = {tw.SUSTAINED_RATE}" in src
    assert f"RateCurve.constant({tw.PROBE_RATE})" in src
    assert f"batch_rows={tw.PROBE_ROWS}" in src
    assert "args.nodes = min(args.nodes, 4000)" in src
    for scen in ("micro", "probe_parity"):
        assert f'"{scen}"' in src
    jd, td = _argparse_defaults(src), _twin_defaults("wire")
    for flag in ("--nodes", "--scenario"):
        assert td[flag] == jd[flag], flag
    rng = np.random.default_rng(5)
    for n in (0, 1, 19, 20, 400):
        lat = list(rng.exponential(0.004, size=n))
        a, b = tw._p95_ms(lat), jw._p95_ms(lat)
        assert a == b or (np.isnan(a) and np.isnan(b))


# ── the judges on the JAX records ────────────────────────────────────


@pytest.mark.parametrize("scenario",
                         sorted(_record("incidents")["scenarios"]))
def test_incidents_judge_on_the_jax_record(scenario):
    out = _record("incidents")["scenarios"][scenario]
    assert _twin("incidents").judge(scenario, out) == out["checks"]


def _flip_top(out, kind, labels=None, matched=()):
    top = {"kind": kind, "score": 1.0, "matched": list(matched),
           "mismatched": [], "age_s": 0.0, "labels": labels or {}}
    return dict(out, suspects=[top] + list(out["suspects"]))


@pytest.mark.parametrize("scenario,top,failed", [
    ("bad_deploy", ("live.flip", None, ()),
     {"true_cause_ranked_first", "offending_version_matched",
      "noise_below_cause"}),
    ("bad_deploy", ("rollout.phase", {"version": "v1"}, ("version",)),
     {"offending_version_matched"}),
    ("jammed_customize", ("live.flip", None, ()),
     {"true_cause_ranked_first", "no_flip_blamed"}),
    ("region_kill", ("region.rejoin", {"region": "east"}, ("region",)),
     {"true_cause_ranked_first"}),
    ("region_kill", ("region.kill", {"region": "west"}, ()),
     {"region_matched"}),
])
def test_incidents_judge_fails_a_wrong_top_suspect(scenario, top, failed):
    """The JAX rules on the JAX record with another event ranked first:
    exactly the checks that read the top suspect fail."""
    out = _flip_top(_record("incidents")["scenarios"][scenario], *top)
    checks = _twin("incidents").judge(scenario, out)
    assert {k for k, v in checks.items() if not v} == failed


@pytest.mark.parametrize("scenario,change,failed", [
    ("bad_deploy", {"final_state": "promoted"}, {"rolled_back"}),
    ("bad_deploy", {"suspects": []},
     {"paged_with_suspects", "true_cause_ranked_first",
      "offending_version_matched", "noise_below_cause"}),
    ("jammed_customize", {"clean_flips": 0}, {"clean_window_quiet"}),
    ("jammed_customize", {"clean_paged": True}, {"clean_window_quiet"}),
    ("region_kill", {"page_scope": {"dead_region": "west"}},
     {"dead_region_named"}),
    ("region_kill", {"paged": False, "page_scope": None},
     {"paged_with_suspects", "dead_region_named"}),
    ("clean_window", {"flips": 19}, {"enough_flips"}),
    ("clean_window", {"swaps_accepted": 1}, {"enough_swaps"}),
    ("clean_window", {"incidents": 1, "incident_suspects": [2]},
     {"zero_pages", "zero_false_attributions"}),
])
def test_incidents_judge_fails_what_the_jax_rule_fails(scenario, change,
                                                       failed):
    out = dict(_record("incidents")["scenarios"][scenario], **change)
    checks = _twin("incidents").judge(scenario, out)
    assert {k for k, v in checks.items() if not v} == failed


def test_wire_micro_judge_on_the_jax_record():
    out = _record("wire")["scenarios"]["micro"]
    assert _twin("wire").micro_checks(out) == out["checks"]


def test_wire_probe_judge_on_the_jax_record():
    out = _record("wire")["scenarios"]["probe_parity"]
    assert _twin("wire").probe_checks(out) == out["checks"]


@pytest.mark.parametrize("change,failed", [
    ({"speedup_small_batches": 1.99}, {"speedup_small_batches_ge_2x"}),
    ({"gateway_overhead": {"p95_direct_ms": 1.0,
                           "p95_via_gateway_ms": 2.0}},
     {"gateway_overhead_p95_lt_1ms"}),
    ({"sustained": {"rows_per_s": 99_999.0}},
     {"sustained_ge_100k_rows_per_s"}),
    ({"sustained": {"rows_per_s": 133_000.0,
                    "pace": {"generator_lagged": True}}},
     {"sustained_ge_100k_rows_per_s"}),
    ({"channel": {"frames_sent": 10, "reuse_ratio": 0.5}},
     {"connections_reused"}),
])
def test_wire_micro_judge_fails_past_each_gate(change, failed):
    """Each gate at its JAX bound; a lagged generator fails only the
    sustained check, the one that reads its latencies."""
    out = dict(_record("wire")["scenarios"]["micro"], **change)
    checks = _twin("wire").micro_checks(out)
    assert {k for k, v in checks.items() if not v} == failed


# ── suspect ranking: the port's against the JAX ledger's ─────────────


_PAGES = {
    "bad_deploy": ("rollout.phase", {"version": "v2-err"},
                   {"trigger": "canary_error_rate",
                    "offending_version": "v2-err", "rid": "r2"}),
    "jammed_customize": ("live.customize_failed", {},
                         {"slo": "availability:customize",
                          "surface": "live.customize"}),
    "region_kill": ("region.kill", {"region": "east"},
                    {"slo": "reachability:regions",
                     "dead_region": "east"}),
}
_NOISE = (("live.flip", {}), ("model.swap", {}), ("chaos.fire", {}),
          ("rollout.phase", {"version": "v1"}),
          ("region.failover", {"region": "west"}),
          ("replica.restart", {"replica": "r1"}))


def _ranked(ledger_mod, config_mod, registry_mod, scenario, seed):
    cause, labels, detail = _PAGES[scenario]
    ledger = ledger_mod.ChangeLedger(
        config=config_mod.LedgerConfig(
            enabled=True, capacity=512, window_s=900.0, max_suspects=5,
            publish=False, channel="rtpu.changes", incidents_kept=64,
            region=""), registry=registry_mod.MetricsRegistry())
    rng = np.random.default_rng(seed)
    now = 5000.0
    for k in rng.integers(0, len(_NOISE), size=24):
        kind, noise_labels = _NOISE[k]
        ledger.record(kind, ts=now - float(rng.uniform(0.0, 1200.0)),
                      detail={"n": int(k)}, **noise_labels)
    ledger.record(cause, ts=now - float(rng.uniform(0.0, 30.0)), **labels)
    scope = ledger_mod.scope_from_detail(detail)
    ranked = ledger_mod.rank_suspects(ledger.events(), now, scope,
                                      window_s=900.0, limit=5)
    for s in ranked:
        s["event"].pop("id")
    return scope, ranked


@pytest.mark.parametrize("scenario", sorted(_PAGES))
def test_rank_suspects_orders_as_jax(scenario):
    from routest_tpu.core import config as jconfig
    from routest_tpu.obs import ledger as jledger
    from routest_tpu.obs import registry as jregistry
    from routest_tpu_torch.core import config as tconfig
    from routest_tpu_torch.obs import ledger as tledger
    from routest_tpu_torch.obs import registry as tregistry

    jscope, jranked = _ranked(jledger, jconfig, jregistry, scenario, 22)
    tscope, tranked = _ranked(tledger, tconfig, tregistry, scenario, 22)
    assert tscope == jscope
    assert tranked == jranked
    assert tranked[0]["event"]["kind"] == _PAGES[scenario][0]


# ── the incidents twin, rehearsed on the CPU ─────────────────────────


def test_incidents_rehearsal_passes_every_check(tmp_path):
    out = tmp_path / "record.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS_DIR, "bench_incidents_cuda.py"),
         "--cpu", "--quick", "--out", str(out),
         "--cache-dir", str(tmp_path / "cache")], cwd=REPO,
        capture_output=True, text=True, timeout=180)
    assert out.exists(), proc.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert proc.returncode == 0, {k: v.get("checks", v.get("error"))
                                  for k, v in rec["scenarios"].items()}
    assert rec["all_pass"] and rec["quick"]
    assert set(rec["checks"]) == set(_jax("incidents").SCENARIOS)
    for name, scen in rec["scenarios"].items():
        assert set(scen["checks"]) == set(
            _record("incidents")["scenarios"][name]["checks"]), name
    clean = rec["scenarios"]["clean_window"]
    assert clean["swaps_accepted"] == 2 and clean["kernel"] == "torch_plain"
    assert rec["card"]["device"] == "cpu" and rec["launches"] == 0


# ── the committed card records ───────────────────────────────────────


def _card_record(name):
    with open(os.path.join(ARTIFACTS, name)) as f:
        return json.load(f)


def _proof_recorded():
    """``chip_smoke.py``'s ``PROOF_RECORDED``, read from its source: the
    script is a program of its own, not a module the tests import."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "PROOF_RECORDED"
                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no PROOF_RECORDED")


def _on_the_card(rec):
    card = rec["card"]
    assert card["device"] == "cuda" and card["name"].startswith("NVIDIA")
    assert card["power_limit"] and card["nvidia_smi"].startswith(
        card["name"])


def test_incidents_card_record_passes_with_the_jax_checks():
    rec = _card_record("incidents_cuda.json")
    _on_the_card(rec)
    jax = _record("incidents")
    assert rec["all_pass"] and not rec["quick"] and "partial" not in rec
    assert set(rec["scenarios"]) == set(jax["scenarios"])
    for name, scen in rec["scenarios"].items():
        assert set(scen["checks"]) == set(jax["scenarios"][name]["checks"])
        assert _twin("incidents").judge(name, scen) == scen["checks"]
    clean = rec["scenarios"]["clean_window"]
    assert clean["kernel"] == "cuda_fused" and clean["gate_launches"] > 0
    assert rec["launches"] == clean["launches"] > 0


def test_wire_card_record_fails_only_the_recorded_gates():
    """Queue C 30 and 31: on the card the wire path misses the JAX
    8-row speedup and gateway-added p95 gates, judged at the JAX bounds,
    and passes every other check; ``chip_smoke.py``'s phase 24 prints
    exactly these two. A record that passes them retires both entries
    and this test with them."""
    rec = _card_record("wire_cuda.json")
    _on_the_card(rec)
    tw, jw = _twin("wire"), _jax("wire")
    assert not rec["quick"] and "partial" not in rec
    assert rec["config"]["speedup_min"] == jw.SPEEDUP_MIN
    assert rec["config"]["gateway_overhead_p95_ms"] \
        == jw.GW_OVERHEAD_P95_MS
    assert rec["config"]["sustained_floor_rows_per_s"] \
        == jw.SUSTAINED_ROWS_PER_S
    micro, probe = rec["scenarios"]["micro"], rec["scenarios"]["probe_parity"]
    assert tw.micro_checks(micro) == micro["checks"]
    assert tw.probe_checks(probe) == probe["checks"] and probe["pass"]
    failed = {f"micro.{k}" for k, v in micro["checks"].items() if not v}
    assert failed == set(_proof_recorded()["wire"])
    thr = micro["throughput"]
    assert thr["8"]["speedup"] < jw.SPEEDUP_MIN <= thr["64"]["speedup"]
    assert micro["gateway_overhead"]["added_p95_ms"] \
        >= jw.GW_OVERHEAD_P95_MS
    assert rec["launches"] > 0 and not rec["all_pass"]
