"""The road router's acceptance proofs on the port (``scripts/bench_{
batch_solve,router_scale,router_serving}_cuda.py``) against the JAX
scripts they port, on the CPU: each imports with neither ``jax`` nor
``routest_tpu`` loaded, answers ``--help`` and exits 2 without a card
and without ``--cpu``; its argparse defaults and ``--quick`` preset, its
seeds, K ladder, SLO objectives, workload mix, capture buckets, fleet
settings and pass rules are the JAX script's (read from its source by
``ast``); each judge gives the JAX verdict on the JAX record's own
inputs (``artifacts/{batch_solve,router_scale,router_serving}.json``)
and fails past each gate; the twins' street extract is the JAX recipe's,
array for array; ``chip_smoke.py``'s phase 25 passes the JAX slow tests'
own arguments. The batch-solve twin rehearses here with ``--cpu`` on a
6,144-node extract (a few seconds). The committed card records
(``artifacts/*_cuda.json``) keep the JAX check names, judged at the JAX
bounds. No replica starts here, and no JAX router is built."""

import argparse
import ast
import copy
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS_DIR = os.path.join(REPO, "scripts")
ARTIFACTS = os.path.join(REPO, "artifacts")
KINDS = ("batch_solve", "router_scale", "router_serving")
SCRIPTS = tuple(f"bench_{kind}_cuda.py" for kind in KINDS)
JAX_TESTS = {"batch_solve": "test_router_fastlane_bench.py",
             "router_scale": "test_router_scale_bench.py",
             "router_serving": "test_router_fastlane_bench.py"}


def _load(name):
    """A script as a module, by path (``scripts/`` on ``sys.path`` for
    its sibling imports)."""
    if SCRIPTS_DIR not in sys.path:
        sys.path.append(SCRIPTS_DIR)
    key = f"_router_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(SCRIPTS_DIR, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def _twin(kind):
    return _load(f"bench_{kind}_cuda")


def _read(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


def _source(kind):
    return _read("scripts", f"bench_{kind}.py")


def _record(kind, suffix=""):
    with open(os.path.join(ARTIFACTS, f"{kind}{suffix}.json")) as f:
        return json.load(f)


def _argparse_defaults(src):
    """``{"--flag": default}`` of every ``add_argument`` call in a
    script's source (``None`` where it gives none)."""
    out = {}
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "add_argument":
            flag = node.args[0].value
            out[flag] = None
            for kw in node.keywords:
                if kw.arg == "default":
                    out[flag] = ast.literal_eval(kw.value)
                elif kw.arg == "action" and kw.value.value == "store_true":
                    out[flag] = False
    return out


def _twin_defaults(kind):
    return {a.option_strings[0]: a.default
            for a in _twin(kind).build_parser()._actions
            if a.option_strings and a.dest != "help"}


def _jax_quick(kind, args):
    """The body of the JAX script's ``if args.quick:`` block, run on
    ``args``."""
    for node in ast.walk(ast.parse(_source(kind))):
        if (isinstance(node, ast.If) and isinstance(node.test, ast.Attribute)
                and node.test.attr == "quick"):
            code = compile(ast.Module(body=node.body, type_ignores=[]),
                           f"bench_{kind}.py", "exec")
            exec(code, {"min": min}, {"args": args})
            return args
    raise AssertionError(f"bench_{kind}.py has no quick block")


def _number_after(src, prefix):
    """The number literal that follows ``prefix`` in ``src``."""
    import re

    i = src.index(prefix) + len(prefix)
    return ast.literal_eval(re.match(r"[0-9._e+-]+", src[i:]).group())


def _calls(src, name):
    """Every call of ``name`` (a bare name or an attribute) in ``src``."""
    return [node for node in ast.walk(ast.parse(src))
            if isinstance(node, ast.Call)
            and (getattr(node.func, "id", None) == name
                 or getattr(node.func, "attr", None) == name)]


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
    for flag in ("--cpu", "--out", "--quick"):
        assert flag in out.stdout, flag


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_refuses_without_a_card(script, tmp_path):
    out_path = tmp_path / "record.json"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS_DIR, script), "--quick",
         "--out", str(out_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2, out.stderr[-2000:]
    assert "no CUDA device" in out.stderr and "--cpu" in out.stderr
    assert not out_path.exists()


# ── defaults, presets and tables against the JAX sources ─────────────


@pytest.mark.parametrize("kind", KINDS)
def test_defaults_equal_jax(kind):
    """Every JAX flag, with the JAX default; the twin adds ``--cpu``
    (the JAX scripts force the CPU, the twins need a card)."""
    jd, td = _argparse_defaults(_source(kind)), _twin_defaults(kind)
    assert set(td) - set(jd) <= {"--cpu"}
    for flag, value in jd.items():
        if flag == "--cpu":
            continue
        assert flag in td, flag
        assert td[flag] == value, flag


@pytest.mark.parametrize("kind", KINDS)
def test_quick_preset_equals_jax(kind):
    parser = _twin(kind).build_parser()
    args = parser.parse_args(["--quick"])
    want = _jax_quick(kind, copy.deepcopy(args))
    _twin(kind).apply_quick(args)
    assert vars(args) == vars(want)
    assert vars(args) != vars(parser.parse_args([]))


def test_batch_solve_tables_equal_jax():
    tb, src = _twin("batch_solve"), _source("batch_solve")
    assert f"np.random.default_rng({tb.SOURCE_SEED})" in src
    assert f"for _ in range({tb.BEST_OF}):" in src
    assert f"n_per_thread = {tb.N_PER_THREAD}" in src
    assert (f"rng.uniform({tb.LAT_RANGE[0]:.2f}, {tb.LAT_RANGE[1]:.2f}, "
            f"k_max)") in src
    assert (f"rng.uniform({tb.LON_RANGE[0]:.2f}, {tb.LON_RANGE[1]:.2f}, "
            f"k_max)") in src
    assert ("RoadRouter(graph=streets, use_gnn=False, "
            "use_transformer=False)") in src
    assert "router._solve_batcher.stats()" in src
    # the pass rule (:176-185) and the slow test's assertions
    assert _number_after(src, 'r.get("oracle_max_rel_err", 0.0) <= ') \
        == tb.ORACLE_RTOL
    assert f'r["k"] >= {tb.K_AMORTIZED}' in src
    assert f'max(r["speedup"] for r in big) >= {tb.SPEEDUP_PEAK}' in src
    assert f'all(r["speedup"] >= {tb.SPEEDUP_FLOOR} for r in big)' in src
    test = _read("tests", JAX_TESTS["batch_solve"])
    assert (f'rows[{tb.K_AMORTIZED}]["speedup"] >= {tb.SPEEDUP_PEAK}'
            in test)
    assert f'th["max_occupancy"] >= {tb.MIN_OCCUPANCY}' in test
    assert 'th["dispatches"] < th["solves"]' in test
    assert 'record["host_caveat"]' in test


def test_router_scale_tables_equal_jax():
    ts, src = _twin("router_scale"), _source("router_scale")
    assert f"np.random.default_rng({ts.ROW_SEED})" in src
    assert f"for _ in range({ts.BEST_OF}):" in src
    assert (f"router.route_legs(pts, {ts.MATRIX_SCALE}, "
            f"hour={ts.MATRIX_HOUR})") in src
    assert (f"rng.uniform({ts.LAT_RANGE[0]:.2f}, {ts.LAT_RANGE[1]:.2f}, "
            f"args.waypoints)") in src
    for env in ('os.environ.setdefault("ROUTEST_ROUTE_CACHE", "0")',
                '"ROUTEST_HIER_MIN_NODES", "0"',
                '"ROUTEST_HIER_MAX_LEVELS", "1"',
                '"ROUTEST_HIER_LABELS", "0"', "save_osm(path, streets)"):
        assert env in src, env
    assert ts.MANILA.endswith(os.path.join("artifacts",
                                           "manila_arterials.osm.gz"))
    test = _read("tests", JAX_TESTS["router_scale"])
    assert _number_after(test, '["oracle_max_rel_err"] <= ') \
        == ts.ORACLE_RTOL
    for line in (f'hier["reachable_frac"] >= {ts.REACH_MIN}',
                 f'hier["overlay_speedup"] >= {ts.OVERLAY_SPEEDUP_MIN}',
                 f'["n_levels"] >= {ts.MIN_LEVELS}',
                 f'hier["multi_level_speedup"] >= '
                 f'{ts.MULTI_LEVEL_SPEEDUP_MIN}',
                 'hier["flat_warm_ms"] > hier["solve_warm_ms"]',
                 "len(rows) == 2"):
        assert line in test, line


def test_router_serving_tables_equal_jax():
    tv, src = _twin("router_serving"), _source("router_serving")
    main = next(n for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    spec = next(n.value for n in ast.walk(main) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "slo_spec")
    for slo_ms in (2500.0, 800.0):
        jax_spec = eval(compile(ast.Expression(spec), "slo", "eval"),
                        {"args": argparse.Namespace(slo_ms=slo_ms)})
        assert tv.slo_spec(slo_ms) == jax_spec
    mix = [kw.value for call in _calls(src, "MixedWorkload")
           for kw in call.keywords if kw.arg == "mix"]
    assert [ast.literal_eval(m) for m in mix] == [tv.MIX]
    assert "seed=args.seed, road_graph=True" in src
    fleet = _calls(src, "FleetConfig")
    assert [{kw.arg: ast.literal_eval(kw.value) for kw in c.keywords}
            for c in fleet] == [tv.FLEET]
    env = next(c.args[0] for c in _calls(src, "update")
               if isinstance(c.args[0], ast.Dict))
    literal = {k.value: v.value for k, v in zip(env.keys, env.values)
               if isinstance(v, ast.Constant)}
    assert literal == {"ROUTEST_MESH": "0", "ROUTEST_WARM_BUCKETS": "0",
                       "ROUTEST_ROUTER_AOT": tv.ROUTER_AOT}
    assert 'env_off["ROUTEST_ROUTE_CACHE"] = "0"' in src
    assert f"workload.sequence({tv.WARM_REQUESTS})" in src
    assert f"workers={tv.OPEN_LOOP_WORKERS}" in src
    assert "timeout=max(60.0, 4 * slo_ms / 1000)" in src
    assert 'poisson_schedule(curve, args.duration, seed=args.seed)' in src
    assert f'["error_rate"] <= {tv.ERROR_RATE_MAX}' in src
    test = _read("tests", JAX_TESTS["router_serving"])
    assert f'record["cache_speedup_mean"] > {tv.CACHE_SPEEDUP_MIN}' in test
    assert 'rc and rc["hit_rate"] > 0.0' in test
    assert 'off["route_cache"].get("hits", 0) == 0' in test


def _slow_test_args(kind):
    """The arguments the JAX slow test passes its script, without the
    record path and the CPU switch."""
    tree = ast.parse(_read("tests", JAX_TESTS[kind]))
    for node in ast.walk(tree):
        if isinstance(node, ast.List) and any(
                isinstance(e, ast.Call) and any(
                    isinstance(a, ast.Constant)
                    and a.value == f"bench_{kind}.py" for a in e.args)
                for e in node.elts):
            args = [e.value for e in node.elts
                    if isinstance(e, ast.Constant)]
            return [a for a in args if a not in ("--out", "--cpu")]
    raise AssertionError(f"no call of bench_{kind}.py")


def _chip_smoke_constant(name):
    """A constant of ``chip_smoke.py``, read from its source (the script
    is a program of its own, not a module the tests import)."""
    tree = ast.parse(_read("chip_smoke.py"))
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Name):
            target = node.targets[0].id
            if target == name:
                return eval(compile(ast.Expression(node.value), name,
                                    "eval"), {"str": str}, consts)
            try:
                consts[target] = ast.literal_eval(node.value)
            except ValueError:
                pass
    raise AssertionError(f"chip_smoke.py has no {name}")


def test_phase_25_passes_the_slow_tests_arguments():
    """Phase 25 runs each twin at its JAX slow test's arguments; the
    serving run's open loop alone is shortened (``--duration``)."""
    runs = _chip_smoke_constant("ROUTER_RUNS")
    for kind in KINDS:
        script, args = runs[kind]
        assert script == f"bench_{kind}_cuda.py"
        args = list(args)
        if "--duration" in args:
            i = args.index("--duration")
            assert kind == "router_serving" and 0 < float(args[i + 1]) <= 45
            del args[i:i + 2]
        assert args == _slow_test_args(kind), kind
    lanes = _chip_smoke_constant("ROUTER_LANES")
    assert sorted(n for lane in lanes for n in lane) == sorted(KINDS)


# ── the extract ──────────────────────────────────────────────────────


@pytest.mark.parametrize("nodes", [3000, 7000])
def test_metro_streets_equal_the_jax_recipe(nodes):
    from routest_tpu.data.road_graph import (generate_road_graph,
                                             subdivide_graph)

    harness = _load("cuda_harness")
    got = harness.metro_streets(nodes)
    n_int = max(1024, int(nodes / 5.86))
    want = subdivide_graph(generate_road_graph(n_nodes=n_int, k=4, seed=0),
                           bends_per_edge=2, oneway_frac=0.1, seed=0)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for kind in KINDS:
        src = _source(kind)
        assert ("max(1024, int(args.nodes / 5.86))" in src
                or "max(1024, int(n_nodes / 5.86))" in src
                or "max(1024, int(args.osm_nodes / 5.86))" in src), kind
        assert "bends_per_edge=2, oneway_frac=0.1" in src, kind


# ── the judges on the JAX records ────────────────────────────────────


def test_batch_solve_judge_on_the_jax_record():
    rec = _record("batch_solve")
    checks = _twin("batch_solve").judge(rec)
    assert all(checks.values()) and rec["pass"]


def test_router_scale_judge_on_the_jax_record():
    rec = _record("router_scale")
    assert all("oracle_max_rel_err" in r for r in rec["rows"])
    checks = _twin("router_scale").judge(rec["rows"], quick=False,
                                         verify=True)
    assert checks == {"oracle_parity": True}


def test_router_serving_judge_on_the_jax_record():
    rec = _record("router_serving")
    checks = _twin("router_serving").judge(rec)
    assert all(checks.values()) and rec["pass"]
    assert set(checks) == {
        "request_route_p95_within_slo", "slo_green", "error_rate_le_1pct",
        "generator_kept_pace", "route_cache_hit", "batch_reported",
        "cache_off_generator_kept_pace", "cache_off_no_hits",
        "cache_speedup_mean_gt_1_1"}


def _batch_change(rec, change):
    rec = copy.deepcopy(rec)
    rows = {r["k"]: r for r in rec["rows"]}
    for key, value in change.items():
        if isinstance(key, int):
            rows[key].update(value)
        elif key == "threaded":
            rec["threaded"].update(value)
        else:
            rec[key] = value
    return rec


@pytest.mark.parametrize("change,failed", [
    ({8: {"speedup": 1.49}}, {"k8_speedup_ge_1_5x"}),
    ({8: {"speedup": 1.19}, 16: {"speedup": 1.19}, 32: {"speedup": 1.19}},
     {"k8_speedup_ge_1_5x", "merged_ge_1_5x_past_k8",
      "merged_ge_1_2x_every_k_past_8"}),
    ({32: {"speedup": 1.19}}, {"merged_ge_1_2x_every_k_past_8"}),
    ({2: {"oracle_max_rel_err": 2e-5}}, {"oracle_parity"}),
    ({32: {"merged_solves_per_s": 37.5}}, {"merged_rate_grows_with_k"}),
    ({"threaded": {"errors": ["RuntimeError()"]}}, {"threads_no_errors"}),
    ({"threaded": {"dispatches": 48}}, {"threads_shared_dispatches"}),
    ({"threaded": {"max_occupancy": 1}}, {"threads_occupancy_ge_2"}),
    ({"host_caveat": None}, {"host_caveat_present"}),
])
def test_batch_solve_judge_fails_past_each_gate(change, failed):
    rec = _batch_change(_record("batch_solve"), change)
    checks = _twin("batch_solve").judge(rec)
    assert {k for k, v in checks.items() if not v} == failed


def _quick_scale_rows():
    """A quick-shaped record from the JAX record's rows: the 2048 flat
    row, then the 50k overlay row (both comparisons measured), its
    single-level ratio set past the gate."""
    rows = copy.deepcopy(_record("router_scale")["rows"])
    hier = dict(rows[2], multi_level_speedup=1.3)
    return [rows[0], hier]


@pytest.mark.parametrize("change,failed", [
    ({}, set()),
    ({"multi_level_speedup": 1.17}, {"multi_level_speedup_ge_1_2"}),
    ({"overlay_speedup": 1.4}, {"overlay_speedup_ge_1_5"}),
    ({"flat_warm_ms": 1000.0}, {"overlay_beats_flat"}),
    ({"reachable_frac": 0.98}, {"overlay_reachable_ge_0_99"}),
    ({"oracle_max_rel_err": float("inf")}, {"oracle_parity"}),
    ({"query_phases_ms": {"phase1": 1.0, "top_bf": 2.0,
                          "descend_l1": 1.0}}, {"query_phases_recorded"}),
    ({"solver": "flat_bf"}, {"overlay_row_is_hierarchy"}),
])
def test_router_scale_quick_judge_fails_past_each_gate(change, failed):
    rows = _quick_scale_rows()
    rows[1].update(change)
    checks = _twin("router_scale").judge(rows, quick=True, verify=True)
    assert {k for k, v in checks.items() if not v} == failed


def test_router_scale_quick_judge_reads_the_levels():
    rows = _quick_scale_rows()
    rows[1]["overlay"] = dict(rows[1]["overlay"], n_levels=1)
    rows[1]["overlay"]["levels"] = [dict(rows[1]["overlay"]["levels"][0],
                                         n_cells=1)]
    checks = _twin("router_scale").judge(rows + rows[:1], quick=True,
                                         verify=False)
    assert {k for k, v in checks.items() if not v} == {
        "two_rows", "overlay_levels_ge_2", "level_build_stats"}


@pytest.mark.parametrize("change,failed", [
    ({"request_route_p95_ms": 2500.1}, {"request_route_p95_within_slo"}),
    ({"slo": {"gateway_state": "page", "replica_state": "ok",
              "green": False}}, {"slo_green"}),
    ({"load": {"error_rate": 0.011}}, {"error_rate_le_1pct"}),
    ({"load": {"send_delay": {"p99_ms": 9.0}}}, {"generator_kept_pace"}),
    ({"route_cache": {"hit_rate": 0.0}}, {"route_cache_hit"}),
    ({"batch": None}, {"batch_reported"}),
    ({"cache_off": {"route_cache": {"hits": 2}}}, {"cache_off_no_hits"}),
    ({"cache_off": {"load": {"send_delay": {"p99_ms": 500.0}}}},
     {"cache_off_generator_kept_pace"}),
    ({"cache_speedup_mean": 1.1}, {"cache_speedup_mean_gt_1_1"}),
    ({"cache_speedup_mean": None}, {"cache_speedup_mean_gt_1_1"}),
])
def test_router_serving_judge_fails_past_each_gate(change, failed):
    rec = copy.deepcopy(_record("router_serving"))

    def merge(into, new):
        for k, v in new.items():
            if isinstance(v, dict) and isinstance(into.get(k), dict):
                merge(into[k], v)
            else:
                into[k] = v

    merge(rec, change)
    checks = _twin("router_serving").judge(rec)
    assert {k for k, v in checks.items() if not v} == failed


# ── the batch-solve twin, rehearsed on the CPU ───────────────────────


def test_batch_solve_rehearsal_passes_its_oracle(tmp_path):
    out = tmp_path / "record.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS_DIR, "bench_batch_solve_cuda.py"),
         "--cpu", "--nodes", "3000", "--ks", "1", "2", "8",
         "--out", str(out)], cwd=REPO,
        env=dict(os.environ, ROUTEST_HIER_CACHE="0"),
        capture_output=True, text=True, timeout=180)
    assert out.exists(), proc.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["checks"]["oracle_parity"], rec["rows"]
    assert all(r["oracle_max_rel_err"] <= 1e-5 for r in rec["rows"])
    assert rec["nodes"] == 6144 and rec["solver"] == "hierarchy"
    assert rec["card"]["device"] == "cpu" and rec["aot_buckets"] == []
    assert set(rec["checks"]) == set(_twin("batch_solve").judge(rec))
    assert proc.returncode == (0 if rec["pass"] else 1)


# ── the committed card records ───────────────────────────────────────

# Checks a full card record fails against the JAX gate, each recorded in
# ROADMAP Queue C: the served route cache's mean speedup at 250k nodes
# (Queue C 33).
CARD_RECORDED = {"batch_solve": set(), "router_scale": set(),
                 "router_serving": {"cache_speedup_mean_gt_1_1"}}


def _on_the_card(rec):
    card = rec["card"]
    assert card["device"] == "cuda" and card["name"].startswith("NVIDIA")
    assert card["power_limit"] and card["nvidia_smi"].startswith(
        card["name"])
    assert card["cpu_count"] >= 1


def _failed(checks):
    return {k for k, v in checks.items() if not v}


def test_batch_solve_card_record_passes_with_the_jax_checks():
    rec = _record("batch_solve", "_cuda")
    _on_the_card(rec)
    jax = _record("batch_solve")
    assert not rec["quick"] and rec["config"]["verify"]
    assert [r["k"] for r in rec["rows"]] == [r["k"] for r in jax["rows"]]
    assert rec["nodes"] == jax["nodes"] and rec["edges"] == jax["edges"]
    assert rec["threaded"]["solves"] == jax["threaded"]["solves"]
    assert _twin("batch_solve").judge(rec) == rec["checks"]
    assert _failed(rec["checks"]) == CARD_RECORDED["batch_solve"]
    assert rec["aot_buckets"] == [2, 16]
    assert [r["k"] for r in rec["rows"] if r["merged_replayed_graph"]] \
        == [2, 16]


def test_router_scale_card_record_passes_with_the_jax_checks():
    rec = _record("router_scale", "_cuda")
    _on_the_card(rec)
    jax = _record("router_scale")
    cfg = rec["config"]
    assert not rec["quick"] and cfg["verify"]
    assert cfg["sizes"] == [2048, 8192, 50_000] and cfg["osm_nodes"] \
        == 250_000 and cfg["waypoints"] == 16
    assert [(r["topology"], r["solver"]) for r in rec["rows"]] \
        == [(r["topology"], r["solver"]) for r in jax["rows"]]
    osm = next(r for r in rec["rows"] if r["topology"] == "osm_extract")
    assert osm["nodes"] >= 249_000 and osm["overlay"]["n_levels"] >= 2
    assert rec["checks"] == _twin("router_scale").judge(
        rec["rows"], quick=False, verify=True)
    assert _failed(rec["checks"]) == CARD_RECORDED["router_scale"]
    for r in rec["rows"]:
        if r["solver"] == "hierarchy":
            assert r["aot_buckets"] == [2, 16] and r["query_phases_ms"]


def test_router_scale_card_record_misses_the_multi_level_gate():
    """Queue C 32: on the card the multi-level overlay is no faster than
    one level without hub labels on any row that measured both, so the
    JAX slow test's quick judge, applied to the record's flat row and
    its 50k overlay row, fails exactly the multi-level gate;
    ``chip_smoke.py``'s phase 25 prints it (``ROUTER_RECORDED``). A
    record whose rows pass it retires the entry and this test."""
    rec = _record("router_scale", "_cuda")
    rows = {(r["nodes"], r["topology"]): r for r in rec["rows"]}
    measured = [r for r in rec["rows"] if "multi_level_speedup" in r]
    assert len(measured) >= 2
    assert all(r["multi_level_speedup"] < 1.2 for r in measured)
    quick = _twin("router_scale").judge(
        [rows[(2048, "generator")], rows[(50_000, "generator")]],
        quick=True, verify=True)
    assert _failed(quick) == {"multi_level_speedup_ge_1_2"}
    assert _chip_smoke_constant("ROUTER_RECORDED") == {
        "router_scale": ("multi_level_speedup_ge_1_2",),
        "router_serving": tuple(CARD_RECORDED["router_serving"])}


def test_router_serving_card_record_passes_with_the_jax_checks():
    rec = _record("router_serving", "_cuda")
    _on_the_card(rec)
    jax = _record("router_serving")
    assert not rec["quick"]
    assert rec["extract_nodes"] == jax["extract_nodes"]
    assert rec["offered"] == jax["offered"]
    assert {k: rec["workload"][k] for k in jax["workload"]} \
        == jax["workload"]
    assert rec["slo_threshold_ms"] == jax["slo_threshold_ms"]
    assert "cache_off" in rec
    assert _twin("router_serving").judge(rec) == rec["checks"]
    assert _failed(rec["checks"]) == CARD_RECORDED["router_serving"]
    road = rec["road_router"]
    assert road["nodes"] == jax["road_router"]["nodes"]
    assert road["aot_buckets"] == [2, 4, 16, 32] and road["aot_compile_s"]
    assert rec["launches"] > 0
