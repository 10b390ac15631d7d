"""The port's rtpulint (``routest_tpu_torch/analysis/``) against the JAX
package's (``routest_tpu/analysis/``).

- The 29 cases of ``tests/test_analysis.py`` on the port's engine:
  per-rule fixtures (true positives at exact file:line plus the
  documented false-positive guards), suppression and baseline
  semantics, the seeded-violation matrix, and the whole-port gate with
  its time budget. The three torch rules' cases replace the three JAX
  hazard cases: a flagged line and its guard, for each.
- Parity: a copy of the JAX tree placed as ``routest_tpu_torch/`` under
  ``tmp_path``, with the same docs: every shared rule gives the same
  (rule, path within the package, line, message), findings and
  suppressions, as the JAX engine on ``routest_tpu/`` without a
  baseline.
- ``docs/torch/<name>.md`` joins the shared doc in the port's corpus
  and stays out of the JAX corpus.
- The CLI's exit codes (0, 1, 2), its JSON shape and ``--list-rules``;
  every baseline entry carries a reason, and there are at most six.
- The counterparts of ``tests/test_no_silent_excepts.py`` and
  ``tests/test_no_bare_print.py`` over the port.

Fixture corpora are synthetic repos under tmp_path (a
``routest_tpu_torch/`` tree + ``docs/*.md``) so every rule is exercised
against KNOWN line numbers, independent of the port's drift state.
"""

import json
import os
import shutil
import textwrap
import time

import pytest

from routest_tpu.analysis import analyze as jax_analyze
from routest_tpu.analysis import load_corpus as jax_load_corpus
from routest_tpu_torch.analysis import all_rules, analyze, load_corpus
from routest_tpu_torch.analysis.engine import load_baseline
from routest_tpu_torch.analysis.invariants import PRINT_ALLOWED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_RULES = ("capture-impure-host-call", "capture-host-sync",
               "graph-static-output-reuse")


@pytest.fixture(scope="module")
def port_corpus():
    return load_corpus()


def make_repo(tmp_path, files, docs=None):
    """files: {relpath-under-routest_tpu_torch: source}; docs:
    {name: text}."""
    for rel, text in files.items():
        p = tmp_path / "routest_tpu_torch" / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    (tmp_path / "docs").mkdir(exist_ok=True)
    for name, text in (docs or {}).items():
        (tmp_path / "docs" / name).write_text(textwrap.dedent(text))
    return load_corpus(str(tmp_path))


def run(corpus, *rules):
    return analyze(corpus, rules=list(rules), use_baseline=False)


def keys(result):
    return [(f.file, f.line) for f in result.findings]


# ---------------------------------------------------------------------------
# Invariant lints

def test_silent_except_exact_line_and_narrow_guard(tmp_path):
    corpus = make_repo(tmp_path, {"m.py": """\
        def f():
            try:
                g()
            except Exception:
                pass

        def ok():
            try:
                g()
            except OSError:
                pass  # narrow: swallowing a specific cleanup error is policy
    """})
    result = run(corpus, "silent-except")
    assert keys(result) == [("routest_tpu_torch/m.py", 4)]


def test_bare_print_exact_line_and_method_guard(tmp_path):
    corpus = make_repo(tmp_path, {"m.py": """\
        def f(doc):
            print("status")
            doc.print()          # a method named print is not the builtin
            s = "print this"     # strings don't trip an AST rule
    """})
    result = run(corpus, "bare-print")
    assert keys(result) == [("routest_tpu_torch/m.py", 2)]


def test_broad_except_unlogged_and_its_loud_guards(tmp_path):
    corpus = make_repo(tmp_path, {"m.py": """\
        def bad():
            try:
                g()
            except Exception:
                return None

        def uses_exc(self):
            try:
                g()
            except Exception as e:
                self._error = str(e)   # error propagated into state

        def logs(log):
            try:
                g()
            except Exception:
                log.warning("g_failed")

        def counts(m):
            try:
                g()
            except Exception:
                m.inc()

        def reraises():
            try:
                g()
            except Exception:
                raise RuntimeError("wrapped")
    """})
    result = run(corpus, "broad-except-unlogged")
    assert keys(result) == [("routest_tpu_torch/m.py", 4)]


def test_blocking_call_under_lock_exact_line(tmp_path):
    corpus = make_repo(tmp_path, {"m.py": """\
        import time

        def f(self):
            with self._lock:
                snapshot = dict(self.state)
                time.sleep(0.5)
            return snapshot

        def g(self, sock):
            with self.cache_lock:
                sock.sendall(b"x")
    """})
    result = run(corpus, "blocking-call-under-lock")
    assert keys(result) == [("routest_tpu_torch/m.py", 6), ("routest_tpu_torch/m.py", 11)]


def test_blocking_call_release_in_finally_is_not_flagged(tmp_path):
    # Documented false-positive guard (lexical rule): the
    # acquire/try/finally-release pattern releases the lock via
    # `lock.release()` — no `with <lock>:` body encloses the sleep, so
    # the rule stays silent rather than guessing hold ranges.
    corpus = make_repo(tmp_path, {"m.py": """\
        import time

        def f(lock):
            lock.acquire()
            try:
                x = 1
            finally:
                lock.release()
            time.sleep(0.5)   # lock already released: fine
    """})
    result = run(corpus, "blocking-call-under-lock")
    assert result.findings == []


def test_thread_unmanaged_and_both_guards(tmp_path):
    corpus = make_repo(tmp_path, {"m.py": """\
        import threading

        def bad():
            t = threading.Thread(target=work)
            t.start()

        def daemonized():
            threading.Thread(target=work, daemon=True).start()

        def joined():
            t = threading.Thread(target=work)
            t.start()
            t.join()
    """})
    result = run(corpus, "thread-unmanaged")
    assert keys(result) == [("routest_tpu_torch/m.py", 4)]
    assert result.findings[0].severity == "warning"


# ---------------------------------------------------------------------------
# Capture hazards (the counterparts of the JAX hazards)

def test_capture_impure_host_call_in_each_region_form(tmp_path):
    corpus = make_repo(tmp_path, {"m.py": """\
        import random
        import time
        import torch
        from torch.cuda import graph as capture

        class Head(torch.nn.Module):
            def forward(self, x):
                return x * time.time()

        def make():
            return Head()

        def export_it(x):
            fwd = make().eval()
            return torch.export.export(fwd, (x,))

        def step(x):
            return x + random.random()

        graphed = torch.cuda.make_graphed_callables(step, (torch.zeros(2),))

        def capture_it(g, x):
            with capture(g):
                y = x * time.perf_counter()
            return y

        def host_side(x):
            return x * time.time()   # not captured: fine
    """})
    result = run(corpus, "capture-impure-host-call")
    assert keys(result) == [("routest_tpu_torch/m.py", 8),
                            ("routest_tpu_torch/m.py", 18),
                            ("routest_tpu_torch/m.py", 24)]


def test_capture_host_sync_in_trace_and_graph(tmp_path):
    corpus = make_repo(tmp_path, {"m.py": """\
        import numpy as np
        import torch

        def traced(x, table):
            n = x.sum().item()
            host = np.asarray(x)
            local = np.asarray([1, 2])   # not a tensor input: fine
            return x * n

        program = torch.jit.trace(traced, (torch.zeros(2), None))

        def capture(g, x):
            with torch.cuda.graph(g):
                y = x * 2
                torch.cuda.synchronize()
            return y.cpu()                # after the capture: fine
    """})
    result = run(corpus, "capture-host-sync")
    assert keys(result) == [("routest_tpu_torch/m.py", 5),
                            ("routest_tpu_torch/m.py", 6),
                            ("routest_tpu_torch/m.py", 15)]


def test_graph_static_output_reuse_and_clone_guard(tmp_path):
    corpus = make_repo(tmp_path, {"m.py": """\
        import torch

        def serve(model, static_in):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                static_out = model(static_in)
            g.replay()
            first = static_out[:4]
            kept = static_out.clone()     # a copy: fine
            g.replay()
            return first.sum(), kept.sum(), static_out.sum()

        def fresh(model, static_in):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                static_out = model(static_in)
            g.replay()
            view = static_out.view(-1)
            g.replay()
            view = static_out.view(-1)    # re-bound after the replay: fine
            return view.sum()
    """})
    result = run(corpus, "graph-static-output-reuse")
    assert keys(result) == [("routest_tpu_torch/m.py", 11)]
    assert "`first`" in result.findings[0].message


# ---------------------------------------------------------------------------
# Drift detectors

CONFIG_SRC = """\
    KNOWN_KNOBS = {
        "RTPU_DECLARED_KNOB": "a declared knob",
    }
"""


def test_env_knob_undeclared(tmp_path):
    corpus = make_repo(tmp_path, {
        "core/config.py": CONFIG_SRC,
        "serve/m.py": """\
            import os

            def f(env):
                a = os.environ.get("RTPU_DECLARED_KNOB")
                b = env.get("RTPU_GHOST_KNOB")
                return a, b
        """,
    }, docs={"API.md": "RTPU_DECLARED_KNOB RTPU_GHOST_KNOB"})
    result = run(corpus, "env-knob-undeclared")
    assert keys(result) == [("routest_tpu_torch/serve/m.py", 5)]
    assert "RTPU_GHOST_KNOB" in result.findings[0].message


def test_env_knob_undeclared_ignores_docstring_mentions(tmp_path):
    corpus = make_repo(tmp_path, {
        "core/config.py": CONFIG_SRC,
        "serve/m.py": '''\
            """Mentions RTPU_PROSE_ONLY_KNOB in prose — not a read."""

            def f():
                return 1
        ''',
    })
    result = run(corpus, "env-knob-undeclared")
    assert result.findings == []


def test_env_knob_undocumented(tmp_path):
    corpus = make_repo(tmp_path, {
        "core/config.py": CONFIG_SRC + (
            '    import os\n'
            '    UNDOC = os.environ.get("RTPU_UNDOCUMENTED_KNOB")\n'),
    }, docs={"ARCHITECTURE.md": "| `RTPU_DECLARED_KNOB` | documented |"})
    result = run(corpus, "env-knob-undocumented")
    assert len(result.findings) == 1
    assert "RTPU_UNDOCUMENTED_KNOB" in result.findings[0].message
    assert result.findings[0].file == "routest_tpu_torch/core/config.py"


def test_metric_undocumented_exact_line(tmp_path):
    corpus = make_repo(tmp_path, {"obs/m.py": """\
        def setup(reg):
            a = reg.counter("rtpu_documented_total", "fine")
            b = reg.gauge(
                "rtpu_ghost_gauge", "missing from the doc")
            return a, b
    """}, docs={"OBSERVABILITY.md": "| `rtpu_documented_total` | counter |"})
    result = run(corpus, "metric-undocumented")
    assert keys(result) == [("routest_tpu_torch/obs/m.py", 4)]
    assert "rtpu_ghost_gauge" in result.findings[0].message


def test_metric_stale_doc_and_exposition_suffix_guard(tmp_path):
    corpus = make_repo(tmp_path, {"obs/m.py": """\
        def setup(reg):
            return reg.histogram("rtpu_real_seconds", "registered")
    """}, docs={"OBSERVABILITY.md": """\
        `rtpu_real_seconds` and its exposition `rtpu_real_seconds_bucket`
        samples are fine; `rtpu_phantom_total` names nothing.
    """})
    result = run(corpus, "metric-stale-doc")
    assert keys(result) == [("docs/OBSERVABILITY.md", 2)]
    assert "rtpu_phantom_total" in result.findings[0].message


def test_api_route_undocumented_and_param_prefix_guard(tmp_path):
    corpus = make_repo(tmp_path, {"serve/app.py": """\
        ROUTES = [
            "/api/known",
            "/api/known/<item_id>",
            "/api/secret",
        ]
    """}, docs={"API.md": "| `POST /api/known` | and `/api/known/<id>` |"})
    result = run(corpus, "api-route-undocumented")
    assert keys(result) == [("routest_tpu_torch/serve/app.py", 4)]
    assert "/api/secret" in result.findings[0].message


def test_chaos_point_undocumented_including_fstring_prefix(tmp_path):
    corpus = make_repo(tmp_path, {"serve/m.py": """\
        from routest_tpu_torch.chaos import inject

        def f(rid):
            inject("store.http")
            inject("ghost.boundary")
            inject(f"ghost.perreplica.{rid}")
    """}, docs={"ROBUSTNESS.md": "| `store.http` | documented |"})
    result = run(corpus, "chaos-point-undocumented")
    assert keys(result) == [("routest_tpu_torch/serve/m.py", 5),
                            ("routest_tpu_torch/serve/m.py", 6)]


def test_chaos_point_collision_across_modules(tmp_path):
    corpus = make_repo(tmp_path, {
        "serve/a.py": """\
            from routest_tpu_torch.chaos import inject

            def f():
                inject("shared.point")
        """,
        "serve/b.py": """\
            from routest_tpu_torch.chaos import inject

            def g():
                inject("shared.point")
        """,
    }, docs={"ROBUSTNESS.md": "`shared.point`"})
    result = run(corpus, "chaos-point-collision")
    assert keys(result) == [("routest_tpu_torch/serve/b.py", 4)]


# ---------------------------------------------------------------------------
# Change-ledger kinds ↔ LEDGER_KINDS + docs

_LEDGER_STUB = """\
    LEDGER_KINDS = {
        "model.swap": "verified serving swap",
        "live.flip": "live-metric epoch flip",
    }

    def record_change(kind, **kwargs):
        pass
"""


def test_ledger_kind_unregistered_both_call_forms(tmp_path):
    corpus = make_repo(tmp_path, {
        "obs/ledger.py": _LEDGER_STUB,
        "serve/x.py": """\
            from routest_tpu_torch.obs.ledger import record_change

            def f():
                record_change("model.swap", detail={"generation": 1})
                record_change("model.retired_kind")
                record_change(kind="live.flip")
        """,
    }, docs={"OBSERVABILITY.md":
             "`model.swap` `live.flip` `model.retired_kind`"})
    result = run(corpus, "ledger-kind-unregistered")
    assert keys(result) == [("routest_tpu_torch/serve/x.py", 5)]


def test_ledger_kind_undocumented_exact_line(tmp_path):
    corpus = make_repo(tmp_path, {
        "obs/ledger.py": _LEDGER_STUB,
        "serve/x.py": """\
            from routest_tpu_torch.obs.ledger import record_change

            def f():
                record_change("model.swap")
                record_change("live.flip")
        """,
    }, docs={"OBSERVABILITY.md": "## Change ledger\n\n`model.swap`"})
    result = run(corpus, "ledger-kind-undocumented")
    assert keys(result) == [("routest_tpu_torch/serve/x.py", 5)]


def test_ledger_kind_stale_doc_scans_table_rows_only(tmp_path):
    corpus = make_repo(tmp_path, {
        "obs/ledger.py": _LEDGER_STUB,
        "serve/x.py": """\
            from routest_tpu_torch.obs.ledger import record_change

            def f():
                record_change("model.swap")
        """,
    }, docs={"OBSERVABILITY.md": """\
        # Observability

        ## Change ledger & incident correlation

        Events cross regions on the `rtpu.changes` channel.

        | kind | meaning |
        | --- | --- |
        | `model.swap` | verified swap |
        | `model.retired` | gone from the code |

        ## Next section
    """})
    result = run(corpus, "ledger-kind-stale-doc")
    # only the table row with the unregistered kind fires; the prose
    # mention of the bus channel does not.
    assert keys(result) == [("docs/OBSERVABILITY.md", 10)]


# ---------------------------------------------------------------------------
# Suppressions & baseline semantics

def test_suppression_same_line_and_line_above(tmp_path):
    corpus = make_repo(tmp_path, {"m.py": """\
        def f():
            try:
                g()
            except Exception:  # rtpulint: disable=silent-except -- boot probe, failure means not-ready
                pass

        def h():
            try:
                g()
            # rtpulint: disable=silent-except -- standalone comment covers the next line
            except Exception:
                pass
    """})
    result = run(corpus, "silent-except")
    assert result.findings == []
    assert len(result.suppressed) == 2


def test_suppression_for_another_rule_does_not_apply(tmp_path):
    corpus = make_repo(tmp_path, {"m.py": """\
        def f():
            try:
                g()
            except Exception:  # rtpulint: disable=bare-print -- wrong rule id
                pass
    """})
    result = run(corpus, "silent-except")
    assert keys(result) == [("routest_tpu_torch/m.py", 4)]


def test_suppression_without_reason_is_ignored_and_reported(tmp_path):
    corpus = make_repo(tmp_path, {"m.py": """\
        def f():
            try:
                g()
            except Exception:  # rtpulint: disable=silent-except
                pass
    """})
    result = run(corpus, "silent-except")
    rules = {(f.rule, f.line) for f in result.findings}
    assert ("silent-except", 4) in rules     # NOT suppressed
    assert ("bad-suppression", 4) in rules   # and the waiver is flagged


def test_baseline_grandfathers_exact_key_and_requires_reason(tmp_path):
    corpus = make_repo(tmp_path, {"m.py": """\
        def f():
            try:
                g()
            except Exception:
                pass
    """})
    good = tmp_path / "baseline.json"
    good.write_text(json.dumps([{"rule": "silent-except",
                                 "file": "routest_tpu_torch/m.py", "line": 4,
                                 "reason": "grandfathered: pre-engine code"},
                                {"rule": "silent-except",
                                 "file": "routest_tpu_torch/gone.py", "line": 1,
                                 "reason": "stale entry"}]))
    result = analyze(corpus, rules=["silent-except"],
                     baseline_path=str(good))
    assert result.findings == []
    assert len(result.baselined) == 1
    assert [e.file for e in result.stale_baseline] == ["routest_tpu_torch/gone.py"]
    assert result.gate_ok

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"rule": "silent-except",
                                "file": "routest_tpu_torch/m.py", "line": 4,
                                "reason": ""}]))
    result = analyze(corpus, rules=["silent-except"],
                     baseline_path=str(bad))
    assert result.baseline_errors          # reason is mandatory
    assert not result.gate_ok


def test_checked_in_baseline_entries_all_carry_reasons():
    entries, errors = load_baseline()
    assert errors == []
    assert all(e.reason.strip() for e in entries)


# ---------------------------------------------------------------------------
# Seeded violations of every family, one synthetic repo (the
# acceptance-criteria matrix: each caught at its exact file:line).

def test_seeded_violation_matrix(tmp_path):
    corpus = make_repo(tmp_path, {
        "core/config.py": CONFIG_SRC,
        "serve/seeded.py": """\
            import os
            import time
            import torch

            def undeclared_knob(env):
                return env.get("RTPU_SEEDED_GHOST_KNOB")        # line 6

            def silent():
                try:
                    g()
                except Exception:                                # line 11
                    pass

            def sleepy(self):
                with self._lock:
                    time.sleep(1.0)                              # line 16

            def frozen_clock(g, x):
                with torch.cuda.graph(g):
                    return x * time.time()                       # line 20

            def metrics(reg):
                return reg.counter("rtpu_seeded_ghost_total")    # line 23
        """,
    }, docs={"OBSERVABILITY.md": "no families here",
             "API.md": "RTPU_SEEDED_GHOST_KNOB mentioned so only the "
                       "undeclared rule fires"})
    result = analyze(corpus, rules=[
        "env-knob-undeclared", "silent-except", "blocking-call-under-lock",
        "capture-impure-host-call", "metric-undocumented"],
        use_baseline=False)
    got = {(f.rule, f.file, f.line) for f in result.findings}
    seeded = "routest_tpu_torch/serve/seeded.py"
    assert got == {
        ("env-knob-undeclared", seeded, 6),
        ("silent-except", seeded, 11),
        ("blocking-call-under-lock", seeded, 16),
        ("capture-impure-host-call", seeded, 20),
        ("metric-undocumented", seeded, 23),
    }


# ---------------------------------------------------------------------------
# The tier-1 whole-repo gate + budget

def test_whole_repo_gate_is_clean_and_fast():
    """Every rule over the whole port: zero unbaselined findings at
    HEAD, every baseline entry reasoned, and the run bounded so the
    engine can't quietly become the slowest tier-1 item."""
    t0 = time.perf_counter()
    corpus = load_corpus()
    result = analyze(corpus)
    elapsed = time.perf_counter() - t0
    assert result.files_scanned >= 100         # the real package, not a stub
    assert len(result.rules_run) >= 15
    diagnostics = "\n".join(f.format() for f in result.findings)
    assert result.findings == [], f"rtpulint gate:\n{diagnostics}"
    assert result.baseline_errors == []
    for e in result.stale_baseline:
        pytest.fail(f"stale baseline entry: {e.rule} {e.file}:{e.line}")
    assert elapsed < 10.0, (
        f"whole-repo analysis took {elapsed:.1f}s (budget 10s): profile "
        f"the newest rule — one parse per file is the contract")


def test_cli_gate_exits_zero_and_json_shape(capsys):
    from routest_tpu_torch.analysis.__main__ import main

    assert main(["--gate"]) == 0
    assert main(["--gate", "--json"]) == 0
    out = capsys.readouterr().out
    payload = json.loads(out[out.index("{"):])
    assert payload["gate_ok"] is True
    assert payload["files_scanned"] >= 100

    assert main(["--rule", "no-such-rule"]) == 2


def test_rule_catalog_metadata():
    rules = all_rules()
    for rule in rules.values():
        assert rule.severity in ("error", "warning")
        assert rule.description and rule.hint
    # The families the tentpole promises all exist.
    for rid in ("silent-except", "bare-print", "broad-except-unlogged",
                "blocking-call-under-lock", "thread-unmanaged",
                "capture-impure-host-call", "capture-host-sync",
                "graph-static-output-reuse", "env-knob-undeclared",
                "env-knob-undocumented", "metric-undocumented",
                "metric-stale-doc", "api-route-undocumented",
                "chaos-point-undocumented", "chaos-point-collision",
                "ledger-kind-unregistered", "ledger-kind-undocumented",
                "ledger-kind-stale-doc", "bad-suppression"):
        assert rid in rules, rid
    assert not [rid for rid in rules if rid.startswith("jit-")]


# ---------------------------------------------------------------------------
# Beyond the JAX cases: the CLI's other exits, the baseline's size, the
# port's capture regions, the joined docs, parity with the JAX engine.

def test_cli_exit_one_on_findings_and_list_rules(tmp_path, capsys):
    from routest_tpu_torch.analysis.__main__ import main

    make_repo(tmp_path, {"m.py": """\
        def f():
            print("status")
    """})
    assert main(["--gate", "--root", str(tmp_path), "--no-baseline"]) == 1
    out = capsys.readouterr().out
    assert "routest_tpu_torch/m.py:2: [bare-print] error:" in out
    assert "rtpulint: 1 finding(s)" in out
    assert main(["--list-rules"]) == 0
    listed = [line.split(" ")[0] for line in
              capsys.readouterr().out.splitlines()
              if line and not line.startswith(" ")]
    assert set(TORCH_RULES) <= set(listed)
    assert not [r for r in listed if r.startswith("jit-")]
    assert len(listed) == len(all_rules())


def test_baseline_is_small_and_reasoned():
    entries, errors = load_baseline()
    assert errors == [] and 0 < len(entries) <= 6
    assert all(len(e.reason.split()) >= 10 for e in entries)
    # jsdom's Response.json() carries the JAX baseline's entry; the rest
    # are the declared divergences from the shared docs.
    kinds = {(e.rule, e.file.split("/")[0]) for e in entries}
    assert kinds <= {("broad-except-unlogged", "routest_tpu_torch"),
                     ("metric-stale-doc", "docs")}
    with open(os.path.join(REPO, "docs", "torch", "OBSERVABILITY.md"),
              encoding="utf-8") as f:
        divergences = f.read()
    for e in entries:
        if e.rule == "metric-stale-doc":
            family = e.reason.split("rtpu_", 1)[1].split()[0]
            assert f"`rtpu_{family}`" in divergences, family


def test_port_capture_regions_are_seen(port_corpus):
    # The rules see the port's real capture sites, and find them clean.
    from routest_tpu_torch.analysis.torchrules import _regions

    seen = {sf.relpath: [label for label, _, _ in _regions(sf)]
            for sf in port_corpus.files if _regions(sf)}
    assert "torch.cuda.graph capture" in \
        seen["routest_tpu_torch/utils/cuda_timing.py"]
    assert any("forward" in label for label in
               seen["routest_tpu_torch/train/checkpoint.py"])
    result = analyze(port_corpus, rules=list(TORCH_RULES),
                     use_baseline=False)
    assert result.findings == []


def test_torch_docs_join_the_shared_docs(tmp_path):
    files = {"core/config.py": CONFIG_SRC + (
                 '    import os\n'
                 '    A = os.environ.get("RTPU_DECLARED_KNOB")\n'),
             "obs/m.py": """\
                def setup(reg):
                    return reg.gauge("rtpu_port_only_gauge", "port")
             """}
    corpus = make_repo(tmp_path, files, docs={
        "OBSERVABILITY.md": "shared: nothing of the port's"})
    got = run(corpus, "env-knob-undocumented", "metric-undocumented")
    assert len(got.findings) == 2
    (tmp_path / "docs" / "torch").mkdir()
    (tmp_path / "docs" / "torch" / "OBSERVABILITY.md").write_text(
        "| `rtpu_port_only_gauge` | gauge |\n"
        "`RTPU_DECLARED_KNOB` is the port's\n"
        "`rtpu_stale_port_row` names nothing\n")
    corpus = load_corpus(str(tmp_path))
    got = run(corpus, "env-knob-undocumented", "metric-undocumented",
              "metric-stale-doc")
    # a finding inside a doc anchors at the file that names the token
    assert keys(got) == [("docs/torch/OBSERVABILITY.md", 3)]
    # ... and the JAX corpus lists only the top-level docs/*.md
    (tmp_path / "routest_tpu").mkdir()
    assert set(jax_load_corpus(str(tmp_path)).docs) == {"OBSERVABILITY.md"}
    assert "rtpu_port_only_gauge" not in \
        jax_load_corpus(str(tmp_path)).doc("OBSERVABILITY.md")


def test_jax_gate_input_ignores_the_port_docs():
    corpus = jax_load_corpus()
    assert os.path.isdir(os.path.join(REPO, "docs", "torch"))
    assert set(corpus.docs) == {name for name in os.listdir(
        os.path.join(REPO, "docs")) if name.endswith(".md")}
    assert "rtpu_fused_launches" not in "".join(corpus.docs.values())


def _shared(result_findings):
    """(rule, path within the package, line, message) of each finding."""
    out = set()
    for f in result_findings:
        head, _, rest = f.file.partition("/")
        where = rest if head in ("routest_tpu", "routest_tpu_torch") \
            else f.file
        out.add((f.rule, where, f.line, f.message))
    return out


def test_parity_with_the_jax_engine_on_the_jax_tree(tmp_path):
    """The JAX tree copied as ``routest_tpu_torch/`` with the same docs:
    every rule the two engines share finds and suppresses exactly what
    the JAX engine does on ``routest_tpu/``."""
    src = os.path.join(REPO, "routest_tpu")
    for dirpath, dirnames, filenames in os.walk(src):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in filenames:
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, name), src)
                dst = tmp_path / "routest_tpu_torch" / rel
                dst.parent.mkdir(parents=True, exist_ok=True)
                shutil.copyfile(os.path.join(dirpath, name), dst)
    (tmp_path / "docs").mkdir()
    for name in os.listdir(os.path.join(REPO, "docs")):
        if name.endswith(".md"):
            shutil.copyfile(os.path.join(REPO, "docs", name),
                            tmp_path / "docs" / name)
    from routest_tpu.analysis import all_rules as jax_all_rules

    shared = sorted(set(all_rules()) & set(jax_all_rules()))
    assert len(shared) == 16 and not set(TORCH_RULES) & set(shared)
    want = jax_analyze(jax_load_corpus(), rules=shared, use_baseline=False)
    got = analyze(load_corpus(str(tmp_path)), rules=shared,
                  use_baseline=False)
    assert got.files_scanned == want.files_scanned
    assert _shared(got.findings) == _shared(want.findings)
    assert _shared(got.suppressed) == _shared(want.suppressed)
    assert len(want.suppressed) >= 10          # the comparison has teeth


# ---------------------------------------------------------------------------
# The counterparts of tests/test_no_silent_excepts.py and
# tests/test_no_bare_print.py, over the port.

def test_no_silent_broad_excepts_port_wide(port_corpus):
    result = analyze(port_corpus, rules=["silent-except"])
    assert not result.findings, (
        "silent broad except (log a JsonLogger event, count a metric, "
        "or narrow the type):\n"
        + "\n".join(f.format() for f in result.findings))


def test_sweep_is_port_wide(port_corpus):
    seen_dirs = {f.relpath.split("/")[1] for f in port_corpus.files
                 if f.relpath.count("/") >= 2}
    for tree in ("core", "utils", "train", "models", "serve", "obs",
                 "optimize", "live", "loadgen", "chaos", "analysis",
                 "dispatch", "ops", "parallel"):
        assert tree in seen_dirs, f"corpus misses routest_tpu_torch/{tree}/"
    for module in ("serve/fleet/placement.py", "obs/timeline.py",
                   "obs/profiler.py", "obs/export.py", "utils/jsdom.py",
                   "utils/minijs.py"):
        assert port_corpus.file(f"routest_tpu_torch/{module}") is not None


def test_no_bare_print_in_port(port_corpus):
    result = analyze(port_corpus, rules=["bare-print"])
    assert not result.findings, (
        "bare print() found (use utils.logging.JsonLogger):\n"
        + "\n".join(f.format() for f in result.findings))


def test_print_allowlist_stays_minimal():
    # The JAX package's two sites, plus the three training CLIs whose
    # stdout is their interface (the JAX package keeps them as scripts,
    # outside its gate).
    assert PRINT_ALLOWED == {"routest_tpu_torch/utils/logging.py",
                             "routest_tpu_torch/analysis/__main__.py",
                             "routest_tpu_torch/train/__main__.py",
                             "routest_tpu_torch/train/gnn.py",
                             "routest_tpu_torch/train/transformer.py"}
