"""Drift detectors: the port's code cross-referenced against its
registries.

The detectors of ``routest_tpu/analysis/drift.py`` over the port's
``serve/``, ``obs/``, ``chaos/`` and ledger call sites, against the
port's ``core/config.py`` and ``obs/ledger.py``. A doc is the shared
``docs/<name>.md`` joined with ``docs/torch/<name>.md``
(``Corpus.docs``); a finding inside a doc anchors at the file that
names the token.

The invariants that actually rot here are not style — they are the
contracts between the code and its registries: every ``RTPU_*`` /
``ROUTEST_*`` env knob read anywhere must be declared in
``core/config.py`` (the single typed registry) and documented in a docs
knob table; every ``rtpu_*`` metric family registered must appear in
docs/OBSERVABILITY.md and vice versa; every ``/api/*`` route string in
``serve/`` must have a docs/API.md row; every chaos point name passed
to the chaos layer must be unique across modules and documented in
docs/ROBUSTNESS.md. Each detector extracts its facts from the shared
ASTs (never from comments/strings-by-grep) and anchors findings at the
offending read/registration site — or at the stale doc line for the
doc→code direction.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from routest_tpu_torch.analysis.engine import (
    PACKAGE, Corpus, Finding, Rule, call_leaf, dotted_name, register,
)

ENV_NAME_RE = re.compile(r"^(?:RTPU|ROUTEST)_[A-Z0-9_]*[A-Z0-9]$")
ENV_TOKEN_RE = re.compile(r"\b(?:RTPU|ROUTEST)_[A-Z0-9_]*[A-Z0-9]\b")
METRIC_NAME_RE = re.compile(r"^rtpu_[a-z0-9_]*[a-z0-9]$")
METRIC_TOKEN_RE = re.compile(r"\brtpu_[a-z0-9_]*[a-z0-9]\b")

CONFIG_REL = f"{PACKAGE}/core/config.py"


def _env_reads(corpus: Corpus) -> List[Tuple[str, str, int]]:
    """(knob, file, line) for every env-name string literal used as a
    call argument, subscript index, or comparison operand — i.e. an
    actual read/probe site, never a docstring or comment mention."""
    out: List[Tuple[str, str, int]] = []
    for sf in corpus.files:
        for node in sf.nodes():
            args: List[ast.AST] = []
            if isinstance(node, ast.Call):
                args = list(node.args) + [k.value for k in node.keywords]
            elif isinstance(node, ast.Subscript):
                args = [node.slice]
            elif isinstance(node, ast.Compare):
                args = [node.left] + list(node.comparators)
            for a in args:
                if (isinstance(a, ast.Constant) and isinstance(a.value, str)
                        and ENV_NAME_RE.match(a.value)):
                    out.append((a.value, sf.relpath, a.lineno))
    return out


def _first_sites(reads: List[Tuple[str, str, int]]
                 ) -> Dict[str, Tuple[str, int]]:
    sites: Dict[str, Tuple[str, int]] = {}
    for name, file, line in sorted(reads, key=lambda r: (r[0], r[1], r[2])):
        sites.setdefault(name, (file, line))
    return sites


@register(
    "env-knob-undeclared", "error",
    "an RTPU_*/ROUTEST_* env var is read outside core/config.py but "
    "never declared there — the typed config registry is how a deploy "
    "discovers the knob exists",
    "add the knob to the matching Config dataclass loader, or to the "
    "KNOWN_KNOBS registry in core/config.py when it is read lazily at "
    "its use site")
def env_knob_undeclared(rule: Rule, corpus: Corpus) -> Iterator[Finding]:
    cfg = corpus.file(CONFIG_REL)
    if cfg is None:
        return
    declared = set(ENV_TOKEN_RE.findall(cfg.text))
    reads = [(n, f, ln) for n, f, ln in _env_reads(corpus)
             if f != CONFIG_REL]
    for name, (file, line) in sorted(_first_sites(reads).items()):
        if name not in declared:
            yield rule.finding(
                file, line,
                f"env knob `{name}` is read here but not declared in "
                f"core/config.py")


@register(
    "env-knob-undocumented", "error",
    "an RTPU_*/ROUTEST_* env var is read by the package but appears in "
    "no docs/*.md knob table — operators cannot tune what the docs "
    "don't name",
    "add a row to the owning subsystem's knob table, or to the "
    "complete knob reference in docs/ARCHITECTURE.md (appendix)")
def env_knob_undocumented(rule: Rule, corpus: Corpus) -> Iterator[Finding]:
    if not corpus.docs:
        return  # no docs checkout (installed package) — nothing to check
    documented: Set[str] = set()
    for text in corpus.docs.values():
        documented |= set(ENV_TOKEN_RE.findall(text))
    for name, (file, line) in sorted(
            _first_sites(_env_reads(corpus)).items()):
        if name not in documented:
            yield rule.finding(
                file, line,
                f"env knob `{name}` is read here but documented in no "
                f"docs/*.md")


# ---------------------------------------------------------------------------
# Metric families ↔ docs/OBSERVABILITY.md

def _registered_metrics(corpus: Corpus) -> Dict[str, Tuple[str, int]]:
    """family name -> first (file, line) registration site, extracted
    from ``.counter("rtpu_…")`` / ``.gauge`` / ``.histogram`` calls."""
    out: Dict[str, Tuple[str, int]] = {}
    for sf in corpus.files:
        for node in sf.nodes():
            if not isinstance(node, ast.Call):
                continue
            if call_leaf(node) not in ("counter", "gauge", "histogram"):
                continue
            if not isinstance(node.func, ast.Attribute):
                continue
            if not node.args:
                continue
            a = node.args[0]
            if (isinstance(a, ast.Constant) and isinstance(a.value, str)
                    and METRIC_NAME_RE.match(a.value)):
                key = a.value
                if (key not in out
                        or (sf.relpath, a.lineno) < out[key]):
                    out[key] = (sf.relpath, a.lineno)
    return out


@register(
    "metric-undocumented", "error",
    "an rtpu_* metric family is registered in code but absent from "
    "docs/OBSERVABILITY.md — dashboards and alerts are built from the "
    "doc, so an undocumented family is invisible telemetry",
    "add the family to the metric reference table in "
    "docs/OBSERVABILITY.md")
def metric_undocumented(rule: Rule, corpus: Corpus) -> Iterator[Finding]:
    doc = corpus.doc("OBSERVABILITY.md")
    if not doc:
        return
    documented = set(METRIC_TOKEN_RE.findall(doc))
    for name, (file, line) in sorted(_registered_metrics(corpus).items()):
        if name not in documented:
            yield rule.finding(
                file, line,
                f"metric family `{name}` is registered here but not "
                f"documented in docs/OBSERVABILITY.md")


# Prometheus exposition suffixes: a doc may legitimately show
# `<family>_bucket` / `_sum` / `_count` sample lines for a histogram.
_EXPOSITION_SUFFIXES = ("_bucket", "_sum", "_count")


@register(
    "metric-stale-doc", "error",
    "docs/OBSERVABILITY.md names an rtpu_* metric family that no code "
    "registers — a dashboard built from that row queries nothing",
    "remove the stale row, or rename it to the family the code "
    "actually registers")
def metric_stale_doc(rule: Rule, corpus: Corpus) -> Iterator[Finding]:
    doc = corpus.doc("OBSERVABILITY.md")
    if not doc:
        return
    registered = set(_registered_metrics(corpus))
    seen: Set[str] = set()
    for token in METRIC_TOKEN_RE.findall(doc):
        if token in seen:
            continue
        seen.add(token)
        base = token
        for suf in _EXPOSITION_SUFFIXES:
            if token.endswith(suf) and token[:-len(suf)] in registered:
                base = token[:-len(suf)]
                break
        if base in registered:
            continue
        yield rule.finding(
            *corpus.doc_anchor("OBSERVABILITY.md", token),
            f"documented metric family `{token}` is registered nowhere "
            f"in the package")


# ---------------------------------------------------------------------------
# /api/* routes ↔ docs/API.md

@register(
    "api-route-undocumented", "error",
    "an /api/* route string in serve/ has no docs/API.md row — the API "
    "reference is the wire contract the frontend and the gateway "
    "tests are written against",
    "add a row to the matching docs/API.md table")
def api_route_undocumented(rule: Rule, corpus: Corpus) -> Iterator[Finding]:
    doc = corpus.doc("API.md")
    if not doc:
        return
    seen: Set[str] = set()
    for sf in corpus.files:
        if not sf.relpath.startswith(f"{PACKAGE}/serve/"):
            continue
        for node in sf.nodes():
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            v = node.value
            if not v.startswith("/api/") or " " in v or "\n" in v:
                continue
            # Parameterized registrations (`/api/history/<req_id>`)
            # document as `<id>`-style rows: compare the static prefix.
            prefix = v.split("<", 1)[0]
            if prefix in seen:
                continue
            seen.add(prefix)
            if prefix not in doc:
                yield rule.finding(
                    sf.relpath, node.lineno,
                    f"route `{v}` has no docs/API.md row")


# ---------------------------------------------------------------------------
# Chaos points ↔ docs/ROBUSTNESS.md + uniqueness

def _chaos_points(corpus: Corpus
                  ) -> List[Tuple[str, bool, str, int]]:
    """(point-or-prefix, is_prefix, file, line) for every literal (or
    f-string-prefixed) name passed to the chaos layer's ``inject()``."""
    out: List[Tuple[str, bool, str, int]] = []
    for sf in corpus.files:
        for node in sf.nodes():
            if not isinstance(node, ast.Call):
                continue
            # Direct `inject(...)`, aliased `chaos_inject(...)`, and
            # method-form `engine.inject(...)` all reach the chaos layer.
            if call_leaf(node) not in ("inject", "chaos_inject") \
                    or not node.args:
                continue
            a = node.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                if re.match(r"^[a-z][a-z0-9_.]*$", a.value):
                    out.append((a.value, False, sf.relpath, a.lineno))
            elif isinstance(a, ast.JoinedStr) and a.values:
                head = a.values[0]
                if (isinstance(head, ast.Constant)
                        and isinstance(head.value, str)
                        and re.match(r"^[a-z][a-z0-9_.]*\.$", head.value)):
                    out.append((head.value.rstrip("."), True,
                                sf.relpath, a.lineno))
    return out


@register(
    "chaos-point-undocumented", "error",
    "a chaos fault-point name is injected in code but missing from the "
    "docs/ROBUSTNESS.md fault-point table — an undocumented point "
    "cannot be targeted by an operator's RTPU_CHAOS_SPEC",
    "add the point to the fault-point table in docs/ROBUSTNESS.md")
def chaos_point_undocumented(rule: Rule, corpus: Corpus
                             ) -> Iterator[Finding]:
    doc = corpus.doc("ROBUSTNESS.md")
    if not doc:
        return
    seen: Set[str] = set()
    for name, _is_prefix, file, line in _chaos_points(corpus):
        if name in seen:
            continue
        seen.add(name)
        if name not in doc:
            yield rule.finding(
                file, line,
                f"chaos point `{name}` has no docs/ROBUSTNESS.md row")


@register(
    "chaos-point-collision", "error",
    "the same chaos point name is injected from two different modules "
    "— a spec targeting it would fire at an unintended boundary too, "
    "and injection counters for the two boundaries merge",
    "rename one of the points (convention: `<subsystem>.<operation>`)")
def chaos_point_collision(rule: Rule, corpus: Corpus) -> Iterator[Finding]:
    by_name: Dict[str, Dict[str, int]] = {}
    for name, is_prefix, file, line in _chaos_points(corpus):
        if is_prefix:
            continue  # per-replica/per-version dynamic families
        by_name.setdefault(name, {}).setdefault(file, line)
    for name, files in sorted(by_name.items()):
        if len(files) <= 1:
            continue
        ordered = sorted(files.items())
        first = ordered[0][0]
        for file, line in ordered[1:]:
            yield rule.finding(
                file, line,
                f"chaos point `{name}` is also injected from {first} — "
                f"point names must be unique per boundary")


# ---------------------------------------------------------------------------
# Change-ledger kinds ↔ LEDGER_KINDS registry + docs/OBSERVABILITY.md

LEDGER_REL = f"{PACKAGE}/obs/ledger.py"
LEDGER_KIND_RE = re.compile(r"^[a-z][a-z_]*\.[a-z][a-z_]*$")


def _ledger_registered_kinds(corpus: Corpus) -> Set[str]:
    """Keys of the ``LEDGER_KINDS`` dict literal in obs/ledger.py —
    the typed registry every ``record_change`` kind must come from."""
    sf = corpus.file(LEDGER_REL)
    if sf is None:
        return set()
    kinds: Set[str] = set()
    for node in sf.nodes():
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == "LEDGER_KINDS"
                   for t in node.targets):
            continue
        if isinstance(node.value, ast.Dict):
            for key in node.value.keys:
                if (isinstance(key, ast.Constant)
                        and isinstance(key.value, str)):
                    kinds.add(key.value)
    return kinds


def _ledger_kind_sites(corpus: Corpus) -> List[Tuple[str, str, int]]:
    """(kind, file, line) for every literal kind passed to the change
    ledger — ``record_change("…")`` helper calls and ``.record("…")``
    method calls whose kind matches the ledger grammar."""
    out: List[Tuple[str, str, int]] = []
    for sf in corpus.files:
        if sf.relpath == LEDGER_REL:
            continue  # the registry itself (docstrings, defaults)
        for node in sf.nodes():
            if not isinstance(node, ast.Call):
                continue
            if call_leaf(node) != "record_change":
                continue
            a: Optional[ast.AST] = node.args[0] if node.args else None
            if a is None:
                for kw in node.keywords:
                    if kw.arg == "kind":
                        a = kw.value
                        break
            if (isinstance(a, ast.Constant) and isinstance(a.value, str)
                    and LEDGER_KIND_RE.match(a.value)):
                out.append((a.value, sf.relpath, a.lineno))
    return out


def _ledger_doc_section(doc: str) -> Tuple[str, int]:
    """The "Change ledger" section of one OBSERVABILITY.md (text,
    first-line offset) — the doc→code direction only scans there, so
    chaos points and metric names elsewhere never false-positive."""
    if not doc:
        return "", 0
    lines = doc.splitlines()
    start = end = None
    for i, line in enumerate(lines):
        if start is None:
            if line.startswith("#") and "change ledger" in line.lower():
                start = i
        elif line.startswith("## "):
            end = i
            break
    if start is None:
        return "", 0
    return "\n".join(lines[start:end]), start


@register(
    "ledger-kind-unregistered", "error",
    "a change-ledger event kind is recorded in code but missing from "
    "the LEDGER_KINDS registry in obs/ledger.py — the suspect ranker "
    "and the /api/changes consumers only know registered kinds",
    "add the kind (with a one-line description) to LEDGER_KINDS in "
    "routest_tpu_torch/obs/ledger.py")
def ledger_kind_unregistered(rule: Rule, corpus: Corpus
                             ) -> Iterator[Finding]:
    registered = _ledger_registered_kinds(corpus)
    if not registered:
        return
    for kind, file, line in _ledger_kind_sites(corpus):
        if kind not in registered:
            yield rule.finding(
                file, line,
                f"ledger kind `{kind}` is recorded here but not "
                f"registered in LEDGER_KINDS")


@register(
    "ledger-kind-undocumented", "error",
    "a change-ledger event kind recorded in code has no row in the "
    "docs/OBSERVABILITY.md change-ledger table — incident responders "
    "triage suspects by that table",
    "add the kind to the event-kind table under \"Change ledger & "
    "incident correlation\" in docs/OBSERVABILITY.md")
def ledger_kind_undocumented(rule: Rule, corpus: Corpus
                             ) -> Iterator[Finding]:
    doc = corpus.doc("OBSERVABILITY.md")
    if not doc:
        return
    seen: Set[str] = set()
    for kind, file, line in _ledger_kind_sites(corpus):
        if kind in seen:
            continue
        seen.add(kind)
        if kind not in doc:
            yield rule.finding(
                file, line,
                f"ledger kind `{kind}` is recorded here but not "
                f"documented in docs/OBSERVABILITY.md")


@register(
    "ledger-kind-stale-doc", "error",
    "the docs/OBSERVABILITY.md change-ledger table names an event kind "
    "that the LEDGER_KINDS registry doesn't know — a responder would "
    "filter /api/changes on a kind that never occurs",
    "remove the stale row, or register the kind in LEDGER_KINDS in "
    "routest_tpu_torch/obs/ledger.py")
def ledger_kind_stale_doc(rule: Rule, corpus: Corpus
                          ) -> Iterator[Finding]:
    registered = _ledger_registered_kinds(corpus)
    if not registered:
        return
    seen: Set[str] = set()
    for relpath, doc in corpus.doc_parts.get("OBSERVABILITY.md", ()):
        section, offset = _ledger_doc_section(doc)
        for i, line in enumerate(section.splitlines()):
            # Kinds live in the FIRST column of the event-kind table;
            # prose (the `rtpu.changes` channel, module paths) is exempt.
            if not line.lstrip().startswith("|"):
                continue
            first_cell = line.split("|")[1] if "|" in line else ""
            for token in re.findall(r"`([a-z][a-z_]*\.[a-z_.]*[a-z])`",
                                    first_cell):
                if token in seen or not LEDGER_KIND_RE.match(token):
                    continue
                seen.add(token)
                if token not in registered:
                    yield rule.finding(
                        relpath, offset + i + 1,
                        f"documented ledger kind `{token}` is not in "
                        f"LEDGER_KINDS")
