"""rtpulint engine for the port: one parse per file, rules visit
shared trees.

The port's copy of ``routest_tpu/analysis/engine.py``, with the same
suppression grammar, baseline format and :class:`AnalysisResult`. Two
things differ: the corpus is ``routest_tpu_torch/`` (the JAX engine
walks ``routest_tpu/``), and each doc is the shared ``docs/<name>.md``
joined with the port's ``docs/torch/<name>.md``, so a knob, metric,
route, chaos point or ledger kind documented in either counts. The JAX
corpus lists only the top-level ``docs/*.md``: ``docs/torch/`` is
invisible to the JAX gate.

The runtime stack enforces its conventions with chaos injection, SLO
gates, and verified swaps — this package enforces them *at rest*. The
engine is deliberately small: a corpus loader that parses every package
file exactly once (plus the docs/registries the drift rules
cross-reference), a rule registry, suppression comments, and a
checked-in baseline so the gate is zero-new-findings from day one.

Vocabulary:

- **Rule** — one named invariant (``silent-except``,
  ``env-knob-undeclared``, …). Each rule walks the shared corpus and
  yields :class:`Finding`\\ s with a file:line anchor, a severity, and a
  one-line fix hint.
- **Suppression** — ``# rtpulint: disable=<rule>[,<rule>…] -- <reason>``
  on the offending line (or a standalone comment on the line directly
  above). The reason is REQUIRED: a suppression without one does not
  suppress and is itself reported (``bad-suppression``).
- **Baseline** — ``analysis/baseline.json``: grandfathered findings
  keyed by (rule, file, line), each entry carrying a mandatory
  ``reason``. Baselined findings don't fail the gate; stale entries
  (matching nothing) are reported so the file shrinks over time.

See docs/ANALYSIS.md for the rule catalog and the adding-a-rule recipe
(the port's three capture rules replace the JAX hazards there:
``analysis/torchrules.py``).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

SUPPRESS_RE = re.compile(
    r"#\s*rtpulint:\s*disable=([A-Za-z0-9_,\-]+)"
    r"(?:\s*--\s*(\S.*))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: ``file:line: [rule] severity: message``."""

    rule: str
    file: str          # repo-relative posix path
    line: int
    message: str
    hint: str = ""
    severity: str = "error"

    def format(self) -> str:
        tail = f"  (fix: {self.hint})" if self.hint else ""
        return (f"{self.file}:{self.line}: [{self.rule}] "
                f"{self.severity}: {self.message}{tail}")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Suppression:
    rules: Tuple[str, ...]   # rule ids, or ("all",)
    reason: str              # empty ⇒ invalid (bad-suppression)
    line: int                # the comment's own line

    def covers(self, rule: str) -> bool:
        return bool(self.reason) and ("all" in self.rules
                                      or rule in self.rules)


class SourceFile:
    """One parsed package file, shared by every rule.

    ``tree`` is parsed once; ``nodes()`` memoizes the full walk so N
    rules cost one traversal, not N. ``parent_of`` gives lexical
    parents (filled during the single walk) for rules that need the
    enclosing function/with statement.
    """

    def __init__(self, path: str, relpath: str, text: str) -> None:
        self.path = path
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self._all_nodes: Optional[List[ast.AST]] = None
        self._parents: Dict[int, ast.AST] = {}
        # line -> active suppressions (comment's own line, plus the
        # next line for standalone comments).
        self.suppressions: Dict[int, List[Suppression]] = {}
        self.bad_suppressions: List[int] = []
        self._scan_suppressions()

    def _scan_suppressions(self) -> None:
        for i, raw in enumerate(self.lines, start=1):
            m = SUPPRESS_RE.search(raw)
            if not m:
                continue
            rules = tuple(r.strip() for r in m.group(1).split(",")
                          if r.strip())
            reason = (m.group(2) or "").strip()
            if not reason or not rules:
                self.bad_suppressions.append(i)
                continue
            sup = Suppression(rules=rules, reason=reason, line=i)
            self.suppressions.setdefault(i, []).append(sup)
            if raw.lstrip().startswith("#"):
                # Standalone comment: covers the line it precedes.
                self.suppressions.setdefault(i + 1, []).append(sup)

    def suppressed(self, rule: str, line: int) -> bool:
        return any(s.covers(rule) for s in self.suppressions.get(line, ()))

    def nodes(self) -> List[ast.AST]:
        """Every AST node, single cached walk; fills parent links."""
        if self._all_nodes is None:
            out: List[ast.AST] = []
            stack: List[ast.AST] = [self.tree]
            while stack:
                node = stack.pop()
                out.append(node)
                for child in ast.iter_child_nodes(node):
                    self._parents[id(child)] = node
                    stack.append(child)
            self._all_nodes = out
        return self._all_nodes

    def parent_of(self, node: ast.AST) -> Optional[ast.AST]:
        self.nodes()
        return self._parents.get(id(node))

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parent_of(node)
        while cur is not None:
            yield cur
            cur = self.parent_of(cur)


class Corpus:
    """Everything the rules look at: the parsed package plus the
    registries the drift detectors cross-reference (``core/config.py``
    source, ``docs/*.md`` text).

    ``doc_parts`` keeps each doc's files apart (``"API.md"`` ->
    ``[("docs/API.md", text), ("docs/torch/API.md", text)]``, either
    may be missing); ``docs`` joins them, which is what a rule that
    asks "is it documented anywhere" reads."""

    def __init__(self, root: str, files: List[SourceFile],
                 doc_parts: Dict[str, List[Tuple[str, str]]]) -> None:
        self.root = root
        self.files = files
        self.doc_parts = doc_parts
        self.docs = {name: "\n".join(text for _, text in parts)
                     for name, parts in doc_parts.items()}
        self._by_rel = {f.relpath: f for f in files}

    def file(self, relpath: str) -> Optional[SourceFile]:
        return self._by_rel.get(relpath)

    def doc(self, name: str) -> str:
        return self.docs.get(name, "")

    def doc_anchor(self, name: str, token: str) -> Tuple[str, int]:
        """(doc file, first line of ``token`` in it) — the shared doc
        first, then the port's; (shared doc, 1) when absent. Anchors
        findings inside doc files."""
        for relpath, text in self.doc_parts.get(name, ()):
            for i, line in enumerate(text.splitlines(), start=1):
                if token in line:
                    return relpath, i
        return f"docs/{name}", 1


# The package the gate walks, and the prefix of every corpus path.
PACKAGE = "routest_tpu_torch"


def repo_root() -> str:
    """The directory holding ``routest_tpu_torch/`` (and, in a checkout,
    ``docs/``)."""
    import routest_tpu_torch

    pkg = os.path.dirname(os.path.abspath(routest_tpu_torch.__file__))
    return os.path.dirname(pkg)


def _read_docs(root: str) -> Dict[str, List[Tuple[str, str]]]:
    """``docs/*.md`` and ``docs/torch/*.md`` by file name."""
    parts: Dict[str, List[Tuple[str, str]]] = {}
    for sub in ("docs", "docs/torch"):
        docs_dir = os.path.join(root, *sub.split("/"))
        if not os.path.isdir(docs_dir):
            continue
        for name in sorted(os.listdir(docs_dir)):
            path = os.path.join(docs_dir, name)
            if name.endswith(".md") and os.path.isfile(path):
                with open(path, "r", encoding="utf-8") as f:
                    parts.setdefault(name, []).append(
                        (f"{sub}/{name}", f.read()))
    return parts


def load_corpus(root: Optional[str] = None) -> Corpus:
    root = os.path.abspath(root or repo_root())
    pkg_root = os.path.join(root, PACKAGE)
    files: List[SourceFile] = []
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, "r", encoding="utf-8") as f:
                files.append(SourceFile(path, rel, f.read()))
    return Corpus(root, files, _read_docs(root))


@dataclasses.dataclass(frozen=True)
class Rule:
    """One registered invariant. ``check`` yields raw findings; the
    engine applies suppressions and the baseline afterwards."""

    id: str
    severity: str
    description: str
    hint: str
    check: "RuleFn"

    def finding(self, file: str, line: int, message: str,
                hint: Optional[str] = None) -> Finding:
        return Finding(rule=self.id, file=file, line=line, message=message,
                       hint=self.hint if hint is None else hint,
                       severity=self.severity)


RuleFn = "Callable[[Rule, Corpus], Iterator[Finding]]"

_REGISTRY: "Dict[str, Rule]" = {}


def register(rule_id: str, severity: str, description: str, hint: str):
    """Decorator: register ``fn(rule, corpus) -> Iterator[Finding]``."""

    def wrap(fn):
        if rule_id in _REGISTRY:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        _REGISTRY[rule_id] = Rule(id=rule_id, severity=severity,
                                  description=description, hint=hint,
                                  check=fn)
        return fn

    return wrap


def all_rules() -> Dict[str, Rule]:
    # Importing the rule modules populates the registry exactly once.
    from routest_tpu_torch.analysis import (  # noqa: F401
        drift, invariants, torchrules)

    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# Baseline

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    rule: str
    file: str
    line: int
    reason: str

    def key(self) -> Tuple[str, str, int]:
        return (self.rule, self.file, self.line)


def load_baseline(path: Optional[str] = None
                  ) -> Tuple[List[BaselineEntry], List[str]]:
    """→ (entries, errors). Errors are structural problems — a missing
    reason, a malformed entry — that must fail the gate: an undocumented
    grandfather defeats the point of grandfathering."""
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return [], []
    try:
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
    except (OSError, ValueError) as e:
        return [], [f"baseline unreadable: {e}"]
    entries: List[BaselineEntry] = []
    errors: List[str] = []
    for i, item in enumerate(raw if isinstance(raw, list) else []):
        if not isinstance(item, dict):
            errors.append(f"baseline[{i}]: not an object")
            continue
        rule = item.get("rule")
        file = item.get("file")
        line = item.get("line")
        reason = (item.get("reason") or "").strip()
        if not (isinstance(rule, str) and isinstance(file, str)
                and isinstance(line, int)):
            errors.append(f"baseline[{i}]: needs rule/file/line")
            continue
        if not reason:
            errors.append(
                f"baseline[{i}] ({rule} {file}:{line}): reason required")
            continue
        entries.append(BaselineEntry(rule=rule, file=file, line=line,
                                     reason=reason))
    if not isinstance(raw, list):
        errors.append("baseline must be a JSON list")
    return entries, errors


# ---------------------------------------------------------------------------
# Analysis run

@dataclasses.dataclass
class AnalysisResult:
    findings: List[Finding]          # actionable: unsuppressed+unbaselined
    suppressed: List[Finding]
    baselined: List[Finding]
    stale_baseline: List[BaselineEntry]
    baseline_errors: List[str]
    files_scanned: int
    rules_run: Tuple[str, ...]

    @property
    def gate_ok(self) -> bool:
        return not self.findings and not self.baseline_errors

    def as_dict(self) -> dict:
        return {
            "gate_ok": self.gate_ok,
            "files_scanned": self.files_scanned,
            "rules_run": list(self.rules_run),
            "findings": [f.as_dict() for f in self.findings],
            "suppressed": [f.as_dict() for f in self.suppressed],
            "baselined": [f.as_dict() for f in self.baselined],
            "stale_baseline": [dataclasses.asdict(e)
                               for e in self.stale_baseline],
            "baseline_errors": list(self.baseline_errors),
        }


def analyze(corpus: Optional[Corpus] = None,
            rules: Optional[Sequence[str]] = None,
            baseline_path: Optional[str] = None,
            use_baseline: bool = True) -> AnalysisResult:
    """Run rules over the corpus, apply suppressions + baseline."""
    corpus = corpus or load_corpus()
    registry = all_rules()
    if rules:
        unknown = sorted(set(rules) - set(registry))
        if unknown:
            raise KeyError(f"unknown rule(s): {', '.join(unknown)} "
                           f"(have: {', '.join(sorted(registry))})")
        selected = [registry[r] for r in rules]
    else:
        selected = [registry[r] for r in sorted(registry)]

    raw: List[Finding] = []
    for rule in selected:
        raw.extend(rule.check(rule, corpus))

    # Suppression comments missing a reason are findings themselves
    # (the required-reason contract), regardless of rule selection.
    bad_sup = registry.get("bad-suppression")
    if bad_sup is not None:
        for sf in corpus.files:
            for line in sf.bad_suppressions:
                raw.append(bad_sup.finding(
                    sf.relpath, line,
                    "rtpulint suppression without a reason "
                    "(or without rule ids) — it is being IGNORED"))

    entries, baseline_errors = ([], []) if not use_baseline else \
        load_baseline(baseline_path)
    by_key = {e.key(): e for e in entries}
    matched: Set[Tuple[str, str, int]] = set()

    findings: List[Finding] = []
    suppressed: List[Finding] = []
    baselined: List[Finding] = []
    for f in sorted(raw, key=lambda f: (f.file, f.line, f.rule)):
        sf = corpus.file(f.file)
        if sf is not None and sf.suppressed(f.rule, f.line):
            suppressed.append(f)
            continue
        key = (f.rule, f.file, f.line)
        if key in by_key:
            matched.add(key)
            baselined.append(f)
            continue
        findings.append(f)
    stale = [e for e in entries if e.key() not in matched]
    return AnalysisResult(
        findings=findings, suppressed=suppressed, baselined=baselined,
        stale_baseline=stale, baseline_errors=baseline_errors,
        files_scanned=len(corpus.files),
        rules_run=tuple(r.id for r in selected))


# ---------------------------------------------------------------------------
# Shared AST helpers (used by rule modules)

def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains; "" when not a plain chain."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Call):
        return dotted_name(node.func)
    return ""


def call_leaf(node: ast.Call) -> str:
    """The rightmost name of the call target (``sendall`` for
    ``self._conn.sendall``)."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def exc_type_names(node: Optional[ast.AST]) -> Set[str]:
    """Exception-type expr → dotted-name leaves; bare ⇒ {"<bare>"}."""
    if node is None:
        return {"<bare>"}
    if isinstance(node, ast.Tuple):
        out: Set[str] = set()
        for elt in node.elts:
            out |= exc_type_names(elt)
        return out
    if isinstance(node, ast.Name):
        return {node.id}
    if isinstance(node, ast.Attribute):
        return {node.attr}
    return {"<expr>"}


# The bad-suppression pseudo-rule lives here so the engine can always
# emit it (it has no check of its own — the scanner feeds it).
register(
    "bad-suppression", "error",
    "a `# rtpulint: disable=` comment must name rule ids and carry a "
    "`-- <reason>`; without one it is ignored, which silently re-arms "
    "the lint it meant to waive",
    "write `# rtpulint: disable=<rule> -- <why this is safe here>`",
)(lambda rule, corpus: iter(()))
