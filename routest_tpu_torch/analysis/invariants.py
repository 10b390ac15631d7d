"""Invariant lints: pure-AST rules over the port's package.

The five rules of ``routest_tpu/analysis/invariants.py``, unchanged;
only ``PRINT_ALLOWED`` names the port's paths.

These encode conventions the runtime stack already relies on — loud
failure (no silent broad excepts, no unlogged degradation), structured
logging (no bare prints outside the JsonLogger emitter), and lock/thread
discipline on the serving hot paths (no blocking IO while holding a
lock, no unmanaged threads). The first two migrated here from the
standalone AST sweeps ``tests/test_no_silent_excepts.py`` /
``tests/test_no_bare_print.py`` and now cover the whole package instead
of a hand-listed subdirectory set.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from routest_tpu_torch.analysis.engine import (
    Corpus, Finding, Rule, call_leaf, dotted_name, exc_type_names, register,
)

BROAD = {"Exception", "BaseException"}

# The logger's emitter is the one sanctioned print call site: it is how
# JSON lines physically reach stderr. The lint CLI is another: its
# stdout IS its interface (diagnostics a human or CI reads directly).
# So are the three training CLIs' progress reports, which the port
# carries inside its package where the JAX package keeps them as
# scripts (``scripts/train_{eta,gnn,route_transformer}.py``, outside
# its gate): their ``[1/4] …`` lines are what an operator reads.
PRINT_ALLOWED = {"routest_tpu_torch/utils/logging.py",
                 "routest_tpu_torch/analysis/__main__.py",
                 "routest_tpu_torch/train/__main__.py",
                 "routest_tpu_torch/train/gnn.py",
                 "routest_tpu_torch/train/transformer.py"}

# Handler body verbs that make a broad catch "loud": structured logging
# and metric mutation. A ``raise`` or any use of the bound exception
# variable (propagating the error into surfaced state, e.g.
# ``self._error = f"{e}"``) also qualifies — see broad-except-unlogged.
_LOGGY = {"log", "warning", "error", "exception", "info", "debug",
          "critical", "warn"}
_METRIC = {"inc", "dec", "set", "observe", "labels"}

# Known-blocking calls that must not run while a lock is held: the
# serving hot paths (gateway _pick, batcher submit/flush, fastlane,
# route cache) all contend on these locks, so one blocked holder
# convoys every request behind it.
_BLOCKING_DOTTED = {"time.sleep", "socket.create_connection"}
_BLOCKING_PREFIX = ("subprocess.", "requests.", "urllib.request.")
_BLOCKING_LEAF = {"sendall", "recv", "recvfrom", "accept", "connect",
                  "urlopen", "getresponse", "block_until_ready"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    names = exc_type_names(handler.type)
    return bool(names & BROAD) or "<bare>" in names


@register(
    "silent-except", "error",
    "an `except` catching Exception/BaseException (or bare) whose body "
    "is only `pass` — invisible degradation: the failure leaves no log "
    "line, no metric, no surfaced state",
    "log a JsonLogger event, count a metric, or narrow the caught type "
    "to the specific expected error")
def silent_except(rule: Rule, corpus: Corpus) -> Iterator[Finding]:
    for sf in corpus.files:
        for node in sf.nodes():
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node):
                continue
            if all(isinstance(s, ast.Pass) for s in node.body):
                yield rule.finding(
                    sf.relpath, node.lineno,
                    "silent broad except: body is only `pass`")


@register(
    "bare-print", "error",
    "a bare `print()` call inside the package — ad-hoc status prints "
    "bypass the structured JsonLogger (only utils/logging.py, the "
    "emitter itself, may print)",
    "use utils.logging.get_logger(...) / JsonLogger instead")
def bare_print(rule: Rule, corpus: Corpus) -> Iterator[Finding]:
    for sf in corpus.files:
        if sf.relpath in PRINT_ALLOWED:
            continue
        for node in sf.nodes():
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"):
                yield rule.finding(sf.relpath, node.lineno,
                                   "bare print() call")


@register(
    "broad-except-unlogged", "error",
    "a broad `except Exception` handler that neither logs, counts a "
    "metric, re-raises, nor uses the bound exception — the error is "
    "swallowed with no trace of what went wrong",
    "log/count the failure, propagate `e` into surfaced state, or add "
    "a `# rtpulint: disable=broad-except-unlogged -- <why>` if the "
    "swallow is the contract (e.g. a health probe mapping any failure "
    "to `unhealthy`)")
def broad_except_unlogged(rule: Rule, corpus: Corpus) -> Iterator[Finding]:
    for sf in corpus.files:
        for node in sf.nodes():
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node):
                continue
            if all(isinstance(s, ast.Pass) for s in node.body):
                continue  # that's silent-except's finding
            if _handler_is_loud(node):
                continue
            yield rule.finding(
                sf.relpath, node.lineno,
                "broad except swallows the error without logging, "
                "counting, or using the exception")


def _handler_is_loud(handler: ast.ExceptHandler) -> bool:
    for stmt in handler.body:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Raise):
                return True
            if (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in (_LOGGY | _METRIC)):
                return True
            if (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Name)
                    and sub.func.id in _LOGGY):
                return True
            if (handler.name and isinstance(sub, ast.Name)
                    and sub.id == handler.name):
                return True  # the error is captured into state
    return False


def _lockish(with_node: ast.With) -> Optional[str]:
    """The dotted name of the first with-item that looks like a lock
    (``self._lock``, ``cache_lock``, ``threading.Lock()``…), else None.

    Lexical by design: a lock released early via ``lock.release()`` in
    the body (or acquire/try/finally-release outside a ``with``) is NOT
    modeled — tests/test_analysis.py documents both as accepted
    false-negative/false-positive guards.
    """
    for item in with_node.items:
        name = dotted_name(item.context_expr).lower()
        if "lock" in name or "mutex" in name:
            return dotted_name(item.context_expr)
    return None


@register(
    "blocking-call-under-lock", "error",
    "a known-blocking call (`time.sleep`, socket/HTTP IO, subprocess, "
    "device `.block_until_ready()`) lexically inside a `with <lock>:` "
    "body — one blocked holder convoys every thread contending on that "
    "lock",
    "move the blocking work outside the critical section (snapshot "
    "state under the lock, block after releasing), or suppress with a "
    "reason if the lock IS the serialization point for this IO")
def blocking_call_under_lock(rule: Rule, corpus: Corpus) -> Iterator[Finding]:
    for sf in corpus.files:
        for node in sf.nodes():
            if not isinstance(node, ast.With):
                continue
            lock_name = _lockish(node)
            if lock_name is None:
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                dn = dotted_name(sub.func)
                leaf = call_leaf(sub)
                blocking = (
                    dn in _BLOCKING_DOTTED
                    or any(dn.startswith(p) for p in _BLOCKING_PREFIX)
                    or leaf in _BLOCKING_LEAF)
                if blocking:
                    yield rule.finding(
                        sf.relpath, sub.lineno,
                        f"blocking call `{dn or leaf}` while holding "
                        f"`{lock_name}`")


@register(
    "thread-unmanaged", "warning",
    "a `threading.Thread(...)` constructed with no `daemon=` decision "
    "and no `.join()` in the enclosing scope — at interpreter exit a "
    "forgotten non-daemon thread hangs shutdown; the codebase "
    "convention is explicit daemon=True for background loops and "
    "join() for owned workers",
    "pass `daemon=True` (background loop) or join the thread before "
    "the owning scope exits")
def thread_unmanaged(rule: Rule, corpus: Corpus) -> Iterator[Finding]:
    for sf in corpus.files:
        for node in sf.nodes():
            if not isinstance(node, ast.Call):
                continue
            leaf = call_leaf(node)
            if leaf != "Thread":
                continue
            dn = dotted_name(node.func)
            if dn not in ("Thread", "threading.Thread"):
                continue
            if any(kw.arg == "daemon" for kw in node.keywords):
                continue
            scope = _enclosing_function(sf, node)
            if scope is not None and _scope_joins(scope):
                continue
            yield rule.finding(
                sf.relpath, node.lineno,
                "Thread() without a daemon= decision or a join() in "
                "the enclosing scope")


def _enclosing_function(sf, node: ast.AST):
    for anc in sf.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def _scope_joins(scope: ast.AST) -> bool:
    for sub in ast.walk(scope):
        if (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "join"
                and not sub.args):
            # str.join always takes an argument; a bare `.join()` (or
            # `.join(timeout=...)`) is the Thread API.
            return True
        if (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "join"
                and all(isinstance(a, ast.Constant)
                        and isinstance(a.value, (int, float))
                        for a in sub.args)):
            return True  # join(5.0) — a timeout, not a separator
    return False
