"""Capture hazard lints: host work inside code that PyTorch records once
and replays, and static graph outputs read after a later replay.

The port's counterparts of ``routest_tpu/analysis/jaxrules.py``. Where
a ``@jit``-ted function runs its Python body once at trace time, three
PyTorch mechanisms do the same:

- the body of ``with torch.cuda.graph(g):`` is captured once; every
  ``g.replay()`` re-launches the recorded kernels and runs none of the
  Python;
- a callable given to ``torch.cuda.make_graphed_callables`` is captured
  the same way;
- the function (or the module's ``forward``) given to
  ``torch.export.export`` or ``torch.jit.trace`` is traced once into a
  program.

Inside such a region a host clock or host RNG call is a constant of the
recorded program (``capture-impure-host-call``), and a device→host pull
or a ``synchronize()`` either raises (a sync on a capturing stream is
illegal) or, under export, becomes a data-dependent guard
(``capture-host-sync``). A captured graph's outputs are static buffers
that each ``replay()`` overwrites, so a name bound to one of them is
stale after the next replay unless it was cloned
(``graph-static-output-reuse``) — the counterpart of a donated buffer
read after dispatch.

Regions are found lexically, per file: ``with`` statements whose
context expression resolves to ``torch.cuda.graph``, and the first
argument of a capture/trace call when it names a function defined in
the same file, a module class defined there (its ``forward``), a name
bound from such a class's constructor (through ``.to()``/``.eval()``
chains), or a factory function there that returns such a constructor.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from routest_tpu_torch.analysis.engine import (
    Corpus, Finding, Rule, call_leaf, dotted_name, register,
)

# Host calls whose value is frozen into a captured/traced program.
_IMPURE_DOTTED = {
    "time.time", "time.monotonic", "time.perf_counter",
    "time.process_time", "time.time_ns", "datetime.now",
    "datetime.utcnow", "datetime.datetime.now", "datetime.datetime.utcnow",
}
_IMPURE_PREFIX = ("np.random.", "numpy.random.", "random.")

# Device→host pulls (method form, any receiver) and host conversions.
_PULL_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_ARRAY = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}

_GRAPH_CTX = {"torch.cuda.graph"}
# A file can hold a region only if it calls one of these by its leaf
# name: the text pre-filter keeps the AST passes off every other file.
_CAPTURE_TEXT = re.compile(
    r"\b(?:graph|make_graphed_callables|export|trace)\s*\(")
_CAPTURE_CALLS = {"torch.cuda.make_graphed_callables",
                  "torch.export.export", "torch.jit.trace"}
# Method calls that keep a module value (``Forward(m).to(dev).eval()``).
_MODULE_CHAIN = {"to", "eval", "train", "cuda", "float", "half",
                 "requires_grad_"}
# Method calls that return a view of a tensor (an alias of its storage).
_VIEW_METHODS = {"view", "view_as", "detach", "reshape", "narrow",
                 "squeeze", "unsqueeze", "flatten", "t", "transpose",
                 "permute", "expand", "expand_as", "as_strided",
                 "unflatten", "select", "split", "chunk", "unbind"}


def _import_aliases(sf) -> Dict[str, str]:
    """Local name → the dotted name it was imported as (``graph`` →
    ``torch.cuda.graph`` after ``from torch.cuda import graph``), found
    once per file and kept on it."""
    cached = getattr(sf, "_import_aliases", None)
    if cached is not None:
        return cached
    out: Dict[str, str] = {}
    for node in sf.nodes():
        if isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
    sf._import_aliases = out
    return out


def _resolved(node: ast.AST, aliases: Dict[str, str]) -> str:
    """The dotted name of a call target with its head expanded by the
    file's imports."""
    dn = dotted_name(node)
    if not dn:
        return ""
    head, _, rest = dn.partition(".")
    full = aliases.get(head, head)
    return f"{full}.{rest}" if rest else full


class _FileIndex:
    """Per-file lookups the region finder needs (one pass each)."""

    def __init__(self, sf) -> None:
        self.aliases = _import_aliases(sf)
        self.functions: Dict[str, ast.AST] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        for node in sf.nodes():
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.setdefault(node.name, node)
            elif isinstance(node, ast.ClassDef):
                self.classes.setdefault(node.name, node)

    def forward_of(self, cls: ast.ClassDef) -> Optional[ast.AST]:
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt.name == "forward":
                return stmt
        return None

    def traced_by_value(self, value: ast.AST, depth: int = 0
                        ) -> Optional[ast.AST]:
        """The function a module-valued expression would run when
        traced: ``Cls(...)`` → ``Cls.forward``; ``make(...)`` → what
        ``make`` returns; ``.to()``/``.eval()`` chains are looked
        through."""
        if depth > 3:
            return None
        while (isinstance(value, ast.Call)
               and isinstance(value.func, ast.Attribute)
               and value.func.attr in _MODULE_CHAIN):
            value = value.func.value
        if not (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)):
            return None
        name = value.func.id
        if name in self.classes:
            return self.forward_of(self.classes[name])
        fn = self.functions.get(name)
        if fn is None:
            return None
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Return) and sub.value is not None:
                got = self.traced_by_value(sub.value, depth + 1)
                if got is not None:
                    return got
        return None

    def traced_target(self, arg: ast.AST, scope: ast.AST
                      ) -> Optional[ast.AST]:
        """The function a capture/trace call's first argument runs."""
        if isinstance(arg, ast.Name):
            if arg.id in self.functions:
                return self.functions[arg.id]
            if arg.id in self.classes:
                return self.forward_of(self.classes[arg.id])
            for node in _scope_nodes(scope):
                if (isinstance(node, ast.Assign)
                        and any(isinstance(t, ast.Name) and t.id == arg.id
                                for t in node.targets)):
                    got = self.traced_by_value(node.value)
                    if got is not None:
                        return got
            return None
        return self.traced_by_value(arg)


def _scope_nodes(scope: ast.AST) -> List[ast.AST]:
    """Nodes lexically in ``scope``, not descending into nested
    function definitions (each gets its own scope pass)."""
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        out.append(node)
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(ast.iter_child_nodes(node))
    return out


def _scopes(sf) -> List[ast.AST]:
    return [sf.tree] + [n for n in sf.nodes()
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))]


def _graph_with(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """The graph's dotted name when ``node`` is ``with torch.cuda.graph(g)``
    (``"<graph>"`` when it is not a plain name), else None."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return None
    for item in node.items:
        ctx = item.context_expr
        if (isinstance(ctx, ast.Call)
                and _resolved(ctx.func, aliases) in _GRAPH_CTX):
            return (dotted_name(ctx.args[0]) if ctx.args else "") \
                or "<graph>"
    return None


def _regions(sf) -> List[Tuple[str, ast.AST, Set[str]]]:
    """(label, region node, tensor-valued names) for every captured or
    traced region of the file, found once per file and kept on it. The
    names are the captured function's parameters, or the names bound
    inside a graph-capture body."""
    cached = getattr(sf, "_capture_regions", None)
    if cached is None:
        cached = _find_regions(sf) if _CAPTURE_TEXT.search(sf.text) else []
        sf._capture_regions = cached
    return cached


def _find_regions(sf) -> List[Tuple[str, ast.AST, Set[str]]]:
    idx = _FileIndex(sf)
    out: List[Tuple[str, ast.AST, Set[str]]] = []
    seen: Set[int] = set()
    for scope in _scopes(sf):
        for node in _scope_nodes(scope):
            if _graph_with(node, idx.aliases) is not None:
                if id(node) not in seen:
                    seen.add(id(node))
                    bound = {t.id for s in node.body for t in ast.walk(s)
                             if isinstance(t, ast.Name)
                             and isinstance(t.ctx, ast.Store)}
                    out.append(("torch.cuda.graph capture", node, bound))
            if not (isinstance(node, ast.Call) and node.args):
                continue
            target = _resolved(node.func, idx.aliases)
            if target not in _CAPTURE_CALLS:
                continue
            args = node.args[0]
            cands = (args.elts if isinstance(args, (ast.Tuple, ast.List))
                     else [args])
            for cand in cands:
                fn = idx.traced_target(cand, scope)
                if fn is None or id(fn) in seen:
                    continue
                seen.add(id(fn))
                label = f"`{fn.name}` (given to {target.rsplit('.', 1)[-1]})"
                out.append((label, fn, _param_names(fn) - {"self"}))
    return out


def _param_names(fn: ast.AST) -> Set[str]:
    a = fn.args
    names = [p.arg for p in
             list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


def _region_calls(region: ast.AST) -> Iterator[ast.Call]:
    for stmt in region.body:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Call):
                yield sub


@register(
    "capture-impure-host-call", "error",
    "`time.time()` / `datetime.now()` / host RNG inside code PyTorch "
    "records once and replays (a `torch.cuda.graph` capture body, a "
    "callable given to `make_graphed_callables`, the function or "
    "`forward` given to `torch.export.export` / `torch.jit.trace`) — "
    "the call runs once at capture and its value is a constant of "
    "every replay",
    "hoist the host call out of the captured region and feed its value "
    "in through a static input tensor (RNG: a torch.Generator or an "
    "input of random values)")
def capture_impure_host_call(rule: Rule, corpus: Corpus
                             ) -> Iterator[Finding]:
    for sf in corpus.files:
        for label, region, _names in _regions(sf):
            for sub in _region_calls(region):
                dn = _resolved(sub.func, _import_aliases(sf))
                if (dn in _IMPURE_DOTTED
                        or any(dn.startswith(p) for p in _IMPURE_PREFIX)):
                    yield rule.finding(
                        sf.relpath, sub.lineno,
                        f"host call `{dn}` inside {label} is evaluated "
                        f"at capture time only")


@register(
    "capture-host-sync", "error",
    "a device→host pull (`.item()`, `.tolist()`, `.cpu()`, `.numpy()`, "
    "`np.asarray`/`np.array` of a tensor) or a `synchronize()` inside a "
    "captured or traced region — a sync on a capturing stream raises, "
    "and under export it becomes a data-dependent guard",
    "keep the region on the device; pull the result after the replay "
    "(or after calling the exported program)")
def capture_host_sync(rule: Rule, corpus: Corpus) -> Iterator[Finding]:
    for sf in corpus.files:
        for label, region, names in _regions(sf):
            for sub in _region_calls(region):
                leaf = call_leaf(sub)
                dn = _resolved(sub.func, _import_aliases(sf))
                if (isinstance(sub.func, ast.Attribute)
                        and leaf in _PULL_METHODS and not sub.args):
                    yield rule.finding(
                        sf.relpath, sub.lineno,
                        f"`.{leaf}()` inside {label} pulls a tensor to "
                        f"the host")
                elif leaf == "synchronize":
                    yield rule.finding(
                        sf.relpath, sub.lineno,
                        f"`{dn or leaf}()` inside {label} syncs the "
                        f"capturing stream")
                elif (dn in _HOST_ARRAY and sub.args
                      and isinstance(sub.args[0], ast.Name)
                      and sub.args[0].id in names):
                    yield rule.finding(
                        sf.relpath, sub.lineno,
                        f"`{dn}({sub.args[0].id})` converts a tensor of "
                        f"{label} on the host")


def _aliases_static(value: ast.AST, static: Set[str]) -> bool:
    """``value`` shares storage with a static output: the name itself,
    an index of it, or a view method of it (``.clone()`` does not)."""
    while True:
        if isinstance(value, ast.Name):
            return value.id in static
        if isinstance(value, ast.Subscript):
            value = value.value
        elif (isinstance(value, ast.Call)
              and isinstance(value.func, ast.Attribute)
              and value.func.attr in _VIEW_METHODS):
            value = value.func.value
        else:
            return False


@register(
    "graph-static-output-reuse", "error",
    "a name bound to a captured CUDA graph's static output (or a view "
    "of it) is read after a later `replay()` of the same graph — the "
    "replay overwrites the buffer in place, so the name now holds the "
    "newer result, as a donated buffer is dead after dispatch",
    "`.clone()` the output before the next replay, or read the static "
    "output itself after the replay you mean")
def graph_static_output_reuse(rule: Rule, corpus: Corpus
                              ) -> Iterator[Finding]:
    for sf in corpus.files:
        if not any(label.startswith("torch.cuda.graph")
                   for label, _, _ in _regions(sf)):
            continue
        aliases = _import_aliases(sf)
        for scope in _scopes(sf):
            nodes = _scope_nodes(scope)
            # Pass 1: each captured graph's static outputs.
            static: Dict[str, Set[str]] = {}
            for node in nodes:
                graph = _graph_with(node, aliases)
                if graph is None:
                    continue
                static.setdefault(graph, set()).update(
                    t.id for s in node.body for t in ast.walk(s)
                    if isinstance(t, ast.Name)
                    and isinstance(t.ctx, ast.Store))
            if not static:
                continue
            yield from _stale_reads(rule, sf, nodes, static)


def _stale_reads(rule: Rule, sf, nodes: List[ast.AST],
                 static: Dict[str, Set[str]]) -> Iterator[Finding]:
    # Pass 2: aliases bound to a static output, and each graph's replays.
    bound: List[Tuple[str, str, int]] = []   # (alias, graph, line)
    replays: Dict[str, List[int]] = {}
    for node in nodes:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            for graph, outs in static.items():
                if (node.targets[0].id not in outs
                        and _aliases_static(node.value, outs)):
                    bound.append((node.targets[0].id, graph, node.lineno))
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "replay"):
            graph = dotted_name(node.func.value)
            if graph in static:
                replays.setdefault(graph, []).append(node.lineno)
    if not bound:
        return
    # Pass 3: a load of the alias after a replay that follows its
    # binding, with no rebinding in between.
    stores: Dict[str, List[int]] = {}
    loads: Dict[str, List[int]] = {}
    for node in nodes:
        if isinstance(node, ast.Name):
            (stores if isinstance(node.ctx, ast.Store) else loads) \
                .setdefault(node.id, []).append(node.lineno)
    for var, graph, line in bound:
        later = [r for r in replays.get(graph, []) if r > line]
        if not later:
            continue
        replay = min(later)
        rebinds = [ln for ln in stores.get(var, []) if ln > line]
        first_rebind = min(rebinds) if rebinds else None
        for ln in sorted(loads.get(var, [])):
            if ln <= replay:
                continue
            if first_rebind is not None and ln >= first_rebind:
                break
            yield rule.finding(
                sf.relpath, ln,
                f"`{var}` views a static output of graph `{graph}` "
                f"(bound on line {line}) and is read after its replay "
                f"on line {replay}")
            break  # one finding per binding is enough signal
