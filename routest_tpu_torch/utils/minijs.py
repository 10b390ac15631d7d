"""A small JavaScript (ES5 + a slice of ES2015) interpreter.

The port's own copy of ``routest_tpu/utils/minijs.py`` (the port imports
nothing of the JAX package): the same lexer, parser, evaluator and
public names (``Interpreter``, ``run_source``, ``run_file``,
``UNDEFINED``, ``JSPromise``, ``JSError``, ``JSSyntaxError``).

Why it exists: the dashboard ships ~500 lines of browser JS
(``serve/static/lib/dashboard_logic.js`` + the inline glue in
``dashboard.html``), and neither the test machines nor the card's host
carry a JS runtime (no node, no bun, no quickjs, no browser). So the
port hosts its own engine: this module lexes, parses and evaluates the
*exact served file*, and ``utils/jsdom.py`` runs the pages' glue on it
against the port's HTTP API (``tests/test_torch_dashboard.py`` on the
CPU, ``chip_smoke.py``'s pages phase on the card).

Scope — deliberately the subset the frontend logic modules are written
in (and ``tests/test_minijs.py`` pins the semantics):

- values: IEEE doubles (Python float), strings, booleans, ``null``,
  ``undefined``, arrays (list), plain objects (insertion-ordered dict),
  first-class functions/closures, regex literals;
- statements: ``const/let/var``, function declarations, ``if/else``,
  classic ``for``, ``for..of``, ``while``, ``return/break/continue``,
  expression statements, blocks;
- expressions: arrows (expression + block body), calls, member access,
  ``new``-less object/array literals (with spread), template literals
  with ``${}``, ternary, ``&&/||/??`` (value-returning), comparisons
  (strict + loose-null), arithmetic (incl. ``**``, string ``+``),
  unary (``! - + typeof``), pre/postfix ``++/--``, compound assignment,
  array/object destructuring in params and declarations;
- builtins: ``Math``, ``JSON``, ``String/Number/Boolean/Array``,
  ``Object.keys/values/entries/assign``, ``parseFloat/parseInt``,
  ``isFinite/isNaN``, ``encodeURIComponent``, number ``toFixed``,
  the common string/array methods, and regex ``test/exec`` +
  ``String.replace/match/split`` with the ``g`` flag.

Also supported, for executing the PAGE GLUE (not just the pure-logic
modules) under a host DOM (``utils/jsdom.py``):

- ``async function`` / ``async () =>``: the body runs eagerly and
  synchronously; the call returns a settled :class:`JSPromise`
  (fulfilled with the return value, rejected if the body threw);
- ``await expr``: unwraps a settled JSPromise (rethrows a rejection);
  non-promise values pass through; awaiting a PENDING promise raises —
  the host must settle promises before handing them over (there is no
  event loop, by design: CI wants deterministic, synchronous runs);
- ``new Ctor(args)``: invokes the callee like a call — host
  constructors (Date, Blob, EventSource, Option, ...) are plain
  factories injected as globals; ``new Promise(executor)`` runs the
  executor immediately with capturing resolve/reject;
- host objects: any Python object exposing ``js_get_member(name)`` /
  ``js_set_member(name, value)`` participates in member access and
  method calls — the seam jsdom's elements/fetch/localStorage use.

Not implemented (the modules don't use them): ``this``/classes/
prototypes, generators, labels, ``switch``, getters/setters,
``Symbol``, sparse arrays, a microtask queue. Unknown syntax raises
``JSSyntaxError`` at parse time, so an accidental use of an
unsupported feature fails CI loudly instead of silently skipping the
file.

JS-semantics corners handled on purpose (each pinned by a test):
- truthiness (``0 "" null undefined NaN`` falsy; ``[] {}`` truthy);
- ``x == null`` matches null AND undefined (the file's idiom);
- ``+`` concatenates when either side is a string, with JS number
  formatting (``5`` not ``5.0``, up to 17 significant digits);
- ``toFixed`` rounds ties away from zero on the decimal expansion of
  the double (``(0.5).toFixed(0) === "1"`` where Python's ``%.0f``
  gives ``"0"``);
- ``Array.prototype.map(fn)`` passes ``(element, index)``;
- ``sort()`` default comparator is lexicographic on String(x).
"""

from __future__ import annotations

import json as _json
import math
import re as _re
from decimal import ROUND_HALF_UP, Decimal
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "JSSyntaxError",
    "JSError",
    "JSUndefined",
    "UNDEFINED",
    "Interpreter",
    "run_file",
    "run_source",
]


class JSSyntaxError(SyntaxError):
    """Tokenizer/parser rejection — unsupported or malformed JS."""


class JSError(RuntimeError):
    """Runtime error inside interpreted JS (incl. thrown values)."""


class JSUndefined:
    """The single ``undefined`` value (distinct from ``null``/None)."""

    _instance: Optional["JSUndefined"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "undefined"

    def __bool__(self):
        return False


UNDEFINED = JSUndefined()


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_KEYWORDS = {
    "const", "let", "var", "function", "return", "if", "else", "for",
    "while", "break", "continue", "true", "false", "null", "undefined",
    "typeof", "of", "in", "new", "throw", "try", "catch", "finally",
    "delete", "instanceof", "do", "void",
    # reserved so accidental use fails at parse time, not as a name
    "class", "async", "await", "yield", "import", "export", "switch",
    "case", "default", "this", "super", "extends", "static", "get",
    "set",
}

# Multi-char operators, longest first so the scanner is greedy.
_PUNCT = [
    "...", "===", "!==", "**=", "<<=", ">>=", "&&=", "||=", "??=",
    "=>", "==", "!=", "<=", ">=", "&&", "||", "??", "**", "++", "--",
    "+=", "-=", "*=", "/=", "%=", "?.",
    "{", "}", "(", ")", "[", "]", ";", ",", "<", ">", "+", "-", "*",
    "/", "%", "=", "!", "?", ":", ".", "~", "&", "|", "^",
]


class _Tok:
    __slots__ = ("kind", "value", "line")

    def __init__(self, kind: str, value: Any, line: int):
        self.kind = kind      # num str tpl ident kw punct regex eof
        self.value = value
        self.line = line

    def __repr__(self):
        return f"Tok({self.kind},{self.value!r})"


def _tokenize(src: str) -> List[_Tok]:
    toks: List[_Tok] = []
    i, n, line = 0, len(src), 1
    ident_re = _re.compile(r"[A-Za-z_$][A-Za-z0-9_$]*")
    num_re = _re.compile(
        r"0[xX][0-9a-fA-F]+|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")

    def prev_allows_regex() -> bool:
        # A '/' starts a regex unless the previous token can end an
        # expression (ident, literal, ')', ']', postfix ++/--).
        for t in reversed(toks):
            if t.kind in ("num", "str", "tpl", "regex"):
                return False
            if t.kind == "ident":
                return False
            if t.kind == "kw":
                return t.value not in ("true", "false", "null",
                                       "undefined")
            if t.kind == "punct":
                return t.value not in (")", "]", "++", "--")
            return True
        return True

    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if src.startswith("//", i):
            j = src.find("\n", i)
            i = n if j < 0 else j
            continue
        if src.startswith("/*", i):
            j = src.find("*/", i + 2)
            if j < 0:
                raise JSSyntaxError(f"line {line}: unterminated comment")
            line += src.count("\n", i, j)
            i = j + 2
            continue
        if c in "'\"":
            j, buf = i + 1, []
            while j < n and src[j] != c:
                if src[j] == "\\":
                    buf.append(_unescape(src[j + 1], line))
                    j += 2
                elif src[j] == "\n":
                    raise JSSyntaxError(f"line {line}: newline in string")
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise JSSyntaxError(f"line {line}: unterminated string")
            toks.append(_Tok("str", "".join(buf), line))
            i = j + 1
            continue
        if c == "`":
            # Template literal → tok value is a list of ("str", s) and
            # ("expr", token-list) parts; the parser assembles them.
            parts: List[Tuple[str, Any]] = []
            buf: List[str] = []
            j = i + 1
            while j < n and src[j] != "`":
                if src[j] == "\\":
                    buf.append(_unescape(src[j + 1], line))
                    j += 2
                elif src.startswith("${", j):
                    parts.append(("str", "".join(buf)))
                    buf = []
                    # brace-count to the closing }, skipping braces that
                    # sit inside string/template literals of the
                    # embedded expression (e.g. `${xs.join("}")}`)
                    depth, k = 1, j + 2
                    while k < n and depth:
                        ck = src[k]
                        if ck in "'\"`":
                            k += 1
                            while k < n and src[k] != ck:
                                k += 2 if src[k] == "\\" else 1
                            k += 1
                            continue
                        if ck == "{":
                            depth += 1
                        elif ck == "}":
                            depth -= 1
                        k += 1
                    if depth:
                        raise JSSyntaxError(
                            f"line {line}: unterminated ${{}} in template")
                    parts.append(("expr", _tokenize(src[j + 2:k - 1])))
                    line += src.count("\n", j, k)
                    j = k
                else:
                    if src[j] == "\n":
                        line += 1
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise JSSyntaxError(f"line {line}: unterminated template")
            parts.append(("str", "".join(buf)))
            toks.append(_Tok("tpl", parts, line))
            i = j + 1
            continue
        if c == "/" and prev_allows_regex():
            j, in_class = i + 1, False
            while j < n:
                if src[j] == "\\":
                    j += 2
                    continue
                if src[j] == "[":
                    in_class = True
                elif src[j] == "]":
                    in_class = False
                elif src[j] == "/" and not in_class:
                    break
                elif src[j] == "\n":
                    raise JSSyntaxError(f"line {line}: newline in regex")
                j += 1
            if j >= n:
                raise JSSyntaxError(f"line {line}: unterminated regex")
            body = src[i + 1:j]
            k = j + 1
            while k < n and src[k] in "gimsuy":
                k += 1
            toks.append(_Tok("regex", (body, src[j + 1:k]), line))
            i = k
            continue
        m = num_re.match(src, i)
        if m and c.isdigit() or (c == "." and m and m.start() == i
                                 and len(m.group()) > 1):
            text = m.group()
            val = float(int(text, 16)) if text[:2].lower() == "0x" \
                else float(text)
            toks.append(_Tok("num", val, line))
            i = m.end()
            continue
        m = ident_re.match(src, i)
        if m:
            word = m.group()
            toks.append(_Tok("kw" if word in _KEYWORDS else "ident",
                             word, line))
            i = m.end()
            continue
        for p in _PUNCT:
            if src.startswith(p, i):
                toks.append(_Tok("punct", p, line))
                i += len(p)
                break
        else:
            raise JSSyntaxError(f"line {line}: unexpected character {c!r}")
    toks.append(_Tok("eof", None, line))
    return toks


def _unescape(c: str, line: int) -> str:
    table = {"n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f",
             "v": "\v", "0": "\0"}
    return table.get(c, c)


# ---------------------------------------------------------------------------
# Parser — AST nodes are plain tuples: (kind, *fields)
# ---------------------------------------------------------------------------

_ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%=", "**=", "&&=", "||=",
               "??="}

# Binary precedence (higher binds tighter). Ternary/assignment handled
# separately below this table; unary above it.
_BIN_PREC = {
    "??": 1, "||": 2, "&&": 3,
    "==": 7, "!=": 7, "===": 7, "!==": 7,
    "<": 8, ">": 8, "<=": 8, ">=": 8, "in": 8, "instanceof": 8,
    "+": 10, "-": 10,
    "*": 11, "/": 11, "%": 11,
    "**": 12,
}


class _Parser:
    def __init__(self, toks: List[_Tok]):
        self.toks = toks
        self.i = 0

    # -- token helpers ---------------------------------------------------
    def peek(self, k: int = 0) -> _Tok:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at(self, kind: str, value: Any = None) -> bool:
        t = self.peek()
        return t.kind == kind and (value is None or t.value == value)

    def eat(self, kind: str, value: Any = None) -> _Tok:
        if not self.at(kind, value):
            t = self.peek()
            raise JSSyntaxError(
                f"line {t.line}: expected {value or kind}, "
                f"got {t.value!r}")
        return self.next()

    def opt(self, kind: str, value: Any = None) -> bool:
        if self.at(kind, value):
            self.next()
            return True
        return False

    # -- program ---------------------------------------------------------
    def parse_program(self):
        body = []
        while not self.at("eof"):
            body.append(self.statement())
        return ("block", body)

    # -- statements ------------------------------------------------------
    def statement(self):
        t = self.peek()
        if t.kind == "punct" and t.value == "{":
            return self.block()
        if t.kind == "punct" and t.value == ";":
            self.next()
            return ("empty",)
        if t.kind == "kw":
            if t.value in ("const", "let", "var"):
                d = self.var_decl()
                self.opt("punct", ";")
                return d
            if t.value == "function":
                return self.function_decl()
            if t.value == "async" and self.peek(1).kind == "kw" \
                    and self.peek(1).value == "function":
                self.next()
                return self.function_decl(is_async=True)
            if t.value == "if":
                return self.if_stmt()
            if t.value == "for":
                return self.for_stmt()
            if t.value == "while":
                self.next()
                self.eat("punct", "(")
                cond = self.expression()
                self.eat("punct", ")")
                return ("while", cond, self.statement())
            if t.value == "do":
                self.next()
                body = self.statement()
                self.eat("kw", "while")
                self.eat("punct", "(")
                cond = self.expression()
                self.eat("punct", ")")
                self.opt("punct", ";")
                return ("dowhile", cond, body)
            if t.value == "return":
                self.next()
                if self.at("punct", ";") or self.at("punct", "}") \
                        or self.at("eof"):
                    self.opt("punct", ";")
                    return ("return", None)
                e = self.expression()
                self.opt("punct", ";")
                return ("return", e)
            if t.value == "break":
                self.next()
                self.opt("punct", ";")
                return ("break",)
            if t.value == "continue":
                self.next()
                self.opt("punct", ";")
                return ("continue",)
            if t.value == "throw":
                self.next()
                e = self.expression()
                self.opt("punct", ";")
                return ("throw", e)
            if t.value == "try":
                return self.try_stmt()
        e = self.expression()
        self.opt("punct", ";")
        return ("expr", e)

    def block(self):
        self.eat("punct", "{")
        body = []
        while not self.at("punct", "}"):
            body.append(self.statement())
        self.eat("punct", "}")
        return ("block", body)

    def var_decl(self):
        kind = self.next().value
        decls = []
        while True:
            target = self.binding_target()
            init = None
            if self.opt("punct", "="):
                init = self.assignment()
            decls.append((target, init))
            if not self.opt("punct", ","):
                break
        return ("decl", kind, decls)

    def binding_target(self):
        """ident | [a, b] | {a, b} destructuring pattern."""
        if self.at("punct", "["):
            self.next()
            elems = []
            while not self.at("punct", "]"):
                if self.opt("punct", ","):
                    elems.append(None)  # hole
                    continue
                elems.append(self.binding_target())
                if not self.at("punct", "]"):
                    self.eat("punct", ",")
            self.eat("punct", "]")
            return ("arr_pat", elems)
        if self.at("punct", "{"):
            self.next()
            props = []
            while not self.at("punct", "}"):
                name = self.next()
                if name.kind not in ("ident", "kw"):
                    raise JSSyntaxError(
                        f"line {name.line}: bad destructuring key")
                default = None
                if self.opt("punct", "="):
                    default = self.assignment()
                props.append((name.value, default))
                if not self.at("punct", "}"):
                    self.eat("punct", ",")
            self.eat("punct", "}")
            return ("obj_pat", props)
        t = self.next()
        if t.kind != "ident":
            raise JSSyntaxError(f"line {t.line}: bad binding {t.value!r}")
        return ("ident_pat", t.value)

    def function_decl(self, is_async: bool = False):
        self.eat("kw", "function")
        name = self.eat("ident").value
        params = self.param_list()
        body = self.block()
        return ("funcdecl", name, params, body, is_async)

    def param_list(self):
        self.eat("punct", "(")
        params = []
        while not self.at("punct", ")"):
            if self.opt("punct", "..."):
                params.append(("rest", self.eat("ident").value))
            else:
                target = self.binding_target()
                default = None
                if self.opt("punct", "="):
                    default = self.assignment()
                params.append(("param", target, default))
            if not self.at("punct", ")"):
                self.eat("punct", ",")
        self.eat("punct", ")")
        return params

    def if_stmt(self):
        self.eat("kw", "if")
        self.eat("punct", "(")
        cond = self.expression()
        self.eat("punct", ")")
        then = self.statement()
        alt = None
        if self.opt("kw", "else"):
            alt = self.statement()
        return ("if", cond, then, alt)

    def for_stmt(self):
        self.eat("kw", "for")
        self.eat("punct", "(")
        init = None
        if not self.at("punct", ";"):
            if self.peek().kind == "kw" and self.peek().value in (
                    "const", "let", "var"):
                kind = self.next().value
                target = self.binding_target()
                if self.at("kw", "of") or self.at("kw", "in"):
                    mode = self.next().value
                    it = self.expression()
                    self.eat("punct", ")")
                    return ("for" + mode, kind, target, it,
                            self.statement())
                initdecls = []
                i0 = None
                if self.opt("punct", "="):
                    i0 = self.assignment()
                initdecls.append((target, i0))
                while self.opt("punct", ","):
                    t2 = self.binding_target()
                    i2 = None
                    if self.opt("punct", "="):
                        i2 = self.assignment()
                    initdecls.append((t2, i2))
                init = ("decl", kind, initdecls)
            else:
                e = self.expression()
                if self.at("kw", "of") or self.at("kw", "in"):
                    raise JSSyntaxError(
                        f"line {self.peek().line}: for..of needs a "
                        "declaration")
                init = ("expr", e)
        self.eat("punct", ";")
        cond = None if self.at("punct", ";") else self.expression()
        self.eat("punct", ";")
        step = None if self.at("punct", ")") else self.expression()
        self.eat("punct", ")")
        return ("for", init, cond, step, self.statement())

    def try_stmt(self):
        self.eat("kw", "try")
        body = self.block()
        param, handler, finalizer = None, None, None
        if self.opt("kw", "catch"):
            if self.opt("punct", "("):
                param = self.eat("ident").value
                self.eat("punct", ")")
            handler = self.block()
        if self.opt("kw", "finally"):
            finalizer = self.block()
        return ("try", body, param, handler, finalizer)

    # -- expressions -----------------------------------------------------
    def expression(self):
        e = self.assignment()
        while self.at("punct", ","):
            self.next()
            e = ("comma", e, self.assignment())
        return e

    def assignment(self):
        if self.at("kw", "async"):
            # `async x => ...` / `async (a, b) => ...`; anything else
            # (async function, stray token) restores and falls through
            save = self.i
            self.next()
            if self.is_arrow_ahead():
                return self.arrow_function(is_async=True)
            self.i = save
        if self.is_arrow_ahead():
            return self.arrow_function()
        left = self.ternary()
        t = self.peek()
        if t.kind == "punct" and t.value in _ASSIGN_OPS:
            self.next()
            right = self.assignment()
            return ("assign", t.value, left, right)
        return left

    def is_arrow_ahead(self) -> bool:
        """Lookahead for ``x =>`` or ``(a, b) =>`` / ``([x]) =>`` etc."""
        t = self.peek()
        if t.kind == "ident" and self.peek(1).kind == "punct" \
                and self.peek(1).value == "=>":
            return True
        if t.kind == "punct" and t.value == "(":
            depth, j = 0, self.i
            while j < len(self.toks):
                tk = self.toks[j]
                if tk.kind == "punct" and tk.value == "(":
                    depth += 1
                elif tk.kind == "punct" and tk.value == ")":
                    depth -= 1
                    if depth == 0:
                        nxt = self.toks[j + 1] if j + 1 < len(self.toks) \
                            else None
                        return (nxt is not None and nxt.kind == "punct"
                                and nxt.value == "=>")
                elif tk.kind == "eof":
                    return False
                j += 1
        return False

    def arrow_function(self, is_async: bool = False):
        if self.peek().kind == "ident":
            params = [("param", ("ident_pat", self.next().value), None)]
        else:
            params = self.param_list()
        self.eat("punct", "=>")
        if self.at("punct", "{"):
            body = self.block()
            return ("func", None, params, body, is_async)
        return ("func", None, params, ("return", self.assignment()),
                is_async)

    def ternary(self):
        cond = self.binary(0)
        if self.opt("punct", "?"):
            a = self.assignment()
            self.eat("punct", ":")
            b = self.assignment()
            return ("cond", cond, a, b)
        return cond

    def binary(self, min_prec: int):
        left = self.unary()
        while True:
            t = self.peek()
            op = t.value if (t.kind == "punct" or
                             (t.kind == "kw" and t.value in
                              ("in", "instanceof"))) else None
            prec = _BIN_PREC.get(op)
            if prec is None or prec < min_prec:
                return left
            self.next()
            # ** is right-associative; the rest left.
            right = self.binary(prec if op == "**" else prec + 1)
            left = ("bin", op, left, right)

    def unary(self):
        t = self.peek()
        if t.kind == "punct" and t.value in ("!", "-", "+", "~"):
            self.next()
            return ("unary", t.value, self.unary())
        if t.kind == "kw" and t.value in ("typeof", "void", "delete"):
            self.next()
            return ("unary", t.value, self.unary())
        if t.kind == "kw" and t.value == "await":
            self.next()
            return ("await", self.unary())
        if t.kind == "punct" and t.value in ("++", "--"):
            self.next()
            return ("update", t.value, self.unary(), True)
        e = self.postfix()
        t = self.peek()
        if t.kind == "punct" and t.value in ("++", "--"):
            self.next()
            return ("update", t.value, e, False)
        return e

    def postfix(self):
        e = self.primary()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.value == ".":
                self.next()
                name = self.next()
                if name.kind not in ("ident", "kw"):
                    raise JSSyntaxError(
                        f"line {name.line}: bad property name")
                e = ("member", e, ("lit", name.value), False)
            elif t.kind == "punct" and t.value == "?.":
                self.next()
                if self.at("punct", "("):
                    e = ("call", e, self.args(), True)
                else:
                    name = self.next()
                    e = ("member", e, ("lit", name.value), True)
            elif t.kind == "punct" and t.value == "[":
                self.next()
                idx = self.expression()
                self.eat("punct", "]")
                e = ("member", e, idx, False)
            elif t.kind == "punct" and t.value == "(":
                e = ("call", e, self.args(), False)
            else:
                return e

    def args(self):
        self.eat("punct", "(")
        out = []
        while not self.at("punct", ")"):
            if self.opt("punct", "..."):
                out.append(("spread", self.assignment()))
            else:
                out.append(("arg", self.assignment()))
            if not self.at("punct", ")"):
                self.eat("punct", ",")
        self.eat("punct", ")")
        return out

    def primary(self):
        t = self.next()
        if t.kind == "num":
            return ("lit", t.value)
        if t.kind == "str":
            return ("lit", t.value)
        if t.kind == "regex":
            return ("regex", t.value[0], t.value[1])
        if t.kind == "tpl":
            parts = []
            for k, v in t.value:
                if k == "str":
                    parts.append(("lit", v))
                else:
                    parts.append(_Parser(v + [_Tok("eof", None, t.line)])
                                 .expression())
            return ("template", parts)
        if t.kind == "kw":
            if t.value == "true":
                return ("lit", True)
            if t.value == "false":
                return ("lit", False)
            if t.value == "null":
                return ("lit", None)
            if t.value == "undefined":
                return ("lit", UNDEFINED)
            if t.value == "function":
                name = None
                if self.peek().kind == "ident":
                    name = self.next().value
                params = self.param_list()
                return ("func", name, params, self.block(), False)
            if t.value == "async" and self.at("kw", "function"):
                self.next()
                name = None
                if self.peek().kind == "ident":
                    name = self.next().value
                params = self.param_list()
                return ("func", name, params, self.block(), True)
            if t.value == "new":
                # `new Ctor(args)` / `new Ctor` — host constructors are
                # plain factories, so construction == invocation
                target = self.postfix()
                if target[0] == "call":
                    return ("new", target[1], target[2])
                return ("new", target, [])
            raise JSSyntaxError(
                f"line {t.line}: unexpected keyword {t.value!r}")
        if t.kind == "ident":
            return ("name", t.value)
        if t.kind == "punct" and t.value == "(":
            e = self.expression()
            self.eat("punct", ")")
            return e
        if t.kind == "punct" and t.value == "[":
            elems = []
            while not self.at("punct", "]"):
                if self.opt("punct", "..."):
                    elems.append(("spread", self.assignment()))
                else:
                    elems.append(("arg", self.assignment()))
                if not self.at("punct", "]"):
                    self.eat("punct", ",")
            self.eat("punct", "]")
            return ("array", elems)
        if t.kind == "punct" and t.value == "{":
            props = []
            while not self.at("punct", "}"):
                if self.opt("punct", "..."):
                    props.append(("spread", self.assignment()))
                else:
                    k = self.next()
                    if k.kind in ("ident", "kw"):
                        key = ("lit", k.value)
                    elif k.kind == "str":
                        key = ("lit", k.value)
                    elif k.kind == "num":
                        key = ("lit", _js_num_to_key(k.value))
                    elif k.kind == "punct" and k.value == "[":
                        key = self.assignment()
                        self.eat("punct", "]")
                    else:
                        raise JSSyntaxError(
                            f"line {k.line}: bad object key {k.value!r}")
                    if self.opt("punct", ":"):
                        props.append(("kv", key, self.assignment()))
                    elif self.at("punct", "(") and k.kind in ("ident",
                                                              "kw"):
                        params = self.param_list()
                        body = self.block()
                        props.append(("kv", key,
                                      ("func", k.value, params, body,
                                       False)))
                    else:  # shorthand {a}
                        props.append(("kv", key, ("name", k.value)))
                if not self.at("punct", "}"):
                    self.eat("punct", ",")
            self.eat("punct", "}")
            return ("object", props)
        raise JSSyntaxError(f"line {t.line}: unexpected token {t.value!r}")


def _js_num_to_key(v: float) -> str:
    return _js_number_str(v)


# ---------------------------------------------------------------------------
# Runtime values
# ---------------------------------------------------------------------------

class JSFunction:
    __slots__ = ("name", "params", "body", "env", "interp", "is_async")

    def __init__(self, name, params, body, env, interp,
                 is_async: bool = False):
        self.name = name or "<anonymous>"
        self.params = params
        self.body = body
        self.env = env
        self.interp = interp
        self.is_async = is_async

    def __call__(self, *args):
        return self.interp.call_function(self, list(args))

    def __repr__(self):
        return f"<JSFunction {self.name}>"


class JSPromise:
    """A settled-or-pending promise value — NO event loop.

    Async functions run eagerly and return one of these already
    settled; ``new Promise(executor)`` runs the executor immediately
    and is pending until the captured resolve/reject fires (the host
    drives that, e.g. a dialog's button handler). Reactions attached
    with ``then/catch/finally`` run synchronously when settled — and a
    reaction attached while PENDING is queued and runs the moment the
    host settles the promise.

    ``handled`` supports the unhandled-rejection check: awaiting or
    attaching any reaction marks a promise handled; a rejected promise
    nobody ever observed is surfaced loudly by ``Interpreter.run``."""

    __slots__ = ("state", "value", "error", "handled", "_callbacks")

    def __init__(self):
        self.state = "pending"
        self.value = UNDEFINED
        self.error = UNDEFINED
        self.handled = False
        self._callbacks: List[Callable[["JSPromise"], None]] = []

    @classmethod
    def fulfilled(cls, value):
        p = cls()
        p.state = "fulfilled"
        p.value = value
        return p

    @classmethod
    def rejected(cls, error):
        p = cls()
        p.state = "rejected"
        p.error = error
        return p

    def resolve(self, value=UNDEFINED):
        if self.state == "pending":
            self.state = "fulfilled"
            self.value = value
            self._flush()

    def reject(self, error=UNDEFINED):
        if self.state == "pending":
            self.state = "rejected"
            self.error = error
            self._flush()

    def subscribe(self, cb: Callable[["JSPromise"], None]):
        """Run ``cb(self)`` now if settled, else when settled."""
        self.handled = True
        if self.state == "pending":
            self._callbacks.append(cb)
        else:
            cb(self)

    def _flush(self):
        cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def __repr__(self):
        return f"<JSPromise {self.state}>"


class JSRegex:
    __slots__ = ("source", "flags", "compiled")

    def __init__(self, source: str, flags: str):
        self.source = source
        self.flags = flags
        pyflags = 0
        if "i" in flags:
            pyflags |= _re.IGNORECASE
        if "m" in flags:
            pyflags |= _re.MULTILINE
        if "s" in flags:
            pyflags |= _re.DOTALL
        try:
            self.compiled = _re.compile(_js_regex_to_py(source), pyflags)
        except _re.error as e:
            raise JSSyntaxError(f"bad regex /{source}/: {e}") from e

    def __repr__(self):
        return f"/{self.source}/{self.flags}"


def _js_regex_to_py(source: str) -> str:
    """Translate the JS regex subset to Python ``re`` syntax.

    The logic modules stick to the shared subset (char classes,
    quantifiers, anchors, groups, alternation, \\d \\w \\s \\b); the
    only rewrite needed is ``\\/`` (escaped slash, meaningless to re)
    → ``/``.
    """
    return source.replace(r"\/", "/")


class _Env:
    __slots__ = ("vars", "parent")

    def __init__(self, parent: Optional["_Env"] = None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent

    def lookup(self, name: str):
        env = self
        while env is not None:
            if name in env.vars:
                return env.vars[name]
            env = env.parent
        raise JSError(f"ReferenceError: {name} is not defined")

    def set(self, name: str, value: Any):
        env = self
        while env is not None:
            if name in env.vars:
                env.vars[name] = value
                return
            env = env.parent
        raise JSError(f"ReferenceError: {name} is not defined")

    def declare(self, name: str, value: Any):
        self.vars[name] = value


# Control-flow signals
class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Thrown(JSError):
    def __init__(self, value):
        self.value = value
        super().__init__(f"uncaught JS throw: {_js_display(value)}")


# ---------------------------------------------------------------------------
# JS semantics helpers
# ---------------------------------------------------------------------------

def _truthy(v: Any) -> bool:
    if v is None or v is UNDEFINED or v is False:
        return False
    if isinstance(v, float):
        return not (v == 0.0 or math.isnan(v))
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return len(v) > 0
    return True  # arrays, objects, functions, regexes


def _js_number_str(v: float) -> str:
    """ToString(number): '5' not '5.0'; shortest round-trip digits."""
    if math.isnan(v):
        return "NaN"
    if v == math.inf:
        return "Infinity"
    if v == -math.inf:
        return "-Infinity"
    if v == int(v) and abs(v) < 1e21:
        return str(int(v))
    r = repr(v)
    if "e" in r or "E" in r:
        # JS uses e+21 style for big, e-7 for small; repr is close
        # enough for the logic modules' ranges (they format with
        # toFixed for display anyway).
        return r
    return r


def _js_str(v: Any) -> str:
    if v is UNDEFINED:
        return "undefined"
    if v is None:
        return "null"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, float):
        return _js_number_str(v)
    if isinstance(v, str):
        return v
    if isinstance(v, list):
        return ",".join("" if x is None or x is UNDEFINED else _js_str(x)
                        for x in v)
    if isinstance(v, dict):
        return "[object Object]"
    if isinstance(v, JSRegex):
        return repr(v)
    if isinstance(v, (JSFunction,)) or callable(v):
        return f"function {getattr(v, 'name', '')}() {{ ... }}"
    return str(v)


def _js_display(v: Any) -> str:
    return _js_str(v)


def _to_number(v: Any) -> float:
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, float):
        return v
    if v is None:
        return 0.0
    if v is UNDEFINED:
        return math.nan
    if isinstance(v, str):
        s = v.strip()
        if not s:
            return 0.0
        try:
            if s[:2].lower() == "0x":
                return float(int(s, 16))
            return float(s)
        except ValueError:
            return math.nan
    if isinstance(v, list):
        if not v:
            return 0.0
        if len(v) == 1:
            return _to_number(v[0])
        return math.nan
    return math.nan


def _strict_eq(a: Any, b: Any) -> bool:
    if a is UNDEFINED or b is UNDEFINED:
        return a is b
    if a is None or b is None:
        return a is b
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a == b
    if isinstance(a, float) and isinstance(b, float):
        return a == b  # NaN != NaN handled by float eq
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    return a is b  # objects/arrays/functions: identity


def _loose_eq(a: Any, b: Any) -> bool:
    nullish = (None, UNDEFINED)
    if (a in nullish if not isinstance(a, (list, dict)) else False) or \
       (b in nullish if not isinstance(b, (list, dict)) else False):
        a_n = a is None or a is UNDEFINED
        b_n = b is None or b is UNDEFINED
        return a_n and b_n
    if isinstance(a, bool):
        return _loose_eq(_to_number(a), b)
    if isinstance(b, bool):
        return _loose_eq(a, _to_number(b))
    if isinstance(a, float) and isinstance(b, str):
        return a == _to_number(b)
    if isinstance(a, str) and isinstance(b, float):
        return _to_number(a) == b
    return _strict_eq(a, b)


def _to_int(v: Any) -> int:
    n = _to_number(v)
    if math.isnan(n) or math.isinf(n):
        return 0
    return int(n)


def _js_tofixed(x: float, digits: int) -> str:
    """Number.prototype.toFixed: per spec the sign is peeled first and
    ties pick the LARGER n, so ties round away from zero on the exact
    decimal expansion of the double — (0.5).toFixed(0) === '1' and
    (-0.5).toFixed(0) === '-1', where Python's ``%.0f`` gives '0'."""
    if math.isnan(x):
        return "NaN"
    d = Decimal(abs(x)).quantize(Decimal(1).scaleb(-digits),
                                 rounding=ROUND_HALF_UP)
    s = f"{d:.{digits}f}"
    return "-" + s if x < 0 else s


def _json_stringify(v: Any, indent: Any = None) -> Any:
    def conv(x):
        if x is UNDEFINED or isinstance(x, (JSFunction, JSRegex)) \
                or callable(x):
            return _SKIP
        if isinstance(x, float):
            if math.isnan(x) or math.isinf(x):
                return None
            # integral doubles serialize as "1", not "1.0"
            return int(x) if x == int(x) and abs(x) < 2**53 else x
        if isinstance(x, list):
            return [None if (c := conv(e)) is _SKIP else c for e in x]
        if isinstance(x, dict):
            return {k: c for k, e in x.items()
                    if (c := conv(e)) is not _SKIP}
        return x

    _SKIP = object()
    c = conv(v)
    if c is _SKIP:
        return UNDEFINED
    kwargs: Dict[str, Any] = {"ensure_ascii": False,
                              "separators": (",", ":")}
    if indent is not None and indent is not UNDEFINED:
        n = _to_int(indent)
        if n > 0:
            kwargs = {"ensure_ascii": False, "indent": n,
                      "separators": (",", ": ")}
    return _json.dumps(c, **kwargs)


def _json_parse(s: str) -> Any:
    def hook(x):
        return x

    def fix(x):
        if isinstance(x, bool):
            return x
        if isinstance(x, (int, float)):
            return float(x)
        if isinstance(x, list):
            return [fix(e) for e in x]
        if isinstance(x, dict):
            return {k: fix(v) for k, v in x.items()}
        return x

    try:
        return fix(_json.loads(s))
    except Exception as e:
        raise _Thrown({"name": "SyntaxError", "message": str(e)}) from e


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------

class Interpreter:
    """Evaluate a parsed program; expose its top-level bindings.

    >>> it = Interpreter(); it.run("function f(x) { return x * 2; }")
    >>> it.call("f", 21.0)
    42.0
    """

    def __init__(self, rng: Optional[Callable[[], float]] = None):
        self.globals = _Env()
        self._promises: List[JSPromise] = []
        self._install_builtins(rng or (lambda: 0.5))

    def _track(self, p: JSPromise) -> JSPromise:
        self._promises.append(p)
        return p

    def check_unhandled_rejections(self):
        """Raise if any tracked promise was rejected and never observed
        (no await, no then/catch/finally) — an async code path failed
        silently otherwise, eroding the fail-loudly guarantee. Hosts
        driving handlers across run() boundaries should call this after
        each interaction."""
        bad = [p for p in self._promises
               if p.state == "rejected" and not p.handled]
        self._promises = [p for p in self._promises
                          if p.state == "pending"]
        if bad:
            err = bad[0].error
            if isinstance(err, dict):  # Error-shaped: show the payload
                try:
                    err = _json_stringify(err)
                except (TypeError, ValueError, RecursionError):
                    pass  # non-JSON members: fall back to [object Object]
            raise JSError(f"unhandled promise rejection: "
                          f"{_js_display(err)}")

    # -- public API ------------------------------------------------------
    def run(self, source: str):
        ast = _Parser(_tokenize(source)).parse_program()
        self.exec_block(ast, self.globals)
        self.check_unhandled_rejections()

    def call(self, name: str, *args) -> Any:
        fn = self.globals.lookup(name)
        if isinstance(fn, JSFunction):
            return self.call_function(fn, [self.to_js(a) for a in args])
        if callable(fn):
            return fn(*[self.to_js(a) for a in args])
        raise JSError(f"{name} is not a function")

    def get(self, name: str) -> Any:
        return self.globals.lookup(name)

    def set_global(self, name: str, value: Any):
        self.globals.declare(name, self.to_js(value))

    @staticmethod
    def to_js(v: Any) -> Any:
        """Python → interpreter value (ints become doubles)."""
        if isinstance(v, bool) or v is None or v is UNDEFINED:
            return v
        if isinstance(v, int):
            return float(v)
        if isinstance(v, float) or isinstance(v, str):
            return v
        if isinstance(v, (list, tuple)):
            return [Interpreter.to_js(x) for x in v]
        if isinstance(v, dict):
            return {str(k): Interpreter.to_js(x) for k, x in v.items()}
        return v

    @staticmethod
    def to_py(v: Any) -> Any:
        """Interpreter value → plain Python (undefined → None)."""
        if v is UNDEFINED:
            return None
        if isinstance(v, list):
            return [Interpreter.to_py(x) for x in v]
        if isinstance(v, dict):
            return {k: Interpreter.to_py(x) for k, x in v.items()}
        return v

    # -- builtins --------------------------------------------------------
    def _install_builtins(self, rng: Callable[[], float]):
        g = self.globals
        g.declare("NaN", math.nan)
        g.declare("Infinity", math.inf)
        g.declare("undefined", UNDEFINED)
        g.declare("Math", {
            "PI": math.pi, "E": math.e,
            "abs": lambda x: abs(_to_number(x)),
            "min": lambda *a: min((_to_number(x) for x in a),
                                  default=math.inf),
            "max": lambda *a: max((_to_number(x) for x in a),
                                  default=-math.inf),
            "floor": lambda x: float(math.floor(_to_number(x))),
            "ceil": lambda x: float(math.ceil(_to_number(x))),
            "round": lambda x: _js_math_round(_to_number(x)),
            "trunc": lambda x: float(math.trunc(_to_number(x))),
            "sqrt": lambda x: math.sqrt(_to_number(x))
            if _to_number(x) >= 0 else math.nan,
            "pow": lambda a, b: float(_to_number(a) ** _to_number(b)),
            "sin": lambda x: math.sin(_to_number(x)),
            "cos": lambda x: math.cos(_to_number(x)),
            "tan": lambda x: math.tan(_to_number(x)),
            "asin": lambda x: math.asin(_to_number(x)),
            "acos": lambda x: math.acos(_to_number(x)),
            "atan": lambda x: math.atan(_to_number(x)),
            "atan2": lambda y, x: math.atan2(_to_number(y),
                                             _to_number(x)),
            "log": lambda x: math.log(_to_number(x))
            if _to_number(x) > 0 else (-math.inf if _to_number(x) == 0
                                       else math.nan),
            "log2": lambda x: math.log2(_to_number(x))
            if _to_number(x) > 0 else math.nan,
            "hypot": lambda *a: math.hypot(*[_to_number(x) for x in a]),
            "sign": lambda x: math.copysign(1.0, _to_number(x))
            if _to_number(x) != 0 and not math.isnan(_to_number(x))
            else _to_number(x),
            "random": lambda: float(rng()),
        })
        g.declare("JSON", {
            "stringify": lambda v, replacer=None, indent=None:
                _json_stringify(v, indent),
            "parse": lambda s, *_: _json_parse(_js_str(s)),
        })
        g.declare("Object", {
            "keys": lambda o: list(o.keys())
            if isinstance(o, dict)
            else [str(i) for i in range(len(o))]
            if isinstance(o, list) else [],
            "values": lambda o: list(o.values())
            if isinstance(o, dict) else list(o)
            if isinstance(o, list) else [],
            "entries": lambda o: [[k, v] for k, v in o.items()]
            if isinstance(o, dict)
            else [[str(i), v] for i, v in enumerate(o)]
            if isinstance(o, list) else [],
            "assign": _object_assign,
            "freeze": lambda o: o,
        })
        g.declare("Array", {
            "isArray": lambda v=UNDEFINED: isinstance(v, list),
            "from": _array_from,
            "of": lambda *a: list(a),
        })
        g.declare("String", _js_string_fn)
        g.declare("Number", _js_number_fn)
        g.declare("Boolean", lambda v=UNDEFINED: _truthy(v))
        g.declare("parseFloat", _parse_float)
        g.declare("parseInt", _parse_int)
        g.declare("isFinite", lambda v=UNDEFINED: (
            not math.isnan(_to_number(v))
            and not math.isinf(_to_number(v))))
        g.declare("isNaN", lambda v=UNDEFINED: math.isnan(_to_number(v)))
        g.declare("encodeURIComponent", _encode_uri_component)
        g.declare("decodeURIComponent", _decode_uri_component)
        g.declare("console", {
            "log": lambda *a: None, "warn": lambda *a: None,
            "error": lambda *a: None,
        })

        def _promise(executor=UNDEFINED):
            # `new Promise(executor)`: run the executor NOW; resolve/
            # reject capture into the (possibly still pending) promise
            p = self._track(JSPromise())
            if executor is not UNDEFINED and executor is not None:
                self.invoke(executor,
                            [lambda v=UNDEFINED: p.resolve(v),
                             lambda e=UNDEFINED: p.reject(e)])
            return p

        g.declare("Promise", _promise)

    # -- statement execution ---------------------------------------------
    def exec_block(self, node, env: _Env):
        assert node[0] == "block"
        # hoist function declarations (the modules call helpers defined
        # later in the file)
        for stmt in node[1]:
            if stmt[0] == "funcdecl":
                env.declare(stmt[1],
                            JSFunction(stmt[1], stmt[2], stmt[3], env,
                                       self, is_async=stmt[4]))
        for stmt in node[1]:
            self.exec_stmt(stmt, env)

    def exec_stmt(self, node, env: _Env):
        kind = node[0]
        if kind == "expr":
            self.eval(node[1], env)
        elif kind == "decl":
            for target, init in node[2]:
                value = UNDEFINED if init is None else self.eval(init,
                                                                 env)
                self.bind_pattern(target, value, env, declare=True)
        elif kind == "funcdecl":
            env.declare(node[1], JSFunction(node[1], node[2], node[3],
                                            env, self,
                                            is_async=node[4]))
        elif kind == "block":
            self.exec_block(node, _Env(env))
        elif kind == "if":
            if _truthy(self.eval(node[1], env)):
                self.exec_stmt(node[2], _Env(env))
            elif node[3] is not None:
                self.exec_stmt(node[3], _Env(env))
        elif kind == "while":
            while _truthy(self.eval(node[1], env)):
                try:
                    self.exec_stmt(node[2], _Env(env))
                except _Break:
                    break
                except _Continue:
                    continue
        elif kind == "dowhile":
            while True:
                try:
                    self.exec_stmt(node[2], _Env(env))
                except _Break:
                    break
                except _Continue:
                    pass
                if not _truthy(self.eval(node[1], env)):
                    break
        elif kind == "for":
            loop_env = _Env(env)
            if node[1] is not None:
                self.exec_stmt(node[1], loop_env)
            while node[2] is None or _truthy(self.eval(node[2],
                                                       loop_env)):
                try:
                    self.exec_stmt(node[4], _Env(loop_env))
                except _Break:
                    break
                except _Continue:
                    pass
                if node[3] is not None:
                    self.eval(node[3], loop_env)
        elif kind == "forof":
            it = self.eval(node[3], env)
            if isinstance(it, str):
                seq: Any = list(it)
            elif isinstance(it, list):
                seq = list(it)
            elif isinstance(it, dict):
                raise JSError("TypeError: object is not iterable "
                              "(use Object.keys/entries)")
            else:
                raise JSError(f"TypeError: {_js_str(it)} is not "
                              "iterable")
            for item in seq:
                body_env = _Env(env)
                self.bind_pattern(node[2], item, body_env, declare=True)
                try:
                    self.exec_stmt(node[4], body_env)
                except _Break:
                    break
                except _Continue:
                    continue
        elif kind == "forin":
            it = self.eval(node[3], env)
            if isinstance(it, dict):
                keys = list(it.keys())
            elif isinstance(it, list):
                keys = [str(i) for i in range(len(it))]
            else:
                keys = []
            for key in keys:
                body_env = _Env(env)
                self.bind_pattern(node[2], key, body_env, declare=True)
                try:
                    self.exec_stmt(node[4], body_env)
                except _Break:
                    break
                except _Continue:
                    continue
        elif kind == "return":
            raise _Return(UNDEFINED if node[1] is None
                          else self.eval(node[1], env))
        elif kind == "break":
            raise _Break()
        elif kind == "continue":
            raise _Continue()
        elif kind == "throw":
            raise _Thrown(self.eval(node[1], env))
        elif kind == "try":
            _, body, param, handler, finalizer = node
            try:
                self.exec_block(body, _Env(env))
            except _Thrown as e:
                if handler is None:   # try/finally with no catch:
                    raise             # the finally below runs, then
                henv = _Env(env)      # the exception propagates (JS)
                if param:
                    henv.declare(param, e.value)
                self.exec_block(handler, henv)
            except JSError as e:
                if handler is None:
                    raise
                henv = _Env(env)
                if param:
                    henv.declare(param, {
                        "name": "Error", "message": str(e)})
                self.exec_block(handler, henv)
            finally:
                if finalizer is not None:
                    self.exec_block(finalizer, _Env(env))
        elif kind == "empty":
            pass
        else:  # pragma: no cover - parser emits only the kinds above
            raise JSError(f"unknown statement {kind}")

    def bind_pattern(self, target, value, env: _Env, declare: bool):
        kind = target[0]
        if kind == "ident_pat":
            if declare:
                env.declare(target[1], value)
            else:
                env.set(target[1], value)
        elif kind == "arr_pat":
            seq = value if isinstance(value, list) else \
                list(value) if isinstance(value, str) else None
            if seq is None:
                raise JSError("TypeError: cannot destructure "
                              f"{_js_str(value)} as an array")
            for i, sub in enumerate(target[1]):
                if sub is None:
                    continue
                item = seq[i] if i < len(seq) else UNDEFINED
                self.bind_pattern(sub, item, env, declare)
        elif kind == "obj_pat":
            if not isinstance(value, dict):
                raise JSError("TypeError: cannot destructure "
                              f"{_js_str(value)} as an object")
            for name, default in target[1]:
                item = value.get(name, UNDEFINED)
                if item is UNDEFINED and default is not None:
                    item = self.eval(default, env)
                if declare:
                    env.declare(name, item)
                else:
                    env.set(name, item)
        else:  # pragma: no cover
            raise JSError(f"unknown pattern {kind}")

    # -- function calls --------------------------------------------------
    def await_value(self, v):
        """``await``: unwrap a settled promise; rethrow rejections."""
        if isinstance(v, JSPromise):
            v.handled = True
            if v.state == "pending":
                raise JSError(
                    "await on a PENDING promise — no event loop here; "
                    "the host must settle it first (see module "
                    "docstring)")
            if v.state == "rejected":
                raise _Thrown(v.error)
            return v.value
        return v

    def call_function(self, fn: JSFunction, args: List[Any]):
        if fn.is_async:
            try:
                out = self._call_sync(fn, args)
                if isinstance(out, JSPromise):  # returned a promise:
                    return out                  # adopt, don't re-wrap
                return JSPromise.fulfilled(out)
            except _Thrown as e:
                return self._track(JSPromise.rejected(e.value))
            except JSError as e:
                return self._track(JSPromise.rejected(
                    {"name": "Error", "message": str(e)}))
        return self._call_sync(fn, args)

    def _call_sync(self, fn: JSFunction, args: List[Any]):
        env = _Env(fn.env)
        i = 0
        for p in fn.params:
            if p[0] == "rest":
                env.declare(p[1], list(args[i:]))
                i = len(args)
                continue
            _, target, default = p
            value = args[i] if i < len(args) else UNDEFINED
            if value is UNDEFINED and default is not None:
                value = self.eval(default, env)
            self.bind_pattern(target, value, env, declare=True)
            i += 1
        try:
            if fn.body[0] == "block":
                self.exec_block(fn.body, env)
            else:  # arrow expression body: ("return", expr)
                self.exec_stmt(fn.body, env)
        except _Return as r:
            return r.value
        return UNDEFINED

    # -- expression evaluation -------------------------------------------
    def eval(self, node, env: _Env):
        kind = node[0]
        if kind == "lit":
            v = node[1]
            return float(v) if isinstance(v, int) and not \
                isinstance(v, bool) else v
        if kind == "name":
            return env.lookup(node[1])
        if kind == "regex":
            return JSRegex(node[1], node[2])
        if kind == "template":
            return "".join(_js_str(self.eval(p, env)) for p in node[1])
        if kind == "array":
            out = []
            for k, e in node[1]:
                v = self.eval(e, env)
                if k == "spread":
                    if isinstance(v, list):
                        out.extend(v)
                    elif isinstance(v, str):
                        out.extend(list(v))
                    else:
                        raise JSError("TypeError: spread of "
                                      f"non-iterable {_js_str(v)}")
                else:
                    out.append(v)
            return out
        if kind == "object":
            out: Dict[str, Any] = {}
            for p in node[1]:
                if p[0] == "spread":
                    v = self.eval(p[1], env)
                    if isinstance(v, dict):
                        out.update(v)
                    elif isinstance(v, list):
                        out.update({str(i): x for i, x in enumerate(v)})
                    elif v is None or v is UNDEFINED:
                        pass
                    else:
                        raise JSError("TypeError: cannot spread "
                                      f"{_js_str(v)} into an object")
                else:
                    _, key_node, val_node = p
                    key = self.eval(key_node, env)
                    out[_js_str(key)] = self.eval(val_node, env)
            return out
        if kind == "func":
            return JSFunction(node[1], node[2], node[3], env, self,
                              is_async=node[4])
        if kind == "await":
            return self.await_value(self.eval(node[1], env))
        if kind == "new":
            args = []
            for k, e in node[2]:
                v = self.eval(e, env)
                if k == "spread":
                    args.extend(v if isinstance(v, list) else [v])
                else:
                    args.append(v)
            return self.invoke(self.eval(node[1], env), args)
        if kind == "cond":
            return self.eval(node[2] if _truthy(self.eval(node[1], env))
                             else node[3], env)
        if kind == "comma":
            self.eval(node[1], env)
            return self.eval(node[2], env)
        if kind == "bin":
            return self.eval_bin(node, env)
        if kind == "unary":
            return self.eval_unary(node, env)
        if kind == "update":
            return self.eval_update(node, env)
        if kind == "assign":
            return self.eval_assign(node, env)
        if kind == "member":
            obj = self.eval(node[1], env)
            if node[3] and (obj is None or obj is UNDEFINED):
                return UNDEFINED
            return self.get_member(obj, self.eval(node[2], env))
        if kind == "call":
            return self.eval_call(node, env)
        raise JSError(f"unknown expression {kind}")  # pragma: no cover

    def eval_bin(self, node, env: _Env):
        op = node[1]
        if op == "&&":
            left = self.eval(node[2], env)
            return self.eval(node[3], env) if _truthy(left) else left
        if op == "||":
            left = self.eval(node[2], env)
            return left if _truthy(left) else self.eval(node[3], env)
        if op == "??":
            left = self.eval(node[2], env)
            return self.eval(node[3], env) \
                if left is None or left is UNDEFINED else left
        a = self.eval(node[2], env)
        b = self.eval(node[3], env)
        return _binop(op, a, b)

    def eval_unary(self, node, env: _Env):
        op = node[1]
        if op == "typeof":
            try:
                v = self.eval(node[2], env)
            except JSError:
                return "undefined"
            return _typeof(v)
        v = self.eval(node[2], env)
        if op == "!":
            return not _truthy(v)
        if op == "-":
            return -_to_number(v)
        if op == "+":
            return _to_number(v)
        if op == "~":
            return float(~_to_int32(v))
        if op == "void":
            return UNDEFINED
        if op == "delete":
            return True
        raise JSError(f"unknown unary {op}")  # pragma: no cover

    def eval_update(self, node, env: _Env):
        _, op, target, prefix = node
        old = _to_number(self.eval(target, env))
        new = old + (1.0 if op == "++" else -1.0)
        self.write_target(target, new, env)
        return new if prefix else old

    def eval_assign(self, node, env: _Env):
        _, op, target, value_node = node
        if op == "=":
            value = self.eval(value_node, env)
        elif op in ("&&=", "||=", "??="):
            cur = self.eval(target, env)
            if op == "&&=" and not _truthy(cur):
                return cur
            if op == "||=" and _truthy(cur):
                return cur
            if op == "??=" and not (cur is None or cur is UNDEFINED):
                return cur
            value = self.eval(value_node, env)
        else:
            cur = self.eval(target, env)
            value = _binop(op[:-1], cur, self.eval(value_node, env))
        self.write_target(target, value, env)
        return value

    def write_target(self, target, value, env: _Env):
        if target[0] == "name":
            env.set(target[1], value)
        elif target[0] == "member":
            obj = self.eval(target[1], env)
            key = self.eval(target[2], env)
            if hasattr(obj, "js_set_member"):   # host objects
                obj.js_set_member(_js_str(key), value)
            elif isinstance(obj, dict):
                obj[_js_str(key)] = value
            elif isinstance(obj, list):
                idx = _to_int(key)
                if idx == len(obj):
                    obj.append(value)
                elif 0 <= idx < len(obj):
                    obj[idx] = value
                elif idx > len(obj):
                    obj.extend([UNDEFINED] * (idx - len(obj)))
                    obj.append(value)
                else:
                    raise JSError(f"bad array index {idx}")
            else:
                raise JSError("TypeError: cannot set property on "
                              f"{_js_str(obj)}")
        elif target[0] == "array":
            # [a, b] = expr — assignment destructuring
            if not isinstance(value, list):
                raise JSError("TypeError: destructuring non-array")
            for i, (k, e) in enumerate(target[1]):
                if k == "spread":
                    self.write_target(e, value[i:], env)
                    break
                self.write_target(e, value[i] if i < len(value)
                                  else UNDEFINED, env)
        else:
            raise JSError("invalid assignment target")

    def eval_call(self, node, env: _Env):
        _, callee, arg_nodes, optional = node
        args: List[Any] = []
        for k, e in arg_nodes:
            v = self.eval(e, env)
            if k == "spread":
                if isinstance(v, list):
                    args.extend(v)
                else:
                    raise JSError("TypeError: spread of non-array")
            else:
                args.append(v)
        # Method call: evaluate the object once so mutations stick.
        if callee[0] == "member":
            obj = self.eval(callee[1], env)
            if callee[3] and (obj is None or obj is UNDEFINED):
                return UNDEFINED
            key = self.eval(callee[2], env)
            method = self.get_member(obj, key)
            if method is UNDEFINED:
                raise JSError(
                    f"TypeError: {_js_str(key)} is not a function on "
                    f"{_typeof(obj)}")
            return self.invoke(method, args)
        fn = self.eval(callee, env)
        if optional and (fn is None or fn is UNDEFINED):
            return UNDEFINED
        return self.invoke(fn, args)

    def invoke(self, fn, args: List[Any]):
        if isinstance(fn, JSFunction):
            return fn.interp.call_function(fn, args)
        if callable(fn):
            out = fn(*args)
            if isinstance(out, int) and not isinstance(out, bool):
                return float(out)
            return out
        raise JSError(f"TypeError: {_js_str(fn)} is not a function")

    # -- member access ---------------------------------------------------
    def get_member(self, obj, key):
        name = _js_str(key)
        if obj is None or obj is UNDEFINED:
            raise JSError(
                f"TypeError: cannot read property {name!r} of "
                f"{_js_str(obj)}")
        if isinstance(obj, JSPromise):
            return self._promise_member(obj, name)
        if hasattr(obj, "js_get_member"):  # host objects (jsdom etc.)
            return obj.js_get_member(name)
        if isinstance(obj, dict):
            if name in obj:
                return obj[name]
            return UNDEFINED
        if isinstance(obj, list):
            if name == "length":
                return float(len(obj))
            if isinstance(key, float) or name.lstrip("-").isdigit():
                idx = _to_int(key)
                return obj[idx] if 0 <= idx < len(obj) else UNDEFINED
            return _array_method(self, obj, name)
        if isinstance(obj, str):
            if name == "length":
                return float(len(obj))
            if isinstance(key, float) or name.isdigit():
                idx = _to_int(key)
                return obj[idx] if 0 <= idx < len(obj) else UNDEFINED
            return _string_method(self, obj, name)
        if isinstance(obj, bool):
            return UNDEFINED
        if isinstance(obj, float):
            return _number_method(obj, name)
        if isinstance(obj, JSRegex):
            return _regex_method(obj, name)
        if isinstance(obj, JSFunction) or callable(obj):
            if name == "name" and isinstance(obj, JSFunction):
                return obj.name
            if name == "call":
                return lambda _this=UNDEFINED, *a: self.invoke(obj,
                                                               list(a))
            if name == "apply":
                return lambda _this=UNDEFINED, a=None: self.invoke(
                    obj, list(a or []))
            return UNDEFINED
        raise JSError(f"TypeError: cannot read {name!r} of "
                      f"{type(obj).__name__}")

    def _promise_member(self, p: JSPromise, name: str):
        """then/catch/finally: reactions run synchronously once the
        promise is settled (queued if attached while pending), with
        SYMMETRIC semantics for both branches — handler results are
        flattened through await_value and handler throws become
        downstream rejections."""

        def settle_with(handler, arg, d: JSPromise):
            try:
                out = self.invoke(handler, [arg])
            except _Thrown as e:
                d.reject(e.value)
                return
            except JSError as e:
                d.reject({"name": "Error", "message": str(e)})
                return
            if isinstance(out, JSPromise):
                # ADOPT a returned promise (even a pending one — the
                # chain resumes when the host settles it); `await` is
                # the only place pending is an error
                out.subscribe(
                    lambda pp: d.resolve(pp.value)
                    if pp.state == "fulfilled" else d.reject(pp.error))
            else:
                d.resolve(out)

        def make_then(on_ok=UNDEFINED, on_err=UNDEFINED):
            d = self._track(JSPromise())

            def react(pp: JSPromise):
                if pp.state == "fulfilled":
                    if on_ok is not None and on_ok is not UNDEFINED:
                        settle_with(on_ok, pp.value, d)
                    else:
                        d.resolve(pp.value)
                else:
                    if on_err is not None and on_err is not UNDEFINED:
                        settle_with(on_err, pp.error, d)
                    else:
                        d.reject(pp.error)

            p.subscribe(react)
            return d

        if name == "then":
            return make_then
        if name == "catch":
            return lambda on_err=UNDEFINED: make_then(UNDEFINED, on_err)
        if name == "finally":
            def finally_(fn=UNDEFINED):
                d = self._track(JSPromise())

                def react(pp: JSPromise):
                    if fn is not None and fn is not UNDEFINED:
                        try:
                            self.invoke(fn, [])
                        except _Thrown as e:
                            d.reject(e.value)
                            return
                    if pp.state == "fulfilled":
                        d.resolve(pp.value)
                    else:
                        d.reject(pp.error)

                p.subscribe(react)
                return d
            return finally_
        return UNDEFINED


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

def _binop(op: str, a, b):
    if op == "+":
        if isinstance(a, str) or isinstance(b, str) or \
                isinstance(a, (list, dict)) or isinstance(b, (list,
                                                              dict)):
            return _js_str(a) + _js_str(b)
        return _to_number(a) + _to_number(b)
    if op == "-":
        return _to_number(a) - _to_number(b)
    if op == "*":
        return _to_number(a) * _to_number(b)
    if op == "/":
        x, y = _to_number(a), _to_number(b)
        if y == 0:
            if x == 0 or math.isnan(x):
                return math.nan
            return math.copysign(math.inf, x) * math.copysign(1, y)
        return x / y
    if op == "%":
        x, y = _to_number(a), _to_number(b)
        if y == 0 or math.isnan(x) or math.isnan(y) or math.isinf(x):
            return math.nan
        return math.fmod(x, y)
    if op == "**":
        return float(_to_number(a) ** _to_number(b))
    if op == "===":
        return _strict_eq(a, b)
    if op == "!==":
        return not _strict_eq(a, b)
    if op == "==":
        return _loose_eq(a, b)
    if op == "!=":
        return not _loose_eq(a, b)
    if op in ("<", ">", "<=", ">="):
        if isinstance(a, str) and isinstance(b, str):
            pass
        else:
            a, b = _to_number(a), _to_number(b)
            if math.isnan(a) or math.isnan(b):
                return False
        return {"<": a < b, ">": a > b,
                "<=": a <= b, ">=": a >= b}[op]
    if op == "in":
        if isinstance(b, dict):
            return _js_str(a) in b
        if isinstance(b, list):
            return 0 <= _to_int(a) < len(b)
        raise JSError("TypeError: 'in' on non-object")
    if op == "instanceof":
        return False
    raise JSError(f"unknown operator {op}")  # pragma: no cover


def _typeof(v) -> str:
    if v is UNDEFINED:
        return "undefined"
    if v is None:
        return "object"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, float):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, JSFunction) or callable(v):
        return "function"
    return "object"


def _to_int32(v) -> int:
    n = _to_number(v)
    if math.isnan(n) or math.isinf(n):
        return 0
    n = int(n) & 0xFFFFFFFF
    return n - 0x100000000 if n >= 0x80000000 else n


def _js_math_round(x: float) -> float:
    """Math.round: half toward +Infinity (round(-0.5) === -0)."""
    if math.isnan(x) or math.isinf(x):
        return x
    return float(math.floor(x + 0.5))


# ---------------------------------------------------------------------------
# Methods on builtin types
# ---------------------------------------------------------------------------

def _array_method(interp: Interpreter, arr: list, name: str):
    def fn_index(v, default):
        for i, x in enumerate(arr):
            if _strict_eq(x, v):
                return float(i)
        return default

    table: Dict[str, Callable] = {
        "push": lambda *a: (arr.extend(a), float(len(arr)))[1],
        "pop": lambda: arr.pop() if arr else UNDEFINED,
        "shift": lambda: arr.pop(0) if arr else UNDEFINED,
        "unshift": lambda *a: (arr.__setitem__(slice(0, 0), list(a)),
                               float(len(arr)))[1],
        "slice": lambda start=UNDEFINED, end=UNDEFINED:
            arr[_slice_idx(start, len(arr), 0):
                _slice_idx(end, len(arr), len(arr))],
        "splice": lambda start=0.0, count=None, *items:
            _splice(arr, start, count, items),
        "concat": lambda *a: arr + [x for b in a for x in
                                    (b if isinstance(b, list) else
                                     [b])],
        "join": lambda sep=",": _js_str(sep if sep is not UNDEFINED
                                        else ",").join(
            "" if x is None or x is UNDEFINED else _js_str(x)
            for x in arr),
        "indexOf": lambda v=UNDEFINED: fn_index(v, -1.0),
        "includes": lambda v=UNDEFINED: fn_index(v, None) is not None,
        "find": lambda f: next((x for i, x in enumerate(arr)
                                if _truthy(interp.invoke(f,
                                                         [x, float(i)]))),
                               UNDEFINED),
        "findIndex": lambda f: next(
            (float(i) for i, x in enumerate(arr)
             if _truthy(interp.invoke(f, [x, float(i)]))), -1.0),
        "map": lambda f: [interp.invoke(f, [x, float(i), arr])
                          for i, x in enumerate(arr)],
        "filter": lambda f: [x for i, x in enumerate(arr)
                             if _truthy(interp.invoke(
                                 f, [x, float(i), arr]))],
        "forEach": lambda f: ([interp.invoke(f, [x, float(i), arr])
                               for i, x in enumerate(arr)],
                              UNDEFINED)[1],
        "reduce": lambda f, *init: _reduce(interp, arr, f, init),
        "some": lambda f: any(_truthy(interp.invoke(f, [x, float(i)]))
                              for i, x in enumerate(arr)),
        "every": lambda f: all(_truthy(interp.invoke(f, [x, float(i)]))
                               for i, x in enumerate(arr)),
        "reverse": lambda: (arr.reverse(), arr)[1],
        "flat": lambda depth=1.0: _flat(arr, _to_int(depth)),
        "sort": lambda cmp=None: _sort(interp, arr, cmp),
        "fill": lambda v=UNDEFINED: (arr.__setitem__(
            slice(None), [v] * len(arr)), arr)[1],
        "keys": lambda: [float(i) for i in range(len(arr))],
        "flatMap": lambda f: _flat(
            [interp.invoke(f, [x, float(i), arr])
             for i, x in enumerate(arr)], 1),
    }
    if name in table:
        return table[name]
    return UNDEFINED


def _splice(arr, start, count, items):
    n = len(arr)
    s = _to_int(start)
    s = max(n + s, 0) if s < 0 else min(s, n)
    c = n - s if count is None or count is UNDEFINED \
        else max(0, _to_int(count))
    removed = arr[s:s + c]
    arr[s:s + c] = list(items)
    return removed


def _reduce(interp, arr, f, init):
    items = list(arr)
    if init:
        acc = init[0]
        start = 0
    else:
        if not items:
            raise _Thrown({"name": "TypeError",
                           "message": "Reduce of empty array with no "
                                      "initial value"})
        acc = items[0]
        start = 1
    for i in range(start, len(items)):
        acc = interp.invoke(f, [acc, items[i], float(i), arr])
    return acc


def _flat(arr, depth: int):
    out = []
    for x in arr:
        if isinstance(x, list) and depth > 0:
            out.extend(_flat(x, depth - 1))
        else:
            out.append(x)
    return out


def _sort(interp, arr, cmp):
    import functools

    if cmp is None or cmp is UNDEFINED:
        arr.sort(key=_js_str)
    else:
        def compare(a, b):
            r = _to_number(interp.invoke(cmp, [a, b]))  # once per pair
            return -1 if r < 0 else (1 if r > 0 else 0)

        arr.sort(key=functools.cmp_to_key(compare))
    return arr


def _slice_idx(v, n: int, default: int) -> int:
    if v is UNDEFINED or v is None:
        return default
    i = _to_int(v)
    if i < 0:
        return max(n + i, 0)
    return min(i, n)


def _string_method(interp: Interpreter, s: str, name: str):
    table: Dict[str, Callable] = {
        "split": lambda sep=UNDEFINED, limit=UNDEFINED:
            _str_split(s, sep, limit),
        "slice": lambda a=UNDEFINED, b=UNDEFINED:
            s[_slice_idx(a, len(s), 0):_slice_idx(b, len(s), len(s))],
        "substring": lambda a=0.0, b=UNDEFINED: _substring(s, a, b),
        "indexOf": lambda sub="": float(s.find(_js_str(sub))),
        "lastIndexOf": lambda sub="": float(s.rfind(_js_str(sub))),
        "includes": lambda sub="": _js_str(sub) in s,
        "startsWith": lambda sub="": s.startswith(_js_str(sub)),
        "endsWith": lambda sub="": s.endswith(_js_str(sub)),
        "toLowerCase": lambda: s.lower(),
        "toUpperCase": lambda: s.upper(),
        "trim": lambda: s.strip(),
        "trimStart": lambda: s.lstrip(),
        "trimEnd": lambda: s.rstrip(),
        "charAt": lambda i=0.0: s[_to_int(i)]
        if 0 <= _to_int(i) < len(s) else "",
        "charCodeAt": lambda i=0.0: float(ord(s[_to_int(i)]))
        if 0 <= _to_int(i) < len(s) else math.nan,
        "padStart": lambda n, fill=" ": _pad(s, n, fill, True),
        "padEnd": lambda n, fill=" ": _pad(s, n, fill, False),
        "repeat": lambda n=0.0: s * _to_int(n),
        "concat": lambda *a: s + "".join(_js_str(x) for x in a),
        "replace": lambda pat, rep: _str_replace(interp, s, pat, rep,
                                                 first_only=True),
        "replaceAll": lambda pat, rep: _str_replace(interp, s, pat, rep,
                                                    first_only=False),
        "match": lambda pat: _str_match(s, pat),
        "search": lambda pat: _str_search(s, pat),
        "toString": lambda: s,
        "localeCompare": lambda o="": float((s > _js_str(o)) -
                                            (s < _js_str(o))),
    }
    if name in table:
        return table[name]
    return UNDEFINED


def _substring(s: str, a, b):
    n = len(s)
    ia = min(max(_to_int(a), 0), n)
    ib = n if b is UNDEFINED else min(max(_to_int(b), 0), n)
    if ia > ib:
        ia, ib = ib, ia
    return s[ia:ib]


def _pad(s: str, n, fill, start: bool) -> str:
    target = _to_int(n)
    fill = _js_str(fill) or " "
    if len(s) >= target:
        return s
    pad = (fill * target)[: target - len(s)]
    return pad + s if start else s + pad


def _str_split(s: str, sep, limit):
    if sep is UNDEFINED:
        out = [s]
    elif isinstance(sep, JSRegex):
        out = sep.compiled.split(s)
    else:
        sep = _js_str(sep)
        out = list(s) if sep == "" else s.split(sep)
    if limit is not UNDEFINED:
        out = out[:_to_int(limit)]
    return out


def _replacement(template: str, m: "_re.Match") -> str:
    out, i = [], 0
    while i < len(template):
        c = template[i]
        if c == "$" and i + 1 < len(template):
            nxt = template[i + 1]
            if nxt == "$":
                out.append("$")
                i += 2
                continue
            if nxt == "&":
                out.append(m.group(0))
                i += 2
                continue
            if nxt.isdigit():
                j = i + 1
                while j < len(template) and template[j].isdigit():
                    j += 1
                idx = int(template[i + 1:j])
                try:
                    out.append(m.group(idx) or "")
                except (IndexError, _re.error):
                    out.append(template[i:j])
                i = j
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _str_replace(interp, s: str, pat, rep, first_only: bool) -> str:
    def do_one(m):
        if isinstance(rep, JSFunction) or callable(rep):
            groups = [m.group(0)] + [g if g is not None else UNDEFINED
                                     for g in m.groups()]
            return _js_str(interp.invoke(rep, [*groups,
                                               float(m.start()), s]))
        return _replacement(_js_str(rep), m)

    if isinstance(pat, JSRegex):
        count = 0 if "g" in pat.flags else 1
        return pat.compiled.sub(do_one, s, count=count)
    target = _js_str(pat)
    idx = s.find(target)
    if idx < 0:
        return s

    def one(at: int) -> str:
        if isinstance(rep, JSFunction) or callable(rep):
            # per-occurrence callback with ITS offset, as in JS
            return _js_str(interp.invoke(rep, [target, float(at), s]))
        return _js_str(rep).replace("$&", target)

    if first_only:
        return s[:idx] + one(idx) + s[idx + len(target):]
    if target == "":
        return s  # JS inserts between chars; not needed by the modules
    out, pos = [], 0
    while True:
        idx = s.find(target, pos)
        if idx < 0:
            out.append(s[pos:])
            return "".join(out)
        out.append(s[pos:idx])
        out.append(one(idx))
        pos = idx + len(target)


def _str_match(s: str, pat):
    if not isinstance(pat, JSRegex):
        pat = JSRegex(_re.escape(_js_str(pat)), "")
    if "g" in pat.flags:
        out = [m.group(0) for m in pat.compiled.finditer(s)]
        return out if out else None
    m = pat.compiled.search(s)
    if not m:
        return None
    return [m.group(0)] + [g if g is not None else UNDEFINED
                           for g in m.groups()]


def _str_search(s: str, pat):
    if not isinstance(pat, JSRegex):
        pat = JSRegex(_re.escape(_js_str(pat)), "")
    m = pat.compiled.search(s)
    return float(m.start()) if m else -1.0


def _number_method(x: float, name: str):
    table: Dict[str, Callable] = {
        "toFixed": lambda digits=0.0: _js_tofixed(x, _to_int(digits)),
        "toString": lambda base=10.0: _num_to_string(x, _to_int(base)),
        # en-US default: thousands separators, ≤3 fraction digits,
        # ties away from zero via _js_tofixed (the pinned semantics)
        "toLocaleString": lambda *a: _num_to_locale(x),
        "toPrecision": lambda p=UNDEFINED: _js_number_str(x)
        if p is UNDEFINED else f"{x:.{_to_int(p)}g}",
        "valueOf": lambda: x,
    }
    if name in table:
        return table[name]
    return UNDEFINED


def _num_to_locale(x: float) -> str:
    """Number.prototype.toLocaleString, en-US defaults: grouping +
    up to 3 fraction digits, ties away from zero (Intl halfExpand —
    same rule _js_tofixed pins for toFixed)."""
    if not math.isfinite(x):
        return _js_number_str(x)
    if x == int(x):
        return f"{int(x):,}"
    fixed = _js_tofixed(x, 3)           # sign + tie handling pinned
    sign = "-" if fixed.startswith("-") else ""
    whole, frac = fixed.lstrip("-").split(".")
    frac = frac.rstrip("0")
    grouped = f"{int(whole):,}"
    return sign + grouped + ("." + frac if frac else "")


def _num_to_string(x: float, base: int) -> str:
    if base == 10:
        return _js_number_str(x)
    if x != int(x):
        raise _Thrown({"name": "RangeError",
                       "message": "non-integer toString(base)"})
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"
    n = int(abs(x))
    out = ""
    while True:
        out = digits[n % base] + out
        n //= base
        if n == 0:
            break
    return ("-" if x < 0 else "") + out


def _regex_method(rx: JSRegex, name: str):
    if name == "test":
        return lambda s=UNDEFINED: rx.compiled.search(_js_str(s)) \
            is not None
    if name == "source":
        return rx.source
    if name == "flags":
        return rx.flags
    if name == "exec":
        def exec_(s=UNDEFINED):
            m = rx.compiled.search(_js_str(s))
            if not m:
                return None
            return [m.group(0)] + [g if g is not None else UNDEFINED
                                   for g in m.groups()]
        return exec_
    return UNDEFINED


def _object_assign(target=None, *sources):
    if not isinstance(target, dict):
        raise JSError("TypeError: Object.assign target must be an "
                      "object")
    for s in sources:
        if isinstance(s, dict):
            target.update(s)
    return target


def _array_from(v=UNDEFINED, fn=None):
    if isinstance(v, list):
        out = list(v)
    elif isinstance(v, str):
        out = list(v)
    elif isinstance(v, dict) and "length" in v:
        out = [v.get(str(i), UNDEFINED)
               for i in range(_to_int(v["length"]))]
    else:
        out = []
    if fn is not None and fn is not UNDEFINED:
        raise JSError("Array.from map fn unsupported; map after")
    return out


def _js_string_fn(v=UNDEFINED):
    return _js_str(v) if v is not UNDEFINED else ""


def _js_number_fn(v=UNDEFINED):
    return _to_number(v) if v is not UNDEFINED else 0.0


def _parse_float(v=UNDEFINED):
    s = _js_str(v).strip()
    m = _re.match(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", s)
    return float(m.group()) if m else math.nan


def _parse_int(v=UNDEFINED, base=UNDEFINED):
    s = _js_str(v).strip()
    b = 10 if base is UNDEFINED else (_to_int(base) or 10)
    if b < 2 or b > 36:
        return math.nan
    if b == 16 or (b == 10 and s[:2].lower() == "0x"):
        m = _re.match(r"[+-]?(0[xX])?[0-9a-fA-F]+", s)
        if not m:
            return math.nan
        return float(int(m.group(), 16))
    # JS: parse the longest prefix of digits VALID FOR THE BASE
    # (parseInt('19', 8) === 1), never raise
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"[:b]
    i = 0
    sign = 1
    if i < len(s) and s[i] in "+-":
        sign = -1 if s[i] == "-" else 1
        i += 1
    j = i
    while j < len(s) and s[j].lower() in digits:
        j += 1
    if j == i:
        return math.nan
    return float(sign * int(s[i:j], b))


_URI_SAFE = ("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
             "0123456789-_.!~*'()")


def _encode_uri_component(v=UNDEFINED) -> str:
    out = []
    for ch in _js_str(v):
        if ch in _URI_SAFE:
            out.append(ch)
        else:
            out.extend(f"%{b:02X}" for b in ch.encode("utf-8"))
    return "".join(out)


def _decode_uri_component(v=UNDEFINED) -> str:
    from urllib.parse import unquote

    return unquote(_js_str(v))


# ---------------------------------------------------------------------------
# Convenience entry points
# ---------------------------------------------------------------------------

def run_source(source: str,
               rng: Optional[Callable[[], float]] = None) -> Interpreter:
    it = Interpreter(rng=rng)
    it.run(source)
    return it


def run_file(path: str,
             rng: Optional[Callable[[], float]] = None) -> Interpreter:
    with open(path, "r", encoding="utf-8") as f:
        return run_source(f.read(), rng=rng)
