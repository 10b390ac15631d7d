"""The port's JS interpreter (``routest_tpu_torch/utils/minijs.py``)
against the JAX package's (``routest_tpu/utils/minijs.py``).

- Every case of ``tests/test_minijs.py`` runs once per interpreter (one
  parametrised test): the same programs, held to the same pinned values
  and the same raised error types.
- A differential corpus: each program below goes through both
  interpreters and yields the same value (``to_py``) or the same error
  (class name, message and, for a JS ``throw``, the thrown value).
- The port's module imports neither JAX nor the JAX package.
"""

import os
import subprocess
import sys

import pytest

import routest_tpu.utils.minijs as jmini
import routest_tpu_torch.utils.minijs as tmini
from tests.torch_twin import case_names, load_jax_cases, port_namespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = load_jax_cases(os.path.join(REPO, "tests", "test_minijs.py"))
PORT = port_namespace(CASES)


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("case", case_names(CASES))
def test_minijs_case(case, package):
    fn = getattr(CASES, case) if package == "jax" else PORT[case]
    fn()


def test_the_cases_are_the_jax_files_and_run_on_the_port():
    assert len(case_names(CASES)) == 43
    assert PORT["Interpreter"] is tmini.Interpreter
    assert PORT["UNDEFINED"] is tmini.UNDEFINED
    assert PORT["ev"]("1 + 1") == 2.0
    assert PORT["ev"].__globals__["Interpreter"] is tmini.Interpreter


PROGRAMS = [
    "const __out = [1, 2, 3].map((x, i) => x * i + 0.5);",
    "const __out = ({a: 1, ...{b: [2, {c: null}]}});",
    "const __out = `${(1234.5678).toFixed(2)}|${(0.1 * 3).toString()}`;",
    "const __out = ['b', 'a', 10, 9].sort().join(',');",
    "const __out = 'a-b_c'.replace(/[-_]/g, m => m === '-' ? '+' : '*');",
    "const __out = JSON.stringify({x: [1, 'two', null, undefined], y: 1e21});",
    "const __out = JSON.parse('{\"k\": [1.5, true, null]}');",
    "const __out = parseInt('0x1F') + parseFloat('3.25abc');",
    "const __out = [typeof null, typeof undefined, typeof (() => 1), "
    "typeof NaN];",
    "let s = 0; for (const [k, v] of Object.entries({a: 1, b: 2})) "
    "{ s += v * k.length; } const __out = s;",
    "function f(n) { return n <= 1 ? n : f(n - 1) + f(n - 2); } "
    "const __out = f(15);",
    "const __out = encodeURIComponent('a b&c/é');",
    "const __out = (1234567.891).toLocaleString();",
    "const __out = Math.round(-2.5) + Math.max() + Math.min(3, 1);",
    "const __out = [[1, [2]], [3]].flat(2).reduce((a, b) => a + b, 0);",
    "let out = ''; try { null.x; } catch (e) { out = e.name; } "
    "const __out = out;",
    "const __out = null ?? (0 || 'x') ?? 'y';",
    "throw {name: 'RangeError', message: 'boom'};",
    "const __out = undefinedName + 1;",
    "const x = ;",
    "async function g() { throw new Error('late'); } g();",
    "const __out = new Promise((res) => res(41)).then(v => v + 1);",
]


def _outcome(mod, src):
    it = mod.Interpreter(rng=lambda: 0.25)
    try:
        it.run(src)
        value = it.get("__out")
        if isinstance(value, mod.JSPromise):
            value = it.await_value(value)
        return ("value", it.to_py(value))
    except (mod.JSError, mod.JSSyntaxError) as e:
        thrown = getattr(e, "value", None)
        return ("error", type(e).__name__, str(e),
                it.to_py(thrown) if thrown is not None else None)


@pytest.mark.parametrize("src", PROGRAMS)
def test_same_value_or_same_error(src):
    want = _outcome(jmini, src)
    got = _outcome(tmini, src)
    assert got == want


def test_port_module_imports_no_jax():
    code = ("import sys; import routest_tpu_torch.utils.minijs, "
            "routest_tpu_torch.utils.jsdom; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'routest_tpu' or "
            "m.startswith('routest_tpu.') or m == 'werkzeug']; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
