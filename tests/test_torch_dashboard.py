"""The dashboard's pages on the port's app, through the port's JS engine
and DOM (``routest_tpu_torch/utils/{minijs,jsdom}.py``), against the
JAX app through the JAX engine and DOM.

- The logic cases of ``tests/test_dashboard_logic.py`` run on the
  port: its served ``lib/*.js`` executed by the port's minijs, its app
  (``EtaMLP`` (16, 16) f32 on the CPU, the JAX saver's artifact) as the
  live server — one parametrised test, the JAX file's case bodies.
- The glue flows of ``tests/test_dashboard_glue.py`` run once per
  stack, the JAX app with the JAX DOM and then the port's app with the
  port's DOM, on one artifact and one seed: each flow's assertions hold
  on the port, and after each flow the DOM (every element's tag,
  attributes, properties, style and text) and the page's ``FEATURE``
  equal the JAX stack's. Differences allowed, and normalized before the
  comparison (``_STAMPS``): the fresh ``request_id`` uuids, wall-clock
  stamps (ISO times, the ``HH:MM:SS`` the tracker and history print),
  the ``engine`` tag (``backend:jax-tpu`` / ``backend:torch-cpu``), the
  health page's runtime block, and numbers summed from the
  great-circle matrix or scored by the MLP, within rtol 1e-5 plus the
  0.1 rounding step (torch's ``sin``/``cos`` and matmuls differ from
  XLA's in the last bits, as in ``tests/test_torch_optimize_serve.py``).
"""

import functools
import inspect
import json
import os
import re

import jax
import pytest
from werkzeug.test import Client

import routest_tpu.utils.jsdom as jdom
import routest_tpu_torch.utils.jsdom as tdom
from routest_tpu.core.config import Config as JConfig
from routest_tpu.core.config import ServeConfig as JServeConfig
from routest_tpu.core.dtypes import F32_POLICY
from routest_tpu.models.eta_mlp import EtaMLP
from routest_tpu.serve.app import create_app as jax_create_app
from routest_tpu.serve.ml_service import EtaService as JEtaService
from routest_tpu.train.checkpoint import save_model
from routest_tpu_torch.core.config import Config, ServeConfig
from routest_tpu_torch.serve.app import create_app
from routest_tpu_torch.serve.ml_service import EtaService
from routest_tpu_torch.utils.minijs import run_file
from tests.torch_twin import (case_names, load_jax_cases, port_namespace,
                              rebound_namespace)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATIC = os.path.join(REPO, "routest_tpu_torch", "serve", "static")
LOGIC = load_jax_cases(os.path.join(REPO, "tests",
                                    "test_dashboard_logic.py"))
GLUE = load_jax_cases(os.path.join(REPO, "tests", "test_dashboard_glue.py"))
TICKS = (0.001, 0.002)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """One small f32 EtaMLP, written by the JAX saver, served by both."""
    path = str(tmp_path_factory.mktemp("model") / "eta.msgpack")
    model = EtaMLP(hidden=(16, 16), policy=F32_POLICY)
    save_model(path, model, model.init(jax.random.PRNGKey(0)))
    return path


def _port_app(artifact, **kw):
    eta = EtaService(ServeConfig(), model_path=artifact, device="cpu")
    return create_app(Config(serve=ServeConfig(device="cpu")),
                      eta_service=eta, sim_tick_range=TICKS, **kw)


def _jax_app(artifact, **kw):
    eta = JEtaService(JServeConfig(), model_path=artifact)
    return jax_create_app(JConfig(), eta_service=eta,
                          sim_tick_range=TICKS, **kw)


def _stop(app):
    close = getattr(app, "close", None)
    if close is not None:
        close()
    elif app.dispatch.reopt is not None:
        app.dispatch.reopt.stop()


@pytest.fixture(scope="module")
def apps(artifact):
    japp, tapp = _jax_app(artifact), _port_app(artifact)
    yield {"jax": japp, "torch": tapp}
    for app in (japp, tapp):
        _stop(app)


@pytest.fixture(scope="module")
def clients(apps):
    return {k: Client(v) for k, v in apps.items()}


# ── the logic cases, on the port ─────────────────────────────────────


@pytest.fixture(scope="module")
def logic(artifact):
    """The logic file's fixtures, built on a port app of their own (the
    glue flows' apps keep equal histories)."""
    app = _port_app(artifact)
    ns = port_namespace(
        LOGIC, _STATIC=STATIC,
        _LOGIC=os.path.join(STATIC, "lib", "dashboard_logic.js"),
        _PAGE=os.path.join(STATIC, "dashboard.html"))
    client = Client(app)
    js = run_file(ns["_LOGIC"])
    locations = client.get("/api/locations").get_json()
    payload = js.call("buildOptimizePayload", ns["_form"](locations))
    r = client.post("/api/optimize_route",
                    data=js.get("JSON")["stringify"](payload),
                    content_type="application/json")
    assert r.status_code == 200, r.get_data(as_text=True)
    ns["_fixtures"] = {"js": js, "client": client, "locations": locations,
                       "feature": r.get_json()}
    yield ns
    _stop(app)


@pytest.mark.parametrize("case", case_names(LOGIC))
def test_logic_case_on_the_port(case, logic):
    fn = logic[case]
    kw = {name: logic["_fixtures"][name]
          for name in inspect.signature(fn).parameters}
    fn(**kw)


def test_logic_cases_read_the_ports_files(logic):
    assert len(case_names(LOGIC)) == 26
    assert logic["_LOGIC"].startswith(STATIC)
    assert logic["run_file"] is run_file
    assert logic["Interpreter"].__module__ == \
        "routest_tpu_torch.utils.minijs"


# ── the glue flows, once per stack ───────────────────────────────────

_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                   r"[0-9a-f]{12}")
_ISO = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(?:\.\d+)?"
                  r"(?:Z|[+-]\d\d:\d\d)?")
_CLOCK = re.compile(r"\b\d\d:\d\d:\d\d\b")
_ENGINE = re.compile(r"backend:(?:jax-tpu|torch-cpu|torch-cuda)")
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[+-]?\d+)?")
# What is normalized before the comparison (the module docstring's list).
_STAMPS = (("request_id uuid", _UUID, "<uuid>"),
           ("ISO wall-clock time", _ISO, "<iso>"),
           ("HH:MM:SS wall clock", _CLOCK, "<clock>"),
           ("engine tag", _ENGINE, "backend:<runtime>"))


def _norm_text(s):
    if not isinstance(s, str):
        return s
    for _, pat, sub in _STAMPS:
        s = pat.sub(sub, s)
    return s


def _tracker_mark(node):
    """The tracker's done stroke, remaining stroke and driver head: where
    they split depends on how far the simulated driver had moved when
    the flow read its frame (the sim ticks on the wall clock)."""
    a = node.attrs
    return (a.get("id") == "driver" or a.get("stroke") == "var(--done)"
            or (node.tag == "path" and a.get("stroke-dasharray") == "6 5"))


def _runtime_block(node):
    """The health page's device card and raw JSON dump: device names,
    batcher counters, uptime, runtime versions and kernel names are the
    runtime's (``_health_summary`` compares what the page shows of the
    checks instead)."""
    if node.attrs.get("id") == "raw":
        return True
    return (node.props.get("className") == "card"
            and [c._text() for c in node.select(".name")] == ["tpu"])


def _health_summary(host):
    """The health JSON the page dumped: each check's name and status,
    the overall status."""
    raw = json.loads(host.text("raw"))
    return {"status": raw["status"],
            "checks": {k: v.get("status") for k, v in raw["checks"].items()
                       if k != "tpu"},
            "keys": sorted(raw)}


def _snapshot(node):
    """Every element's tag, attributes, primitive properties, style and
    text, depth first; functions (handlers) by presence only."""
    if not hasattr(node, "tag"):
        return _norm_text(str(node))
    if _tracker_mark(node):
        return {"tag": node.tag, "tracker": node.attrs.get("id", "stroke")}
    if _runtime_block(node):
        return {"tag": node.tag, "runtime": node.attrs.get("id", "tpu")}
    props = {}
    for k, v in sorted(node.props.items()):
        if isinstance(v, (str, bool, float, int)) or v is None:
            props[k] = _norm_text(v) if isinstance(v, str) else v
        else:
            props[k] = "<fn>"
    return {"tag": node.tag,
            "attrs": {k: _norm_text(v) for k, v in sorted(node.attrs.items())},
            "props": props,
            "style": dict(sorted(node.style.props.items())),
            "children": [_snapshot(c) for c in node.children]}


class _Recorder:
    """DomHost subclasses that remember every host a flow builds."""

    def __init__(self):
        self.hosts = []
        self.apps = []     # port apps a flow builds, closed after it

    def cls(self, base):
        rec = self

        class Recorded(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                rec.hosts.append(self)

        return Recorded

    def app(self, make):
        def made(*a, **kw):
            app = make(*a, **kw)
            self.apps.append(app)
            return app

        return made


def _close(got, want, path):
    assert abs(got - want) <= 0.1 + 1e-9 + 1e-5 * abs(want), \
        (path, got, want)


def _same(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(got), sorted(want))
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and isinstance(got, float):
        _close(got, want, path)
    elif isinstance(want, str) and isinstance(got, str):
        got, want = _norm_text(got), _norm_text(want)
        if got != want and _NUM.fullmatch(got) and _NUM.fullmatch(want):
            _close(float(got), float(want), path)
        else:
            assert got == want, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.fixture(scope="module")
def stacks(apps, clients, artifact, tmp_path_factory):
    """Per stack: the glue module's namespace (the port's rebound to the
    port), its DOM module, client and a host recorder."""
    out = {}
    for side, dom in (("jax", jdom), ("torch", tdom)):
        rec = _Recorder()
        if side == "jax":
            ns = rebound_namespace(GLUE, DomHost=rec.cls(dom.DomHost))
        else:
            # A flow that builds its own app (the auth dialog) builds the
            # port's on the CPU, from an artifact the JAX saver writes as
            # the module fixture's is.
            ns = port_namespace(
                GLUE, DomHost=rec.cls(dom.DomHost), jax=jax, EtaMLP=EtaMLP,
                F32_POLICY=F32_POLICY, save_model=save_model,
                EtaService=functools.partial(EtaService, device="cpu"),
                Config=lambda: Config(serve=ServeConfig(device="cpu")),
                create_app=rec.app(create_app))
        out[side] = {"ns": ns, "dom": dom, "client": clients[side],
                     "rec": rec}
    return out


def _flow_kwargs(fn, st, monkeypatch, tmp_path_factory):
    kw = {}
    for name in inspect.signature(fn).parameters:
        if name == "client":
            kw[name] = st["client"]
        elif name in ("host", "mvp"):
            page = st["client"].get("/ui" if name == "host" else "/") \
                .get_data(as_text=True)
            h = st["ns"]["DomHost"](page, st["client"])
            h.run_scripts()
            kw[name] = h
        elif name == "monkeypatch":
            kw[name] = monkeypatch
        elif name == "tmp_path_factory":
            kw[name] = tmp_path_factory
        else:
            raise KeyError(name)
    return kw


def _download(d):
    """A recorded download with its content parsed (GeoJSON, CSV)."""
    content = d["content"]
    if d["download"].endswith(".geojson"):
        content = json.loads(content)
    elif d["download"].endswith(".csv"):
        content = [row.split(",") for row in content.splitlines()]
    return dict(d, content=content)


def _state(host):
    try:
        feature = host.interp.to_py(host.interp.get("FEATURE"))
    except Exception as e:   # the page defines no FEATURE (mvp, health)
        assert "FEATURE is not defined" in str(e), e
        feature = "<none>"
    health = None
    if any(el.attrs.get("id") == "raw" for el in host.root.walk()):
        health = _health_summary(host)
    return {"dom": _snapshot(host.root),
            "health": health,
            "feature": feature,
            "downloads": [_download(d) for d in host.downloads],
            "fetch_log": [_norm_text(u) for u in host.fetch_log],
            "timers": [(t["delay"], t["repeating"]) for t in host.timers]}


@pytest.mark.parametrize("case", case_names(GLUE))
def test_glue_flow_equals_the_jax_stack(case, stacks, monkeypatch,
                                        tmp_path_factory):
    states = {}
    for side in ("jax", "torch"):
        st = stacks[side]
        st["rec"].hosts.clear()
        fn = st["ns"][case]
        try:
            with monkeypatch.context() as mp:
                fn(**_flow_kwargs(fn, st, mp, tmp_path_factory))
        finally:
            while st["rec"].apps:
                st["rec"].apps.pop().close()
        states[side] = [_state(h) for h in st["rec"].hosts]
    assert len(states["torch"]) == len(states["jax"]) >= 1
    for got, want in zip(states["torch"], states["jax"]):
        _same(got, want, case)
