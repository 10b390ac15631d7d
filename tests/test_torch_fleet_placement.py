"""Fleet placement: the port's ``serve/fleet/placement.py`` against the
JAX planner on the same inventories.

``candidate_layouts``, ``parse_layout_spec``, ``plan_placement`` and
``growth_slice`` give the same layouts, slices, device ids, capacities,
sources and GPU overlays as the JAX package's over a grid of
inventories × specs × a measured record and none. The CPU overlay is the
one deliberate difference (the port pins ``ROUTEST_DEVICE=cpu`` where
the JAX planner sets ``XLA_FLAGS``/``ROUTEST_FORCE_CPU``) and is pinned
on its own. The port's inventory counts CUDA devices and raises with no
card unless the CPU was asked for; planning imports neither ``jax`` nor
``routest_tpu`` and creates no CUDA context; a replica handed a slice
of more than one device (``ROUTEST_MESH=1``) on a host with one device
boots and serves single-device, as the JAX entry point does, and its
health says so."""

import json
import os
import subprocess
import sys

import pytest

from routest_tpu.serve.fleet import placement as jpl
from routest_tpu_torch.serve import __main__ as tserve_main
from routest_tpu_torch.serve.fleet import placement as tpl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INVENTORIES = [("cpu", 1), ("cpu", 4), ("cpu", 8),
               ("gpu", 1), ("gpu", 2), ("gpu", 8)]
SPECS = ["auto", "replica", "mesh", "2x4", "4,2,1"]


def _record(tmp_path, platform):
    path = tmp_path / f"chips_{platform}.json"
    path.write_text(json.dumps({
        "host": {"backend": platform},
        "curve": [{"chips": 1, "preds_per_s": 1000.0},
                  {"chips": 2, "preds_per_s": 1990.0},
                  {"chips": 4, "preds_per_s": 3700.0},
                  {"chips": 8, "preds_per_s": 6000.0}]}))
    return str(path)


def _plan_or_error(mod, inventory, **kw):
    try:
        return mod.plan_placement(inventory, **kw), None
    except ValueError as e:
        return None, str(e)


def _comparable(plan):
    """The plan as a dict, CPU overlays set aside (pinned separately)."""
    d = plan.as_dict()
    if plan.platform == "cpu":
        for s in d["slices"]:
            s.pop("env")
    return d


@pytest.mark.parametrize("chips", range(1, 10))
def test_candidate_layouts_match(chips):
    assert tpl.candidate_layouts(chips) == jpl.candidate_layouts(chips)


@pytest.mark.parametrize("spec", ["2x4", "4,2,1", "1x1", "3x2", "8",
                                  "auto", "0x2", "2,0", "x", "9x1"])
def test_parse_layout_spec_matches(spec):
    def run(mod):
        try:
            return mod.parse_layout_spec(spec, 8)
        except ValueError as e:
            return str(e)

    assert run(tpl) == run(jpl)


@pytest.mark.parametrize("measured", [False, True])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("platform,chips", INVENTORIES)
def test_plans_match_the_jax_planner(tmp_path, platform, chips, spec,
                                     measured):
    record = _record(tmp_path, platform) if measured \
        else str(tmp_path / "absent.json")
    for replicas in (None, 2):
        kw = dict(replicas=replicas, spec=spec, mesh_eff=0.92,
                  record_path=record)
        got, got_err = _plan_or_error(
            tpl, tpl.DeviceInventory(platform, chips, "env"), **kw)
        want, want_err = _plan_or_error(
            jpl, jpl.DeviceInventory(platform, chips, "env"), **kw)
        assert got_err == want_err
        if want is None:
            continue
        assert _comparable(got) == _comparable(want)
        for i in range(4):
            g, w = got.growth_slice(i), want.growth_slice(i)
            assert (g.chips, g.device_ids, g.label, g.capacity) == \
                (w.chips, w.device_ids, w.label, w.capacity)
            if platform == "gpu":
                assert dict(g.env) == dict(w.env)


def test_one_card_plans_one_replica_and_grows_onto_it():
    plan = tpl.plan_placement(tpl.DeviceInventory("gpu", 1, "cuda"),
                              replicas=2, record_path="")
    assert (plan.platform, plan.total_chips, plan.layout) == ("gpu", 1,
                                                               "1x1")
    assert [s.label for s in plan.slices] == ["s0:1chip"]
    grown = plan.growth_slice(1)
    assert grown.label == "g1:1chip"
    assert grown.env["CUDA_VISIBLE_DEVICES"] == "0"
    assert grown.env["ROUTEST_MESH"] == "0"


def test_replica_spec_plans_past_a_one_card_inventory_as_jax():
    # The reference's fault, copied: the second slice names device 1 on
    # a one-card host (its replica finds no card and crash-loops).
    for mod in (tpl, jpl):
        plan = mod.plan_placement(mod.DeviceInventory("gpu", 1, "env"),
                                  replicas=2, spec="replica",
                                  record_path="")
        assert [s.env["CUDA_VISIBLE_DEVICES"] for s in plan.slices] == \
            ["0", "1"]


def test_cpu_overlays_pin_the_cpu():
    auto = tpl.plan_placement(tpl.DeviceInventory("cpu", 4, "env"),
                              replicas=2, record_path="")
    assert [dict(s.env) for s in auto.slices] == [
        {tpl.PLACEMENT_LABEL_ENV: f"s{i}:host", "ROUTEST_DEVICE": "cpu"}
        for i in range(2)]
    forced = tpl.plan_placement(tpl.DeviceInventory("cpu", 4, "env"),
                                spec="2x2", record_path="")
    assert dict(forced.slices[1].env) == {
        tpl.PLACEMENT_LABEL_ENV: "s1:2chip", "RTPU_FLEET_SLICE_CHIPS": "2",
        "ROUTEST_DEVICE": "cpu", "RTPU_MESH_DATA": "2", "ROUTEST_MESH": "1"}
    # The overlays name none of the JAX placement knobs.
    for plan in (auto, forced):
        for s in plan.slices:
            assert not {"XLA_FLAGS", "ROUTEST_FORCE_CPU",
                        "TPU_VISIBLE_DEVICES"} & set(s.env)


def test_measured_rates_refuse_a_foreign_record(tmp_path):
    # The JAX package's committed curve was measured on the CPU.
    jax_record = os.path.join(REPO, "artifacts", "fleet_chips.json")
    assert tpl.measured_rates(jax_record, "gpu") is None
    assert jpl.measured_rates(jax_record, "gpu") is None
    path = _record(tmp_path, "gpu")
    assert tpl.measured_rates(path, "gpu") == jpl.measured_rates(path, "gpu")
    assert tpl.measured_rates(path, "cpu") is None
    assert tpl.measured_rates(str(tmp_path / "absent.json"), "gpu") is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert tpl.measured_rates(str(bad), "gpu") is None


def test_detect_inventory_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr("torch.cuda.device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpl.detect_inventory({})
    assert tpl.detect_inventory({"ROUTEST_DEVICE": "cpu"}) == \
        tpl.DeviceInventory("cpu", 1, "default")
    assert tpl.detect_inventory({"RTPU_FLEET_CHIPS": "2"}) == \
        tpl.DeviceInventory("gpu", 2, "env")
    assert tpl.detect_inventory({"RTPU_FLEET_CHIPS": "4",
                                 "ROUTEST_DEVICE": "cpu"}) == \
        tpl.DeviceInventory("cpu", 4, "env")
    with pytest.raises(ValueError, match="RTPU_FLEET_PLATFORM"):
        tpl.detect_inventory({"RTPU_FLEET_CHIPS": "4",
                              "RTPU_FLEET_PLATFORM": "tpu"})
    # A malformed override falls through to the device count.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpl.detect_inventory({"RTPU_FLEET_CHIPS": "two"})
    monkeypatch.setattr("torch.cuda.device_count", lambda: 3)
    assert tpl.detect_inventory({}) == tpl.DeviceInventory("gpu", 3, "cuda")
    # The JAX package's knobs place nothing here.
    assert tpl.detect_inventory({
        "ROUTEST_FORCE_CPU": "1",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}) == \
        tpl.DeviceInventory("gpu", 3, "cuda")


_PLAN_SCRIPT = """
import json, sys
import torch
torch.cuda.device_count = lambda: 1
from routest_tpu_torch.serve.fleet.placement import plan_from_env
plan = plan_from_env({"RTPU_FLEET_PLACEMENT_RECORD": ""}, replicas=2)
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "routest_tpu"
              or m.startswith("routest_tpu."))
print(json.dumps({"layout": plan.layout, "platform": plan.platform,
                  "foreign": mods,
                  "cuda_initialized": torch.cuda.is_initialized()}))
"""


def test_planning_imports_no_jax_and_creates_no_cuda_context():
    env = {k: v for k, v in os.environ.items()
           if k not in ("ROUTEST_DEVICE", "RTPU_FLEET_CHIPS")}
    out = subprocess.run([sys.executable, "-c", _PLAN_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"layout": "1x1", "platform": "gpu", "foreign": [],
                   "cuda_initialized": False}


@pytest.mark.parametrize("chips,mesh", [
    (1, "0"), (1, None), (2, "1"), (1, "1"), (4, "0"), ("x", None)])
def test_a_replica_on_one_device_serves_a_mesh_slice_single_device(chips,
                                                                  mesh):
    """``ROUTEST_MESH`` (auto, 1 or 0) builds a mesh only over more than
    one device of the serving backend: this host's one CPU never gets
    one, whatever the slice says."""
    from routest_tpu_torch.core.config import load_config

    env = {"RTPU_FLEET_SLICE_CHIPS": str(chips), "ROUTEST_DEVICE": "cpu"}
    if mesh is not None:
        env["ROUTEST_MESH"] = mesh
    assert tserve_main.mesh_runtime(load_config(env), env) is None


def test_a_two_device_slice_boots_and_serves_single_device():
    import signal
    import time
    import urllib.request

    from routest_tpu_torch.serve.fleet.supervisor import free_port

    plan = tpl.plan_placement(tpl.DeviceInventory("cpu", 2, "env"),
                              spec="mesh", record_path="")
    overlay = plan.slices[0].env
    assert overlay["ROUTEST_MESH"] == "1"
    assert overlay["RTPU_FLEET_SLICE_CHIPS"] == "2"
    port = free_port()
    env = {**os.environ, **overlay, "PORT": str(port),
           "ROUTEST_WARM_BUCKETS": "0"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "routest_tpu_torch.serve"], cwd=REPO,
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            try:
                with urllib.request.urlopen(f"{base}/api/ping",
                                            timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            assert time.monotonic() < deadline, "the replica never booted"
            time.sleep(0.25)
        req = urllib.request.Request(
            f"{base}/api/predict_eta",
            data=json.dumps({"summary": {"distance": 5000}}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            body = json.loads(r.read())
        assert body["eta_minutes_ml"] > 0
        with urllib.request.urlopen(f"{base}/api/health", timeout=30) as r:
            mesh = json.loads(r.read())["checks"]["engine"]["mesh"]
        assert mesh["devices"] == 1 and mesh["sharded"] is False
        assert "axis_shapes" not in mesh
        assert mesh["placement"] == overlay[tpl.PLACEMENT_LABEL_ENV]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            _, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    assert "mesh_slice_refused" not in err
