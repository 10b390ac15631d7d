"""Device goodput: the port's ``obs/efficiency.py`` against the JAX
package's on the same records.

The same ``record``/``record_cached`` calls give the same ledger
snapshots and live per-bucket windows (the device identity aside: the
port names ``cuda`` or ``cpu`` from torch). Curve pinning reads the
port's own record keys (``kernel_mpreds_s`` / ``plain_mpreds_s``) on
hand-written records: a ``cuda`` record pins on the card's backend, the
JAX package's ``tpu`` record is refused as ``backend_mismatch``, a
missing file is ``no_artifact``, and more than one device keeps factor
1.0 with a note naming the unported placement. Armed on equivalent
curves, the two watchdogs give the same debounced verdicts and page the
same way into a stub recorder. The watchdog ticks are driven by hand:
no ticker thread runs."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from routest_tpu.core.config import \
    load_efficiency_config as jload_efficiency_config
from routest_tpu.obs import efficiency as jeff
from routest_tpu.obs.registry import MetricsRegistry as JRegistry
from routest_tpu_torch.core.config import load_efficiency_config
from routest_tpu_torch.obs import efficiency as teff
from routest_tpu_torch.obs.registry import MetricsRegistry

PACKAGES = {"jax": (jeff, jload_efficiency_config, JRegistry),
            "torch": (teff, load_efficiency_config, MetricsRegistry)}
BATCHES = (8, 64, 512, 4096)
RATES = (0.004, 0.05, 0.4, 2.5)          # Mrows/s per batch


@pytest.fixture(scope="module", autouse=True)
def _no_threads_left():
    """Fails the module if a thread its tests started is still alive
    (transient threads of other modules' apps end within seconds)."""
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()]
    deadline = time.monotonic() + 10.0
    for t in left:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not [t.name for t in left if t.is_alive()]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _records(led):
    rng = np.random.default_rng(7)
    for prog in teff.PROGRAMS:
        for _ in range(13):
            n = int(rng.integers(1, 300))
            bucket = 1 << max(0, n - 1).bit_length()
            led.record(prog, real_rows=n, padded_rows=bucket,
                       bucket=bucket, queue_s=float(rng.random()) * 1e-3,
                       compute_s=float(rng.random()) * 1e-2,
                       oversized=bool(n > 256))
        led.record_cached(prog, int(rng.integers(0, 40)))
    led.record("eta_score", real_rows=5, padded_rows=2, compute_s=0.0)


def test_ledger_snapshots_match():
    snaps = {}
    for k, (mod, load_cfg, reg_cls) in PACKAGES.items():
        led = mod.GoodputLedger(load_cfg({}), registry=reg_cls())
        _records(led)
        snap = led.snapshot()
        snap.pop("identity")
        snaps[k] = (snap, {p: led.window_rates(p) for p in mod.PROGRAMS})
    assert snaps["torch"] == snaps["jax"]
    assert teff.PROGRAMS == jeff.PROGRAMS


def test_disabled_ledger_records_nothing():
    led = teff.GoodputLedger(load_efficiency_config({"RTPU_EFF": "0"}),
                             registry=MetricsRegistry())
    _records(led)
    assert all(p["rows"] == 0
               for p in led.snapshot()["programs"].values())


def test_device_identity_names_the_asked_device():
    assert teff.device_identity("cpu") == {
        "backend": "cpu", "device": "cpu", "device_count": 1}
    led = teff.GoodputLedger(load_efficiency_config({}),
                             registry=MetricsRegistry())
    led.bind_device("cpu")
    assert led.identity()["backend"] == "cpu"
    if not torch.cuda.is_available():
        ident = teff.device_identity("cuda")
        assert ident["backend"] is None and "error" in ident


def _write(tmp_path, name, record):
    path = tmp_path / name
    path.write_text(json.dumps(record))
    return str(path)


def _port_record(backend):
    return {"backend": backend, "rows": [
        {"batch": b, "kernel_mpreds_s": r, "plain_mpreds_s": r * 1.5}
        for b, r in zip(BATCHES, RATES)] + [{"batch": "x"}, {"batch": 16}]}


def _jax_record(backend):
    return {"backend": backend, "rows": [
        {"batch": b, "xla_mpreds_s": r * 1.5, "aot_mpreds_s": r}
        for b, r in zip(BATCHES, RATES)]}


def _cfg(path, **env):
    return load_efficiency_config({"RTPU_EFF_KERNEL_ARTIFACT": path,
                                   **env})


def test_pin_reads_the_port_record_keys(tmp_path):
    pin = teff.pin_expected_curve(
        _cfg(_write(tmp_path, "k.json", _port_record("cuda"))), "cuda")
    assert pin["status"] == "pinned"
    assert pin["curve"] == {b: r * 1e6 for b, r in zip(BATCHES, RATES)}
    assert pin["chips_factor"] == 1.0 and pin["chips_note"] == "single_chip"
    jpin = jeff.pin_expected_curve(jload_efficiency_config(
        {"RTPU_EFF_KERNEL_ARTIFACT": _write(tmp_path, "j.json",
                                            _jax_record("tpu"))}), "tpu")
    assert jpin["curve"] == pin["curve"]   # the same floor per bucket


@pytest.mark.parametrize("runtime,record,status", [
    ("cuda", "jax_tpu", "backend_mismatch"),
    ("cpu", "port_cuda", "backend_mismatch"),
    ("cuda", "missing", "no_artifact"),
    ("cuda", "unreadable", "unreadable"),
    ("cuda", "jax_cuda", "empty"),
    ("cpu", "port_cpu", "pinned"),
])
def test_pin_refusals(tmp_path, runtime, record, status):
    if record == "missing":
        path = str(tmp_path / "absent.json")
    elif record == "unreadable":
        path = str(tmp_path / "bad.json")
        (tmp_path / "bad.json").write_text("{not json")
    else:
        src, backend = record.split("_")
        rec = (_port_record if src == "port" else _jax_record)(backend)
        path = _write(tmp_path, "r.json", rec)
    assert teff.pin_expected_curve(_cfg(path), runtime)["status"] == status


def test_more_than_one_device_keeps_factor_one(tmp_path):
    pin = teff.pin_expected_curve(
        _cfg(_write(tmp_path, "k.json", _port_record("cuda"))), "cuda",
        chips=4)
    assert pin["chips_factor"] == 1.0
    assert pin["chips_note"] == "placement_not_ported"


def test_default_record_is_the_ports_own():
    assert load_efficiency_config({}).kernel_artifact == \
        "artifacts/serving_kernel_cuda.json"
    assert jload_efficiency_config({}).kernel_artifact == \
        "artifacts/serving_kernel.json"


@pytest.mark.parametrize("batch", [1, 8, 20, 64, 300, 4096, 9000])
def test_expected_rate_matches(tmp_path, batch):
    pin = teff.pin_expected_curve(
        _cfg(_write(tmp_path, "k.json", _port_record("cpu"))), "cpu")
    assert teff.expected_rate(pin, batch) == jeff.expected_rate(pin, batch)


class _StubRecorder:
    def __init__(self):
        self.bundles = []

    def trigger(self, reason, detail=None, force=False, extra_files=None):
        self.bundles.append((reason, detail, force,
                             sorted(extra_files or {})))
        return f"bundle-{len(self.bundles)}"

    def register_slo_engine(self, engine):
        pass


def _watchdog(k, tmp_path, **env):
    mod, load_cfg, reg_cls = PACKAGES[k]
    record = (_port_record if k == "torch" else _jax_record)("cpu")
    path = _write(tmp_path, f"{k}.json", record)
    cfg = load_cfg({"RTPU_EFF_KERNEL_ARTIFACT": path,
                    "RTPU_EFF_MIN_ROWS": "10", "RTPU_EFF_AFTER": "3",
                    **env})
    reg = reg_cls()
    led = mod.GoodputLedger(cfg, registry=reg)
    if k == "torch":
        led.bind_device("cpu")
    rec = _StubRecorder()
    wd = mod.EfficiencyWatchdog(cfg, ledger=led, recorder=rec,
                                registry=reg, replica="host:1")
    return wd, led, rec


def _strip(snap):
    # The device count differs: the test process's JAX runs 8 virtual
    # CPU devices, the port one CPU.
    snap["pin"] = {k: v for k, v in snap["pin"].items()
                   if k not in ("kernel_artifact", "chips", "chips_note")}
    for o in snap.get("slo", {}).get("objectives", {}).values():
        o.pop("last_transition_unix", None)
    return snap


@pytest.mark.parametrize("scenario", ["healthy", "shortfall", "waste"])
def test_watchdog_verdicts_match(tmp_path, scenario):
    out = {}
    for k in PACKAGES:
        wd, led, rec = _watchdog(k, tmp_path, RTPU_EFF_MAX_WASTE="0.5")
        assert wd.arm() is True
        ticks = []
        exp = teff.expected_rate(wd.pin, 64)
        for _ in range(6):
            if scenario == "healthy":
                led.record("eta_score", real_rows=64, padded_rows=64,
                           bucket=64, compute_s=64 / exp)
            elif scenario == "shortfall":
                led.record("eta_score", real_rows=16, padded_rows=16,
                           bucket=8, compute_s=4.0)
            else:
                led.record("dispatch_solve", real_rows=3,
                           padded_rows=4096, bucket=4096, compute_s=0.01)
            ticks.append(wd.tick())
        out[k] = (ticks, _strip(wd.snapshot()), wd.health(),
                  [(r, d, f, x) for r, d, f, x in rec.bundles])
    assert out["torch"] == out["jax"]
    pages = out["torch"][2]["pages"]
    assert pages == (0 if scenario == "healthy" else 1)


def test_watchdog_degrades_loudly_without_a_record(tmp_path):
    wd, _, _ = _watchdog("torch", tmp_path)
    wd.config = _cfg(str(tmp_path / "absent.json"))
    assert wd.arm() is False
    assert wd.health() == {"ledger": True, "watchdog": "degraded",
                           "status": "no_artifact", "pages": 0}
    assert wd.tick() == {"armed": False, "status": "no_artifact"}


@pytest.mark.parametrize("env", [
    {}, {"RTPU_EFF": "0", "RTPU_EFF_WATCHDOG": "0", "RTPU_EFF_AFTER": "x",
         "RTPU_EFF_CHIPS_ARTIFACT": "c.json"},
])
def test_config_loader_matches_but_the_record(env):
    got = load_efficiency_config(env).__dict__
    want = jload_efficiency_config(env).__dict__
    assert got.pop("kernel_artifact") == "artifacts/serving_kernel_cuda.json"
    want.pop("kernel_artifact")
    assert got == want
