"""The ETA kernel chosen from a measured record
(``serve/ml_service.py::EtaService._fused_selection`` and
``_select_scorer``), and the goodput watchdog's curve pinned from the
port's record (``obs/efficiency.py::pin_expected_curve``).

Selection is decided on the host, so it is tested here without a card:
hand-written records in ``tmp_path`` (``ROUTEST_KERNEL_BENCH``), and an
``EtaService`` on the CPU whose runtime identity is given as the card's
(``_runtime_identity``). Its scorer then calls the kernel's wrapper or
the plain version exactly as it would on the card — both run the plain
arithmetic on a CPU tensor — and the test records which one each
bucket reached. Also: ``ROUTEST_FUSED`` 1, 0 and auto (the kernel at
every batch, whatever the record says; a record that says the plain
version won is refused and named);
the ``kernel`` string and the ``win_bucket`` block in ``/api/health``
(the provenance keys it shares with the JAX service's block equal that
block on the same record); a failed kernel that degrades the model
instead of handing the flush to the plain version; the provenance
across a hot swap; the committed records, whose tiles are ``tile_rows``'
picks on their card (so serving need not replay them); and the record
script's ``--cpu`` run.
"""

import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch
from werkzeug.test import Client

from routest_tpu.serve.ml_service import EtaService as JEtaService
from routest_tpu_torch.core.config import Config, ServeConfig
from routest_tpu_torch.obs import efficiency as teff
from routest_tpu_torch.ops.fused_mlp import (_check_packing, pack_eta_params,
                                             tile_rows)
from routest_tpu_torch.serve import ml_service
from routest_tpu_torch.serve.app import create_app
from routest_tpu_torch.serve.ml_service import EtaService

ARTIFACT = "artifacts/eta_mlp.msgpack"
CARD = "NVIDIA H100 80GB HBM3"
BUCKETS = (8, 64, 512, 1024, 2048, 4096)
BATCHES = BUCKETS + (8192, 16384)
RUNTIME = ("cuda", CARD)
# the SMs of the card the committed records name (H100 SXM5)
CARD_SMS = 132


def _record(backend="cuda", device=CARD, win=16384, tiles=None,
            dtypes=("bfloat16", "int8")):
    """A selection table of the shape the record script writes."""
    tiles = tiles or {b: 16 if b <= 2048 else 32 for b in BATCHES}

    def table():
        rows = [{"batch": b, "kernel_tile": tiles[b],
                 "winner": "kernel" if b <= win else "plain",
                 "kernel_eager_us": 15.0, "plain_us": 900.0}
                for b in BATCHES]
        return {"rows": rows, "kernel_wins_max_bucket": win}

    by_dtype = {d: table() for d in dtypes}
    return dict({"backend": backend, "device": device,
                 "power_limit": "700.00 W", "recorded_unix": 1790000000,
                 "kernel_dtype": "bfloat16"},
                **by_dtype.get("bfloat16", {}), by_dtype=by_dtype)


def _write(tmp_path, record, name="kernel_bench_cuda.json"):
    path = tmp_path / name
    path.write_text(record if isinstance(record, str)
                    else json.dumps(record))
    return str(path)


@pytest.fixture()
def bench(monkeypatch, tmp_path):
    """Point ``ROUTEST_KERNEL_BENCH`` at a record written by the case."""
    monkeypatch.delenv("ROUTEST_FUSED", raising=False)

    def use(record, name="kernel_bench_cuda.json"):
        path = _write(tmp_path, record, name)
        monkeypatch.setenv("ROUTEST_KERNEL_BENCH", path)
        return path

    return use


# ── the record ───────────────────────────────────────────────────────

@pytest.mark.parametrize("case,status", [
    ("cuda", "selected"),
    ("tpu", "backend_mismatch"),
    ("cpu", "backend_mismatch"),
    ("other_card", "device_mismatch"),
    ("malformed", "unreadable"),
    ("not_an_object", "unreadable"),
    ("bad_tile", "unreadable"),
    ("missing", "no_record"),
    ("no_int8_rows", "dtype_not_recorded"),
    ("plain_won", "plain_won"),
])
def test_fused_selection(bench, monkeypatch, tmp_path, case, status):
    variant = "int8" if case == "no_int8_rows" else "bfloat16"
    if case == "missing":
        path = str(tmp_path / "absent.json")
        monkeypatch.setenv("ROUTEST_KERNEL_BENCH", path)
    else:
        path = bench({
            "cuda": _record(), "tpu": _record(backend="tpu"),
            "cpu": _record(backend="cpu", device="cpu"),
            "other_card": _record(device="NVIDIA A100-SXM4-80GB"),
            "malformed": "{not json",
            "not_an_object": "[1, 2]",
            "bad_tile": _record(tiles={b: 64 for b in BATCHES}),
            "no_int8_rows": _record(dtypes=("bfloat16",)),
            "plain_won": _record(win=512),
        }[case])
    prov = EtaService._fused_selection(variant, RUNTIME)
    assert prov["status"] == status and prov["path"] == path
    assert prov["kernel_dtype"] == variant
    if status in ("selected", "plain_won"):
        assert prov["kernel_wins_max_bucket"] == \
            (16384 if status == "selected" else 512)
        assert prov["kernel_tiles"] == {
            str(b): 16 if b <= 2048 else 32 for b in BATCHES}
        assert (prov["backend"], prov["device"], prov["power_limit"],
                prov["recorded_unix"]) == ("cuda", CARD, "700.00 W",
                                           1790000000)
    else:
        assert "kernel_wins_max_bucket" not in prov
        assert "kernel_tiles" not in prov


def test_the_default_record_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("ROUTEST_KERNEL_BENCH", raising=False)
    prov = EtaService._fused_selection("bfloat16", RUNTIME)
    assert prov["path"] == ml_service.KERNEL_BENCH_RECORD
    assert prov["path"].endswith(os.path.join("artifacts",
                                              "kernel_bench_cuda.json"))


@pytest.mark.parametrize("backend", ["tpu", "cuda"])
def test_provenance_shares_the_jax_blocks_keys(bench, backend):
    """On one record carrying both packages' keys, the provenance keys
    the two blocks share are equal; each package accepts only its own
    backend."""
    rec = _record(backend=backend)
    rec["pallas_wins_max_bucket"] = 4096
    for row in rec["rows"]:
        row["pallas_tile"] = 512
    path = bench(rec)
    jwin, _, jprov = JEtaService._fused_selection()
    prov = EtaService._fused_selection("bfloat16", RUNTIME)
    shared = ("path", "backend", "recorded_unix")
    assert {k: prov[k] for k in shared} == {k: jprov[k] for k in shared}
    assert prov["path"] == path
    assert (jwin == 4096) == (backend == "tpu")
    assert (prov["status"] == "selected") == (backend == "cuda")


# ── the service ──────────────────────────────────────────────────────

@pytest.fixture()
def card_service(monkeypatch):
    """An ``EtaService`` factory whose runtime is the card's, with the
    artifact's bf16 compute: every scorer call is recorded as (path,
    rows, tile) and answers zeros of the right shape (which path ran is
    the question here; the answers are held elsewhere). The tile is
    None where the wrapper picks ``tile_rows``'."""
    calls = []

    def zeros(x, n_q):
        return torch.zeros((len(x), n_q) if n_q else (len(x),))

    def fused_spy(packed, x, *, n_q=0, tile=None):
        calls.append(("kernel", len(x), tile))
        return zeros(x, n_q)

    def plain_spy(packed, x, *, n_q=0):
        calls.append(("plain", len(x), None))
        return zeros(x, n_q)

    monkeypatch.setattr(ml_service, "fused_eta_forward", fused_spy)
    monkeypatch.setattr(ml_service, "fused_eta_forward_plain", plain_spy)
    monkeypatch.setattr(EtaService, "_runtime_identity",
                        lambda self: RUNTIME)
    monkeypatch.setenv("ROUTEST_WARM_BUCKETS", "0")
    # the artifact's bf16 policy, as the card serves it
    monkeypatch.setenv("RTPU_CPU_COMPUTE", "bf16")

    def make(path=ARTIFACT, **cfg):
        svc = EtaService(ServeConfig(**cfg), model_path=path, device="cpu")
        calls.clear()
        return svc

    make.calls = calls
    return make


RECORDED_TILES = {b: 16 if b <= 2048 else 32 for b in BATCHES}


def _route(svc, calls):
    """Score one zero slab per bucket and the two larger batches →
    {rows: (path, tile)}."""
    out = {}
    for b in BATCHES:
        calls.clear()
        res = svc._score(np.zeros((b, 12), np.float32))
        assert res.shape == (b, 3) and np.isfinite(res).all()
        assert len(calls) == 1
        out[b] = calls[0][0], calls[0][2]
    return out


@pytest.mark.parametrize("mode,record,kernel,status", [
    ("auto", "wins_all", "cuda_fused", "selected"),
    ("auto", "wins_to_512", "cuda_fused", "plain_won"),
    ("auto", "wins_none", "cuda_fused", "plain_won"),
    ("auto", "other_card", "cuda_fused", "device_mismatch"),
    ("auto", "missing", "cuda_fused", "no_record"),
    ("1", "wins_to_512", "cuda_fused", "plain_won"),
    ("1", "missing", "cuda_fused", "no_record"),
    ("0", "wins_all", "torch_plain", "selected"),
    ("yes", "wins_to_512", "cuda_fused", "plain_won"),
])
def test_routest_fused_modes(bench, card_service, monkeypatch, tmp_path,
                             mode, record, kernel, status):
    """Each mode's kernel string, provenance and, per batch, which path
    scored it: the kernel at every batch, with ``tile_rows``' tile,
    unless the operator asked for the plain version (``0``). A record
    in which the plain version won a batch is refused and named, and
    does not hand those batches to the plain version."""
    monkeypatch.setenv("ROUTEST_FUSED", mode)
    if record == "missing":
        monkeypatch.setenv("ROUTEST_KERNEL_BENCH",
                           str(tmp_path / "absent.json"))
    else:
        bench({"wins_all": _record(), "wins_to_512": _record(win=512),
               "wins_none": _record(win=0),
               "other_card": _record(device="NVIDIA A100-SXM4-80GB")
               }[record])
    svc = card_service()
    assert svc.available and svc.kernel == kernel
    prov = svc.scoring_info()["win_bucket"]
    assert prov["mode"] == (mode if mode in ("0", "1") else "auto")
    assert prov["status"] == status
    want = ("plain", None) if mode == "0" else ("kernel", None)
    assert _route(svc, card_service.calls) == {b: want for b in BATCHES}


def test_a_record_the_plain_version_won_is_logged_as_refused(
        bench, card_service, monkeypatch):
    bench(_record(win=64))
    logged = []
    logger = ml_service.get_logger("routest_tpu_torch.serve")
    monkeypatch.setattr(logger, "warning",
                        lambda event, **kw: logged.append((event, kw)))
    svc = card_service()
    assert svc.kernel == "cuda_fused"
    assert [(e, kw["status"], kw["kernel_wins_max_bucket"])
            for e, kw in logged] == [("kernel_record_refused", "plain_won",
                                      64)]


def test_int8_reads_its_own_rows(bench, card_service, monkeypatch):
    rec = _record()
    rec["by_dtype"]["int8"]["kernel_wins_max_bucket"] = 1024
    bench(rec)
    monkeypatch.setenv("RTPU_KERNEL_DTYPE", "int8")
    svc = card_service()
    assert svc.kernel_dtype == "int8"
    assert svc.kernel == "cuda_fused"
    prov = svc.scoring_info()["win_bucket"]
    assert (prov["status"], prov["kernel_wins_max_bucket"]) == \
        ("plain_won", 1024)


def test_health_names_the_record(bench, card_service):
    path = bench(_record())
    svc = card_service()
    app = create_app(Config(), eta_service=svc)
    try:
        body = Client(app).get("/api/health").get_json()
    finally:
        app.close()
    scoring = body["checks"]["model"]["scoring"]
    assert scoring["kernel"] == "cuda_fused"
    assert scoring["win_bucket"] == {
        "path": path, "backend": "cuda", "device": CARD,
        "power_limit": "700.00 W", "recorded_unix": 1790000000,
        "kernel_dtype": "bfloat16", "status": "selected",
        "kernel_wins_max_bucket": 16384,
        "kernel_tiles": {str(b): RECORDED_TILES[b] for b in BATCHES},
        "mode": "auto"}


def test_a_refused_record_keeps_the_kernel_and_says_why(bench, card_service):
    path = bench(_record(backend="tpu"))
    svc = card_service()
    assert svc.kernel == "cuda_fused"
    app = create_app(Config(), eta_service=svc)
    try:
        body = Client(app).get("/api/health").get_json()
    finally:
        app.close()
    block = body["checks"]["model"]["scoring"]["win_bucket"]
    assert (block["status"], block["path"], block["backend"]) == \
        ("backend_mismatch", path, "tpu")
    assert body["checks"]["model"]["status"] == "ok"


@pytest.mark.parametrize("mode", ["auto", "1"])
def test_a_failing_kernel_degrades_instead_of_serving_plain(
        bench, card_service, monkeypatch, mode):
    """A launch failure is not caught and handed to the plain version:
    the self-check sees it and the model reports degraded."""
    bench(_record())
    monkeypatch.setenv("ROUTEST_FUSED", mode)

    def broken(packed, x, *, n_q=0, tile=None):
        raise RuntimeError("fused_eta_forward launch failed: CUDA error 98")

    monkeypatch.setattr(ml_service, "fused_eta_forward", broken)
    svc = card_service()
    assert not svc.available
    assert "CUDA error 98" in svc.load_error
    assert card_service.calls == []       # the plain version never ran
    app = create_app(Config(), eta_service=svc)
    try:
        body = Client(app).get("/api/health").get_json()
    finally:
        app.close()
    assert body["checks"]["model"]["status"] == "degraded"


def test_the_cpu_run_selects_nothing(bench, monkeypatch):
    """On an explicit CPU run the plain version serves whatever the
    record says, and health carries no selection block."""
    bench(_record())
    monkeypatch.setenv("ROUTEST_WARM_BUCKETS", "0")
    svc = EtaService(ServeConfig(), model_path=ARTIFACT, device="cpu")
    assert svc.kernel == "torch_plain"
    assert "win_bucket" not in svc.scoring_info()


def test_a_hot_swap_carries_the_provenance(bench, card_service, tmp_path):
    path = str(tmp_path / "eta.msgpack")
    shutil.copy("artifacts/eta_mlp_point.msgpack", path)
    bench(_record(win=1024))
    svc = card_service(path)
    assert svc.scoring_info()["win_bucket"]["kernel_wins_max_bucket"] == 1024
    bench(_record(), name="second.json")
    shutil.copy(ARTIFACT, path)
    os.utime(path, ns=(1, 1))
    assert svc.reload_if_changed()
    assert svc.kernel == "cuda_fused"
    prov = svc.scoring_info()["win_bucket"]
    assert (prov["status"], prov["kernel_wins_max_bucket"]) == \
        ("selected", 16384)
    assert prov["path"].endswith("second.json")


# ── the committed records and the watchdog ───────────────────────────

def _committed(name):
    with open(os.path.join("artifacts", name)) as f:
        return json.load(f)


def test_the_committed_records_cover_every_bucket():
    """Measured on the card: backend, card name and power limit, bf16
    and int8 rows at every serving bucket plus 8192 and 16384."""
    serving = _committed("serving_kernel_cuda.json")
    selection = _committed("kernel_bench_cuda.json")
    for rec in (serving, selection):
        assert rec["backend"] == "cuda"
        assert rec["device"].startswith("NVIDIA H100")
        assert rec["power_limit"].endswith("W")
        assert rec["device"] == selection["device"]
    assert [r["batch"] for r in serving["rows"]] == list(BATCHES)
    for dtype in ("bfloat16", "int8"):
        rows = serving["rows_by_dtype"][dtype]
        assert [r["batch"] for r in rows] == list(BATCHES)
        assert all(r["kernel_mpreds_s"] > 0 and r["plain_mpreds_s"] > 0
                   for r in rows)
        table = selection["by_dtype"][dtype]
        assert [r["batch"] for r in table["rows"]] == list(BATCHES)
        assert table["kernel_wins_max_bucket"] == \
            serving["kernel_wins_max_bucket_by_dtype"][dtype]
    assert selection["rows"] == selection["by_dtype"]["bfloat16"]["rows"]


def test_the_committed_record_pins_only_on_its_card():
    """``backend_mismatch`` on the CPU; ``pinned`` when the runtime is
    the card the record names; ``device_mismatch`` on another card."""
    cfg = teff.EfficiencyConfig()
    assert cfg.kernel_artifact == "artifacts/serving_kernel_cuda.json"
    device = _committed("serving_kernel_cuda.json")["device"]
    assert teff.pin_expected_curve(cfg, "cpu", 1, "cpu")["status"] == \
        "backend_mismatch"
    pin = teff.pin_expected_curve(cfg, "cuda", 1, device)
    assert pin["status"] == "pinned"
    assert sorted(pin["curve"]) == list(BATCHES)
    other = teff.pin_expected_curve(cfg, "cuda", 1, "NVIDIA A100-SXM4-80GB")
    assert (other["status"], other["recorded_device"]) == \
        ("device_mismatch", device)


def test_the_committed_selection_is_accepted_on_its_card(monkeypatch):
    monkeypatch.delenv("ROUTEST_KERNEL_BENCH", raising=False)
    rec = _committed("kernel_bench_cuda.json")
    prov = EtaService._fused_selection("bfloat16", ("cuda", rec["device"]))
    assert prov["status"] == "selected"
    assert prov["kernel_wins_max_bucket"] == rec["kernel_wins_max_bucket"]
    assert sorted(map(int, prov["kernel_tiles"])) == list(BATCHES)
    cpu = EtaService._fused_selection("bfloat16", ("cpu", "cpu"))
    assert cpu["status"] == "backend_mismatch"


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_the_committed_tiles_are_tile_rows_picks(dtype):
    """Serving launches at ``tile_rows``' tile and keeps the record's
    tiles as provenance. That holds only while the record's winners are
    ``tile_rows``' picks on its card: where a re-measured record says
    otherwise, serving must replay the recorded tile per bucket."""
    from routest_tpu_torch.train.checkpoint import load_model

    rec = _committed("kernel_bench_cuda.json")
    assert rec["device"] == CARD
    model, params = load_model(ARTIFACT)
    dims, compute = _check_packing(pack_eta_params(model, params,
                                                   dtype=dtype))
    for row in rec["by_dtype"][dtype]["rows"]:
        assert row["kernel_tile"] == tile_rows(row["batch"], dims, compute,
                                               CARD_SMS), row


# ── the record script ────────────────────────────────────────────────

def _script():
    spec = importlib.util.spec_from_file_location(
        "bench_serving_kernel_cuda",
        os.path.join("scripts", "bench_serving_kernel_cuda.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_script_cpu_run_writes_a_refused_record(tmp_path, monkeypatch):
    script = _script()
    with pytest.raises(SystemExit):
        script.main(["--cpu"])            # never over the committed files
    out = tmp_path / "records"
    assert script.main(["--cpu", "--out", str(out), "--batches", "8", "64",
                        "--repeats", "1"]) == 0
    serving = json.loads((out / "serving_kernel_cuda.json").read_text())
    selection = json.loads((out / "kernel_bench_cuda.json").read_text())
    assert serving["backend"] == selection["backend"] == "cpu"
    assert serving["kernel_dtype"] == "bfloat16"
    assert [r["batch"] for r in serving["rows"]] == [8, 64]
    assert sorted(serving["rows_by_dtype"]) == ["bfloat16", "int8"]
    for row in serving["rows"]:
        assert row["winner"] in ("kernel", "plain") and row["plain_us"] > 0
    assert selection["kernel_wins_max_bucket"] == \
        script.win_bucket(serving["rows"])
    monkeypatch.setenv("ROUTEST_KERNEL_BENCH",
                       str(out / "kernel_bench_cuda.json"))
    prov = EtaService._fused_selection("bfloat16", RUNTIME)
    assert prov["status"] == "backend_mismatch"
    cfg = teff.EfficiencyConfig(
        kernel_artifact=str(out / "serving_kernel_cuda.json"))
    assert teff.pin_expected_curve(cfg, "cuda", 1, CARD)["status"] == \
        "backend_mismatch"


@pytest.mark.parametrize("winners,win", [
    (("kernel",) * 4, 4096), (("kernel", "plain", "kernel", "kernel"), 8),
    (("plain",) * 4, 0), (("kernel", "kernel", "kernel", "plain"), 512),
])
def test_win_bucket_is_the_unbroken_run_from_the_smallest(winners, win):
    rows = [{"batch": b, "winner": w}
            for b, w in zip((8, 64, 512, 4096), winners)]
    assert _script().win_bucket(rows[::-1]) == win
