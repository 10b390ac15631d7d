#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc``
(``$CUDA_HOME`` or ``/usr/local/cuda``) and ``nvidia-smi``. Phases, each
of which fails the run:

1. device: the card's name, and ``nvidia-smi``'s name and power limit;
2. build: compile every kernel of the ETA path from ``routest_tpu_torch/
   ops/csrc`` (into ``build/kernels/``), with the compiler's register and
   shared-memory report;
3. kernel vs its plain PyTorch version on the card, bf16 and f32, point
   and quantile, at batches 0, 1, 7, 64, 4096 and 4099 of random rows
   with unknown categories, negative distances and out-of-range hours;
4. the shipped artifacts (``artifacts/eta_mlp.msgpack`` and
   ``eta_mlp_point.msgpack``) through the port's reader: kernel vs plain
   version, and vs the ``EtaMLP`` module as an independent reference;
5. serving: the port's app on a localhost port with ``EtaService`` on
   ``cuda``; ping, health, one ``/api/predict_eta``, one 4096-row
   columnar ``/api/predict_eta_batch`` and one ``items`` ``/api/predict``,
   checked for status, keys, finiteness, ``p10 <= eta <= p90``,
   agreement with the plain version, and the kernel's launch count over
   exactly these requests;
6. times at each serving bucket and two larger batches (CUDA events,
   after warm-up): the kernel, the wrapper's host cost to enqueue it,
   its plain version, and the least time the card could take
   (``bound_ms``, from the H100 SXM's published 989 TFLOP/s bf16 and
   3.35 TB/s).

The lines before the last are one ``{"kernels": [...]}`` JSON object
and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, with no result, when
there is no card or a phase fails.
"""

from __future__ import annotations

import datetime as dt
import http.client
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SERVING_BUCKETS = (8, 64, 512, 1024, 2048, 4096)
# Past the 132 SMs' one-tile-each point (132 × 32 rows): how the time
# grows once tiles share an SM.
SCALING_BATCHES = (8192, 16384)
PHASE3_BATCHES = (0, 1, 7, 64, 4096, 4099)
# (rtol, atol) per compute dtype: f32 differs from the plain version only
# in summation order; bf16 may also flip one rounding of a hidden
# activation — the classes of tests/test_ops_fused.py.
TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 0.5)}
H100_BF16_FLOPS = 989e12      # dense tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES_S = 3.35e12
KERNEL_SOURCE = "routest_tpu_torch/ops/csrc/fused_eta.cu"
REPLACES = "routest_tpu/ops/fused_mlp.py:366"


class PhaseError(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def random_params(rng, n_heads, hidden=(256, 256, 128)):
    """A params pytree at the shipped artifact's widths, He-initialized
    from ``rng``, with a distance/age normalizer."""
    import numpy as np

    dims = (42,) + tuple(hidden) + (n_heads,)
    layers = [{"w": (rng.standard_normal((i, o)) * np.sqrt(2.0 / i)
                     ).astype(np.float32),
               "b": (0.1 * rng.standard_normal(o)).astype(np.float32)}
              for i, o in zip(dims[:-1], dims[1:])]
    mean = np.zeros(12, np.float32)
    std = np.ones(12, np.float32)
    mean[10], std[10], mean[11], std[11] = 15.0, 10.0, 40.0, 12.0
    return {"layers": layers, "norm": {"mean": mean, "std": std}}


def random_rows(rng, n):
    """(n, 12) ABI rows: unknown categories (all-zero groups), weekdays
    and hours outside their range, negative distances."""
    import numpy as np

    x = np.zeros((n, 12), np.float32)
    rows = np.arange(n)
    w = rng.integers(-1, 4, n)
    t = rng.integers(-1, 4, n)
    x[rows[w >= 0], w[w >= 0]] = 1.0
    x[rows[t >= 0], 4 + t[t >= 0]] = 1.0
    x[:, 8] = np.floor(rng.uniform(-2, 9, n))
    x[:, 9] = np.floor(rng.uniform(-3, 27, n))
    x[:, 10] = rng.uniform(-5.0, 60.0, n)
    x[:, 11] = rng.uniform(18.0, 70.0, n)
    return x


def compare(got, want, dtype_name, n_q):
    """→ (max_abs, max_rel); raises on a shape, finiteness, tolerance or
    non-crossing failure."""
    import numpy as np

    got = got.float().cpu().numpy()
    want = want.float().cpu().numpy()
    check(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    if got.size == 0:
        return 0.0, 0.0
    check(np.isfinite(got).all(), "non-finite kernel output")
    rtol, atol = TOL[dtype_name]
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    check(not bad.any(), f"{int(bad.sum())} values beyond rtol {rtol} / "
                         f"atol {atol}; max abs err {err.max():.3g}")
    if n_q:
        check((np.diff(got, axis=1) >= -1e-5).all(), "quantiles cross")
    rel = err / np.maximum(np.abs(want), 1e-6)
    return float(err.max()), float(rel.max())


def time_ms(fn, iters):
    """→ (CUDA-event ms per call, host ms per call to enqueue it). The
    enqueue time is taken over a run short enough not to fill the launch
    queue, so it is the wrapper's own host cost."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / 50
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, enqueue_ms


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        payload = None if body is None else json.dumps(body)
        headers = {} if body is None else {"Content-Type": "application/json"}
        conn.request(method, path, body=payload, headers=headers)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[device] {name} | nvidia-smi: {smi_line} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi_line


def phase_build():
    from routest_tpu_torch.ops import build

    t0 = time.perf_counter()
    path, report = build.build("fused_eta")
    build.load_library()
    print(f"[build] fused_eta in {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(path, ROOT)}")
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"[build]   {line.strip()}")


def phase_random(rng):
    import torch

    from routest_tpu_torch.ops.fused_mlp import (fused_eta_forward,
                                                 fused_eta_forward_plain,
                                                 pack_eta_params)

    for n_q in (0, 3):
        params = random_params(rng, 2 * max(1, n_q))
        for dtype_name in ("bfloat16", "float32"):
            packed = pack_eta_params(None, params, dtype=dtype_name,
                                     device="cuda")
            worst = (0.0, 0.0)
            for b in PHASE3_BATCHES:
                x = torch.from_numpy(random_rows(rng, b)).cuda()
                got = fused_eta_forward(packed, x, n_q=n_q)
                want = fused_eta_forward_plain(packed, x, n_q=n_q)
                torch.cuda.synchronize()
                check(tuple(got.shape) == ((b, n_q) if n_q else (b,)),
                      f"batch {b}: shape {tuple(got.shape)}")
                err = compare(got, want, dtype_name, n_q)
                worst = max(worst[0], err[0]), max(worst[1], err[1])
            print(f"[random] {dtype_name:8s} n_q={n_q} batches "
                  f"{PHASE3_BATCHES}: max abs err {worst[0]:.3g}, max rel "
                  f"err {worst[1]:.3g} (tol rtol/atol {TOL[dtype_name]})")


def phase_artifacts(rng):
    """→ max abs kernel-vs-plain error over the shipped artifacts."""
    import dataclasses

    import torch

    from routest_tpu_torch.ops.fused_mlp import (fused_eta_forward,
                                                 fused_eta_forward_plain,
                                                 pack_eta_params)
    from routest_tpu_torch.serve.ml_service import golden_batch
    from routest_tpu_torch.train.checkpoint import load_model

    worst = 0.0
    for name in ("eta_mlp.msgpack", "eta_mlp_point.msgpack"):
        model, params = load_model(os.path.join(ROOT, "artifacts", name))
        n_q = len(model.quantiles)
        inputs = {"golden": golden_batch(), "random4096": random_rows(rng, 4096)}
        for dtype_name in ("bfloat16", "float32"):
            packed = pack_eta_params(model, params, dtype=dtype_name,
                                     device="cuda")
            reference = model.to("cuda")
            reference.policy = dataclasses.replace(
                model.policy, compute_dtype=getattr(torch, dtype_name))
            for label, rows in inputs.items():
                x = torch.from_numpy(rows).cuda()
                got = fused_eta_forward(packed, x, n_q=n_q)
                err = compare(got, fused_eta_forward_plain(packed, x, n_q=n_q),
                              dtype_name, n_q)
                with torch.no_grad():
                    ref = (reference.apply_quantiles(x) if n_q
                           else reference(x))
                ref_err = compare(got, ref, dtype_name, n_q)
                worst = max(worst, err[0])
                print(f"[artifact] {name} {dtype_name:8s} {label:10s}: vs "
                      f"plain max abs {err[0]:.3g}; vs EtaMLP module max "
                      f"abs {ref_err[0]:.3g}")
    return worst


def phase_serving(rng):
    """→ kernel launches over the served requests."""
    import numpy as np
    import torch

    from routest_tpu_torch.core.config import Config, ServeConfig
    from routest_tpu_torch.data.features import encode_requests
    from routest_tpu_torch.ops.fused_mlp import (fused_eta_forward,
                                                 fused_eta_forward_plain)
    from routest_tpu_torch.serve.app import create_app
    from routest_tpu_torch.serve.ml_service import EtaService
    from routest_tpu_torch.serve.wsgi import make_server

    artifact = os.path.join(ROOT, "artifacts", "eta_mlp.msgpack")
    svc = EtaService(ServeConfig(), model_path=artifact, device="cuda")
    check(svc.available, f"EtaService not serving: {svc.load_error}")
    server = make_server(create_app(Config(), eta_service=svc), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_port
    n = 4096
    weather_pool = ["Cloudy", "Stormy", "Sunny", "Windy", "Fog"]
    traffic_pool = ["High", "Jam", "Low", "Medium", "Gridlock"]
    batch = {
        "distance_m": rng.uniform(200.0, 40_000.0, n).round(1).tolist(),
        "weather": [weather_pool[i] for i in rng.integers(0, 5, n)],
        "traffic": [traffic_pool[i] for i in rng.integers(0, 5, n)],
        "driver_age": rng.integers(18, 70, n).tolist(),
        "pickup_time": [f"2026-10-{12 + i % 7:02d}T{i % 24:02d}:15:00"
                        for i in range(n)],
    }
    try:
        fused_eta_forward.launches = 0
        status, ping = _request(port, "GET", "/api/ping")
        check(status == 200 and ping.get("ok") is True, f"ping: {status}")
        status, health = _request(port, "GET", "/api/health")
        check(status == 200 and health["status"] == "ok",
              f"health: {status} {health}")
        scoring = health["checks"]["model"]["scoring"]
        check(scoring["kernel"] == "cuda_fused", f"scoring: {scoring}")
        check(health["checks"]["engine"]["mesh"]["platform"] == "cuda",
              f"mesh: {health['checks']['engine']['mesh']}")
        status, one = _request(port, "POST", "/api/predict_eta", {
            "summary": {"distance": 12_500}, "weather": "Stormy",
            "traffic": "Jam", "pickup_time": "2026-10-16T08:30:00+08:00",
            "driver_age": 41})
        check(status == 200, f"predict_eta: {status} {one}")
        keys = {"eta_minutes_ml", "eta_completion_time_ml",
                "eta_minutes_ml_p10", "eta_minutes_ml_p90"}
        check(keys <= set(one), f"predict_eta keys: {sorted(one)}")
        check(np.isfinite(one["eta_minutes_ml"]) and
              one["eta_minutes_ml_p10"] <= one["eta_minutes_ml"]
              <= one["eta_minutes_ml_p90"], f"predict_eta band: {one}")
        check(dt.datetime.fromisoformat(one["eta_completion_time_ml"])
              .utcoffset() == dt.timedelta(hours=8), "completion offset lost")
        status, out = _request(port, "POST", "/api/predict_eta_batch", batch)
        check(status == 200 and out.get("count") == n,
              f"predict_eta_batch: {status}")
        eta = np.asarray(out["eta_minutes_ml"], np.float64)
        p10 = np.asarray(out["eta_minutes_ml_p10"], np.float64)
        p90 = np.asarray(out["eta_minutes_ml_p90"], np.float64)
        check(eta.shape == p10.shape == p90.shape == (n,)
              and len(out["eta_completion_time_ml"]) == n, "batch columns")
        check(np.isfinite(eta).all() and (p10 <= eta).all()
              and (eta <= p90).all(), "batch band or finiteness")
        status, items = _request(port, "POST", "/api/predict", {"items": [
            {"summary": {"distance": 3_000}, "weather": "Sunny"},
            {"summary": {"distance": 18_000}, "traffic": "High",
             "pickup_time": "2026-10-16T17:45:00"},
            {"distance_m": 950, "weather": "Fog", "driver_age": 63}]})
        check(status == 200 and items.get("count") == 3
              and all(np.isfinite(items["eta_minutes_ml"])),
              f"predict items: {status} {items}")
        launches = fused_eta_forward.launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(launches > 0, "the served requests launched no kernel")

    # The batch answer against the plain version on the same rows.
    pickups = [dt.datetime.fromisoformat(p) for p in batch["pickup_time"]]
    rows = encode_requests(
        weather=batch["weather"], traffic=batch["traffic"],
        weekday=[p.weekday() for p in pickups], hour=[p.hour for p in pickups],
        distance_km=[d / 1000.0 for d in batch["distance_m"]],
        driver_age=[float(a) for a in batch["driver_age"]])
    want = fused_eta_forward_plain(svc._packed, torch.from_numpy(rows).cuda(),
                                   n_q=3)[:, 1]
    err = compare(torch.from_numpy(eta), want.double(), "bfloat16", 0)
    print(f"[serving] ping/health/predict_eta/predict_eta_batch({n})/"
          f"predict(items) ok; scoring {scoring}; launches {launches}; "
          f"batch vs plain max abs {err[0]:.3g}")
    return launches


def phase_times(rng):
    """Per-bucket times for the served variant (bf16, quantile)."""
    import torch

    from routest_tpu_torch.ops.fused_mlp import (fused_eta_forward,
                                                 fused_eta_forward_plain,
                                                 pack_eta_params)
    from routest_tpu_torch.train.checkpoint import load_model

    model, params = load_model(os.path.join(ROOT, "artifacts",
                                            "eta_mlp.msgpack"))
    n_q = len(model.quantiles)
    packed = pack_eta_params(model, params, dtype="bfloat16", device="cuda")
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in packed["w"] + packed["b"])
    mac = sum(w.shape[0] * w.shape[1] for w in packed["w"])
    rows = []
    for b in SERVING_BUCKETS + SCALING_BATCHES:
        x = torch.from_numpy(random_rows(rng, b)).cuda()
        iters = max(20, min(2000, 200_000 // b))
        ms, enqueue_ms = time_ms(
            lambda: fused_eta_forward(packed, x, n_q=n_q), iters)
        plain_ms, _ = time_ms(
            lambda: fused_eta_forward_plain(packed, x, n_q=n_q), iters)
        flop_s = 2.0 * b * mac / H100_BF16_FLOPS
        byte_s = (b * 12 * 4 + b * n_q * 4 + weight_bytes) / H100_HBM_BYTES_S
        rows.append({"batch": b, "ms": ms, "enqueue_ms": enqueue_ms,
                     "plain_ms": plain_ms,
                     "bound_ms": max(flop_s, byte_s) * 1e3,
                     "bound_by": "operations" if flop_s >= byte_s else "bytes",
                     "serving_bucket": b in SERVING_BUCKETS})
        print(f"[times] batch {b:5d}: kernel {ms:.4f} ms (host enqueue "
              f"{enqueue_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
              f"{rows[-1]['bound_ms']:.6f} ms ({rows[-1]['bound_by']})")
    print(json.dumps({"timings": rows}))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    import routest_tpu_torch  # noqa: F401  (fails outside the checkout)

    # The plain version and the EtaMLP reference run on the card here:
    # keep their f32 matmuls in full f32 (TF32 keeps ~3 decimal digits,
    # which would loosen the f32 comparison below the kernel's error).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    phase = "device"
    try:
        name, smi_line = phase_device()
        phase = "build"
        phase_build()
        phase = "random"
        phase_random(rng)
        phase = "artifacts"
        max_err = phase_artifacts(rng)
        phase = "serving"
        launches = phase_serving(rng)
        phase = "times"
        rows = phase_times(rng)
    except Exception as e:
        print(f"chip_smoke: phase {phase} FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    # the 4096-row bucket the batch endpoint fills
    main_row = next(r for r in rows if r["batch"] == SERVING_BUCKETS[-1])
    print(json.dumps({"kernels": [{
        "name": "fused_eta_forward", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": max_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None, "batch": main_row["batch"]}]}))
    print(f"{smi_line}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
