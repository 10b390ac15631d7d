#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc``
(``$CUDA_HOME`` or ``/usr/local/cuda``) and ``nvidia-smi``. Phases, each
of which fails the run:

1. device: the card's name, and ``nvidia-smi``'s name and power limit;
2. build: compile every kernel of the ETA path from ``routest_tpu_torch/
   ops/csrc`` (into ``build/kernels/``); each variant's registers and
   spills from the compiler's report, and no spill allowed;
3. kernel vs its plain PyTorch version on the card, bf16, int8 and f32,
   point and quantile, at batches 0, 1, 7, 64, 4096 and 4099 of random
   rows with unknown categories, negative distances and out-of-range
   hours, with the batch's own tile and (tensor cores) the other one;
4. the shipped artifacts (``artifacts/eta_mlp.msgpack`` and
   ``eta_mlp_point.msgpack``) through the port's reader, every variant:
   kernel vs plain version, and vs the ``EtaMLP`` module as an
   independent reference;
5. serving: the port's app on a localhost port with ``EtaService`` on
   ``cuda``; ping, health, one ``/api/predict_eta``, one 4096-row
   columnar ``/api/predict_eta_batch`` and one ``items`` ``/api/predict``,
   checked for status, keys, finiteness, ``p10 <= eta <= p90``,
   agreement with the plain version, and the kernel's launch count over
   exactly these requests; then one 4096-row ``/api/predict_eta_batch``
   through an ``EtaService`` under ``RTPU_KERNEL_DTYPE=int8``, checked the
   same way;
6. optimize: the port's app with route optimization on ``cuda`` (matrix,
   greedy VRP, refiners, candidate ranking on the card; the ETA of each
   route through the fused kernel), 20 different bodies per kind:
   ``/api/optimize_route`` at 1, 3 and 10 stops, with ``refine`` (a
   capacity that splits trips), ``top_k: 5`` and ``use_ml_eta``;
   ``/api/optimize_route_batch`` with 256 ten-stop problems and
   ``use_ml_eta``; ``/api/matrix`` at 64 points; ``/api/history`` and
   ``/api/history/<id>`` of a route just saved. Every answer is held
   against the same app on the CPU (orders, trips, alternatives and
   geometry equal, distances within rtol 1e-5 plus the 0.1 rounding step,
   ETA fields finite with ``p10 <= eta <= p90``), the fused kernel must
   launch over the ``use_ml_eta`` requests, and each kind's median wall
   ms, host syncs per request (torch's sync debug mode) and the CPU
   path's median are printed;
7. road: ``road_graph: true`` through the port's app on ``cuda`` against
   the same app on the CPU, default deployment (generated 2048-node
   graph, road GNN, route transformer — both asserted live): 20 bodies
   per kind of ``/api/optimize_route`` at 1, 3 and 10 stops, with
   ``refine`` (capacity 4), ``top_k: 5`` and ``use_ml_eta``,
   ``/api/matrix`` at 64 points, and 3 of ``/api/optimize_route_batch``
   with 256 ten-stop problems and ``use_ml_eta``; orders, trips,
   alternatives, polylines and distances equal, durations within the
   bf16 class; solves bitwise and GNN edge times within the bf16 class
   against the CPU router; then the Manila arterials extract with its
   GNN (``ROAD_GRAPH_OSM``/``ROAD_GNN_PATH``) at 5 bodies per kind;
   solve ms per source bucket, sweeps and syncs per solve, GNN and
   transformer forward ms;
8. overlay: street routing at metro scale through the partition overlay
   (``HierarchicalIndex``). (a) The 8192-node metro extract at default
   knobs, a router on the card and one on the CPU: build time by stage
   (contraction, partition, each level, hub labels), the overlay's stats
   equal to the CPU build's, solves at 2, 16 and 64 sources bitwise the
   CPU router's (distances and predecessors), solve ms (CUDA events),
   ``timed_query`` stage ms, device kernels (``torch.profiler``), torch
   ops and host syncs per solve, and the same solves through the flat
   solver (``ROUTEST_HIER_MIN_NODES=0``) for comparison. (b) The metro
   extract as a deployment (``ROAD_GRAPH_OSM``): 10 stops, 10 stops with
   ``use_ml_eta``, 10 stops with ``top_k: 5`` and a 64-point matrix
   through the port's app on ``cuda`` against one on the CPU (as in
   phase 7), health reading ``"solver": "hierarchy"``. (c) A 50,066-node
   OSM-topology extract made here from seed 0 (``generate_road_graph(8543,
   k=4)``, two bends per street, 10% one-way, through ``save_osm`` /
   ``load_osm``): build time, cold and warm 16-source solves with stage
   ms, and every distance within 1e-6 relative of scipy's float64
   Dijkstra, reachability agreeing both ways; the flat solver's solve of
   the same sources beside them;
9. times at each serving bucket and two larger batches, per variant: the
   kernel's device time per launch (a CUDA graph of 20 launches, replayed,
   timed with CUDA events), for bf16 and int8 with 16- and 32-row
   tiles; back-to-back eager launches and the wrapper's host cost to
   enqueue one; the plain version; and the least time the card could
   take (``bound_ms``: the model's bytes at 3.35 TB/s or its operations
   at 989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32 CUDA cores — the
   H100 SXM data sheet);
10. live traffic, run between phases 8 and 9: (a) the metro overlay of
   phase 8 re-priced on the card and on the CPU path by one seeded
   probe stream (``ProbeFleet``, 160 drivers, 6 observations a tick,
   12 ticks on a fixed clock, a jammed west–east corridor) through the bus, the ingester and one
   ``MetricCustomizer.run_once``: the blended metrics, the customized
   index's payloads, live solves and ``_meters_along`` at 2, 16 and 64
   sources, and a 10-stop ``road_graph: true`` route under the live
   metric equal to the CPU path's bitwise; customize time against the
   full build, install time, live solve ms beside the distance-metric
   solve; (b) the default 2048-node router (GNN, transformer): the metric
   flipped on the card, the same metric installed on the CPU path, held
   the same way; (c) ``python -m routest_tpu_torch.serve`` with
   ``RTPU_LIVE=1`` on the card: 20 ``/api/probe`` posts, ``/api/live``
   to epoch >= 1, 5 ``use_ml_eta`` road routes priced ``live+`` with the
   fused kernel's launches over them (health's
   ``checks.model.scoring.launches``), a seeded ``/api/confirm_route``
   read back over ``/api/realtime_feed`` and resumed with
   ``Last-Event-ID``;
11. dispatch, run between phases 10 and 9: (a) drains of 1, 4, 16 and
   64 problems at 12 and 32 stops (``scripts/bench_dispatch.py``'s
   recipe; one problem in four with windows, stops over capacity and
   unreachable, one non-zero diagonal) through
   ``solve_host_dispatch_batch`` on the card, every plan bitwise the CPU
   path's, with ms per drain, solves/s, host syncs, kernels and torch
   ops per drain and the CPU path's ms; (b) an app on the card against
   one on the CPU: 64 concurrent matrix-mode ``/api/dispatch`` requests
   (the batcher must merge some), 10 geographic 20-stop requests with
   windows, confirm / complete / complete (404), ``/api/confirm_route``
   with lat/lon stops (a ``dispatch_id``); (c) on phase 10's default
   router, a corridor flowing then jammed (``_live_flip``): one
   ``ReoptLoop.tick()`` re-solves exactly the dispatch along the
   corridor, not the one far from it, its ``plan_update`` arrives on its
   channel and equals the CPU path's; (d) the pages (``/``, ``/ui``,
   ``/health``, ``/lib/*.js``, ``/up``) and ops routes (``/api/version``,
   ``/api/metrics``, both formats) answer as the CPU app's;
12. the serving core, run between phases 11 and 9: (a) with
   ``RTPU_WIRE=1``, seeded 4096- and 131,072-row batches as RTW1 frames
   over HTTP and over the multiplexed channel, minutes, bands and
   completion stamps bitwise the JSON path's on the same rows (1 and 32
   fused launches), a malformed frame's 400 error frame, the 415 with
   wire off, median ms per 4096-row request by transport, and
   ``python -m routest_tpu_torch.serve`` answering over its own
   channel; (b) ``eta_mlp_point.msgpack`` served with
   ``ROUTEST_RELOAD_SEC=0.2`` under 8 threads of ``/api/predict_eta``,
   replaced atomically by ``eta_mlp.msgpack``: no failed or torn answer,
   every answer after the flip banded, then a truncated copy rejected,
   and the golden-batch gate's launches; (c) ``use_ml_eta`` optimize
   writes through ``tests/fake_postgrest.py``, the fake stopped (writes
   journaled, history degraded) and restarted with its rows: every
   acknowledged write read back, the store's op medians; (d)
   ``ROUTEST_AUTH=require``: register, login, the DELETE gate, the
   Sanctum cookies; (e) the road GNN swapped: a foreign and a truncated
   artifact refused, a re-install and a Manila install accepted;
13. training, run between phases 12 and 9: (a) ``fit`` of the default
   ``EtaMLP`` (bf16 compute) at ``scripts/train_eta.py``'s defaults
   (500,000 rows, seed 0, 30 epochs) on the card, eval RMSE ≤ the
   committed CPU baseline (``artifacts/baseline.json``, same 450k/50k
   split) × 1.02, steps per second, and one step's kernels, copies and
   syncs; (b) ``python -m routest_tpu_torch.train --quantiles
   0.1,0.5,0.9`` at the same defaults, RMSE ≤ baseline × 1.10 and each
   coverage within ±0.02 of its level, its artifact through the fused
   kernel in bf16 and int8 against the plain version and served by an
   ``EtaService`` on the card (fused launches counted); (c) 20 F32 steps
   from one init on the same batches on the card and on the CPU path,
   params within rtol 1e-4 / atol 1e-6 (TF32 off); (d) ``python -m
   routest_tpu_torch.serve`` with ``ETA_MODEL_PATH`` at a missing file:
   it trains the bootstrap (200,000 rows, 15 epochs) on the card, writes
   it and answers ``/api/predict_eta`` and ``/api/predict_eta_batch``
   through the fused kernel (launches from its log lines); (e) the GNN
   and route-transformer trainers at their scripts' defaults on
   ``generate_road_graph(2048, seed 0)``, each beating naive physics,
   both artifacts live on a router through the fingerprint gate; (f) one
   ``ContinuousTrainer.run_once`` on the default router (its GNN on a
   temp path) with phase 10's seeded fleet, and the router's verified
   swap changing its edge times; (g) a seeded 300-tree XGBoost JSON
   (depth up to 8, NaN in 1% of rows) through ``EtaService`` on the card
   and on the CPU path at 4096 rows: leaf cursors bitwise, predictions
   within 1e-6 relative, ms per batch;
14. observability, run between phases 13 and 9: (a) ``python -m
   routest_tpu_torch.serve`` on the card with tracing sampled at 1.0, a
   device-trace directory, a 2 s / 10 s SLO, a recorder directory,
   ``RTPU_PROFILE_DEVICE=1`` and ``store.http`` failing: a 4096-row
   ``/api/predict_eta_batch`` sent with a ``traceparent`` carries one
   trace id from ``replica.request`` down to ``batcher.device_compute``,
   whose ``torch.profiler`` trace names the fused kernel (its device ms
   and the host↔device copies printed beside the span's ms), a 64-row
   request runs through ``fastlane.predict``, and untraced 4096-row
   requests give the span split; (d) a hot swap records ``model.swap``,
   a burst of journaled writes pages the store SLO, and the one
   ``slo_page`` bundle and ``/api/incidents`` rank the swap among the
   suspects; (b) ``/api/efficiency``'s ``eta_score`` rows and padding
   per bucket are what was sent, a road route and a dispatch reach
   ``route_solve`` / ``dispatch_solve``, the watchdog reads
   ``no_artifact`` (health too); (e) ``POST /api/debug/profile`` writes
   ``profile.folded`` and a device trace naming the kernel; then in this
   process (c) ``device.compute:error=1@2``: two 503s as the JAX app
   answers, no launch, the third answer bitwise the fault-free one, and
   ``store.http`` errors against ``tests/fake_postgrest.py`` journaled
   and read back; (f) ``python -m routest_tpu_torch.train.export`` on
   ``eta_mlp.msgpack``, served from ``ETA_MODEL_PATH`` as
   ``torch_export`` without a fused launch, within the bf16
   kernel-vs-plain tolerance of the kernel-served artifact and bitwise
   the program before saving; (g) single-row ``/api/predict_eta`` p95
   with tracing off, at the default sample rate and at 1.0, in a fresh
   process (a record).

The lines before the last are one ``{"optimize": {...}}``, one
``{"road": {...}}``, one ``{"overlay": {...}}``, one ``{"live": {...}}``,
one ``{"dispatch": {...}}``, one ``{"serving_core": {...}}``, one
``{"train": {...}}``, one ``{"observability": {...}}`` and one
``{"kernels": [...]}`` JSON object and the
card's name and power limit; the last line is
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
VARIANTS = ("bfloat16", "int8", "float32")
# (rtol, atol) against an independent reference — the classes of
# tests/test_ops_fused.py: f32 differs only in summation order; bf16 may
# also flip one rounding of a hidden activation; int8 adds per-column
# 8-bit weights.
TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 0.5), "int8": (5e-2, 1.5)}
# Kernel vs its plain version on the same packing: int8 dequantizes to
# bf16 in both, so the arithmetic, and the class, is bf16's.
PLAIN_TOL = dict(TOL, int8=TOL["bfloat16"])
# Peak rates of the units each variant runs on (H100 SXM data sheet):
# bf16 and int8 (dequantized to bf16) on the dense tensor cores, f32 on
# the CUDA cores.
PEAK_FLOPS = {"bfloat16": 989e12, "int8": 989e12, "float32": 67e12}
H100_HBM_BYTES_S = 3.35e12
KERNEL_SOURCE = "routest_tpu_torch/ops/csrc/fused_eta.cu"
REPLACES = "routest_tpu/ops/fused_mlp.py:366"
# The {"kernels": [...]} entry of each served variant.
KERNEL_NAMES = {"bfloat16": "fused_eta_forward",
                "int8": "fused_eta_forward_int8"}


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


def compare(got, want, tol, n_q):
    """→ (max_abs, max_rel); raises on a shape, finiteness, ``(rtol,
    atol)`` or non-crossing failure."""
    import numpy as np

    got = got.float().cpu().numpy()
    want = want.float().cpu().numpy()
    check(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    if got.size == 0:
        return 0.0, 0.0
    check(np.isfinite(got).all(), "non-finite kernel output")
    rtol, atol = tol
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


def graph_ms(fn, reps=20, replays=10):
    """→ device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events. With no host
    work between launches this is the kernel's own time (plus the
    graph's launch gap), where back-to-back eager launches would measure
    the wrapper's host cost whenever that is the longer of the two."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


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


# Compiled kernels by mangled-name fragment → (variant, rows per block).
KERNEL_SYMBOLS = {"fused_eta_tc_kernelILb0ELi16E": ("bfloat16", 16),
                  "fused_eta_tc_kernelILb1ELi16E": ("int8", 16),
                  "fused_eta_tc_kernelILb0ELi32E": ("bfloat16", 32),
                  "fused_eta_tc_kernelILb1ELi32E": ("int8", 32),
                  "fused_eta_f32_kernel": ("float32", 32)}
# Bytes of one stored weight element, per variant.
WEIGHT_BYTES = {"bfloat16": 2, "int8": 1, "float32": 4}


def phase_build():
    """Build, load, and read each compiled kernel's registers and spills
    off ``-Xptxas -v`` (this build's, or the one kept with the library
    when it was already built); a spill fails the phase."""
    import re

    from routest_tpu_torch.ops import build

    t0 = time.perf_counter()
    path, report = build.build("fused_eta")
    build.load_library()
    print(f"[build] fused_eta in {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(path, ROOT)}")
    check("Compiling entry function" in report, "no compiler report")
    current = None
    seen = {}
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            current = next((v for k, v in KERNEL_SYMBOLS.items()
                            if k in entry.group(1)), None)
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            seen.setdefault(current, {})["spills"] = (
                int(spill.group(1)) + int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            seen.setdefault(current, {})["registers"] = int(regs.group(1))
    check(set(seen) == set(KERNEL_SYMBOLS.values()),
          f"compiler report names {sorted(seen)}")
    for (variant, tile), info in sorted(seen.items()):
        print(f"[build]   {variant:8s} {tile}-row tile: "
              f"{info.get('registers')} registers, "
              f"{info.get('spills')} bytes spilled")
        check(info.get("spills") == 0, f"{variant}/{tile} spills registers")


def phase_random(rng):
    """→ {variant: max abs kernel-vs-plain error}."""
    import torch

    from routest_tpu_torch.ops.fused_mlp import (_TILES, fused_eta_forward,
                                                 fused_eta_forward_plain,
                                                 pack_eta_params)

    worst = dict.fromkeys(VARIANTS, 0.0)
    for n_q in (0, 3):
        params = random_params(rng, 2 * max(1, n_q))
        for dtype_name in VARIANTS:
            packed = pack_eta_params(None, params, dtype=dtype_name,
                                     device="cuda")
            # the batch's own tile, then (tensor cores) each tile by name
            tiles = (None,) if dtype_name == "float32" else (None,) + _TILES
            err_v = (0.0, 0.0)
            for b in PHASE3_BATCHES:
                x = torch.from_numpy(random_rows(rng, b)).cuda()
                want = fused_eta_forward_plain(packed, x, n_q=n_q)
                for tile in tiles:
                    got = fused_eta_forward(packed, x, n_q=n_q, tile=tile)
                    torch.cuda.synchronize()
                    check(tuple(got.shape) == ((b, n_q) if n_q else (b,)),
                          f"batch {b}: shape {tuple(got.shape)}")
                    err = compare(got, want, PLAIN_TOL[dtype_name], n_q)
                    err_v = max(err_v[0], err[0]), max(err_v[1], err[1])
            worst[dtype_name] = max(worst[dtype_name], err_v[0])
            print(f"[random] {dtype_name:8s} n_q={n_q} batches "
                  f"{PHASE3_BATCHES}, tiles {tiles}: max abs err "
                  f"{err_v[0]:.3g}, max rel err {err_v[1]:.3g} (tol "
                  f"rtol/atol {PLAIN_TOL[dtype_name]})")
    return worst


def phase_artifacts(rng):
    """→ {variant: max abs kernel-vs-plain error} over the shipped
    artifacts."""
    import dataclasses

    import torch

    from routest_tpu_torch.ops.fused_mlp import (fused_eta_forward,
                                                 fused_eta_forward_plain,
                                                 pack_eta_params)
    from routest_tpu_torch.serve.ml_service import golden_batch
    from routest_tpu_torch.train.checkpoint import load_model

    worst = dict.fromkeys(VARIANTS, 0.0)
    for name in ("eta_mlp.msgpack", "eta_mlp_point.msgpack"):
        model, params = load_model(os.path.join(ROOT, "artifacts", name))
        n_q = len(model.quantiles)
        inputs = {"golden": golden_batch(), "random4096": random_rows(rng, 4096)}
        for dtype_name in VARIANTS:
            packed = pack_eta_params(model, params, dtype=dtype_name,
                                     device="cuda")
            # the module computes int8's reference in f32, as the JAX
            # tests hold the int8 kernel to an f32 model
            reference = model.to("cuda")
            reference.policy = dataclasses.replace(
                model.policy, compute_dtype=torch.float32
                if dtype_name == "int8" else getattr(torch, dtype_name))
            for label, rows in inputs.items():
                x = torch.from_numpy(rows).cuda()
                got = fused_eta_forward(packed, x, n_q=n_q)
                err = compare(got, fused_eta_forward_plain(packed, x, n_q=n_q),
                              PLAIN_TOL[dtype_name], n_q)
                with torch.no_grad():
                    ref = (reference.apply_quantiles(x) if n_q
                           else reference(x))
                ref_err = compare(got, ref, TOL[dtype_name], n_q)
                worst[dtype_name] = max(worst[dtype_name], err[0])
                print(f"[artifact] {name} {dtype_name:8s} {label:10s}: vs "
                      f"plain max abs {err[0]:.3g}; vs EtaMLP module max "
                      f"abs {ref_err[0]:.3g}")
    return worst


class _Server:
    """The port's app around ``svc`` on a localhost port, in a thread
    (route optimization on ``config.serve.device``, cuda by default)."""

    def __init__(self, svc, config=None):
        from routest_tpu_torch.core.config import Config
        from routest_tpu_torch.serve.app import create_app
        from routest_tpu_torch.serve.wsgi import make_server

        self.app = create_app(config or Config(), eta_service=svc)
        self.server = make_server(self.app, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.port = self.server.server_port

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        # the app's background threads: the dispatch re-optimization
        # loop, the SLO and timeline tickers, the change-ledger tap
        self.app.close()


def _batch_rows(batch):
    """The ABI rows the port encodes for a columnar batch body."""
    from routest_tpu_torch.data.features import encode_requests

    pickups = [dt.datetime.fromisoformat(p) for p in batch["pickup_time"]]
    return encode_requests(
        weather=batch["weather"], traffic=batch["traffic"],
        weekday=[p.weekday() for p in pickups], hour=[p.hour for p in pickups],
        distance_km=[d / 1000.0 for d in batch["distance_m"]],
        driver_age=[float(a) for a in batch["driver_age"]])


def _check_batch(out, n):
    """→ the ETA column of a 4096-row /api/predict_eta_batch answer,
    after checking its columns, finiteness and band."""
    import numpy as np

    eta = np.asarray(out["eta_minutes_ml"], np.float64)
    p10 = np.asarray(out["eta_minutes_ml_p10"], np.float64)
    p90 = np.asarray(out["eta_minutes_ml_p90"], np.float64)
    check(eta.shape == p10.shape == p90.shape == (n,)
          and len(out["eta_completion_time_ml"]) == n, "batch columns")
    check(np.isfinite(eta).all() and (p10 <= eta).all()
          and (eta <= p90).all(), "batch band or finiteness")
    return eta


def phase_serving(rng):
    """→ {variant: kernel launches over its served requests}."""
    import numpy as np
    import torch

    from routest_tpu_torch.core.config import ServeConfig
    from routest_tpu_torch.ops.fused_mlp import (fused_eta_forward,
                                                 fused_eta_forward_plain)
    from routest_tpu_torch.serve.ml_service import EtaService

    artifact = os.path.join(ROOT, "artifacts", "eta_mlp.msgpack")
    os.environ.pop("RTPU_KERNEL_DTYPE", None)
    svc = EtaService(ServeConfig(), model_path=artifact, device="cuda")
    check(svc.available, f"EtaService not serving: {svc.load_error}")
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
    rows = torch.from_numpy(_batch_rows(batch)).cuda()
    launches = {}
    with _Server(svc) as srv:
        port = srv.port
        fused_eta_forward.launches = 0
        status, ping = _request(port, "GET", "/api/ping")
        check(status == 200 and ping.get("ok") is True, f"ping: {status}")
        status, health = _request(port, "GET", "/api/health")
        check(status == 200 and health["status"] == "ok",
              f"health: {status} {health}")
        scoring = health["checks"]["model"]["scoring"]
        check(scoring["kernel"] == "cuda_fused"
              and scoring["dtype"] == "bfloat16", f"scoring: {scoring}")
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
        eta = _check_batch(out, n)
        status, items = _request(port, "POST", "/api/predict", {"items": [
            {"summary": {"distance": 3_000}, "weather": "Sunny"},
            {"summary": {"distance": 18_000}, "traffic": "High",
             "pickup_time": "2026-10-16T17:45:00"},
            {"distance_m": 950, "weather": "Fog", "driver_age": 63}]})
        check(status == 200 and items.get("count") == 3
              and all(np.isfinite(items["eta_minutes_ml"])),
              f"predict items: {status} {items}")
        launches["bfloat16"] = fused_eta_forward.launches
    check(launches["bfloat16"] > 0, "the served requests launched no kernel")
    # the batch answer against the plain version on the same rows
    want = fused_eta_forward_plain(svc._packed, rows, n_q=3)[:, 1]
    err = compare(torch.from_numpy(eta), want.double(),
                  PLAIN_TOL["bfloat16"], 0)
    print(f"[serving] bf16: ping/health/predict_eta/predict_eta_batch({n})/"
          f"predict(items) ok; scoring {scoring}; launches "
          f"{launches['bfloat16']}; batch vs plain max abs {err[0]:.3g}")

    os.environ["RTPU_KERNEL_DTYPE"] = "int8"
    try:
        svc8 = EtaService(ServeConfig(), model_path=artifact, device="cuda")
    finally:
        os.environ.pop("RTPU_KERNEL_DTYPE", None)
    check(svc8.available, f"int8 EtaService not serving: {svc8.load_error}")
    with _Server(svc8) as srv:
        status, health = _request(srv.port, "GET", "/api/health")
        scoring8 = health["checks"]["model"]["scoring"]
        check(status == 200 and scoring8["kernel"] == "cuda_fused"
              and scoring8["dtype"] == "int8", f"int8 scoring: {scoring8}")
        fused_eta_forward.launches = 0
        status, out = _request(srv.port, "POST", "/api/predict_eta_batch",
                               batch)
        launches["int8"] = fused_eta_forward.launches
        check(status == 200 and out.get("count") == n,
              f"int8 predict_eta_batch: {status}")
        eta8 = _check_batch(out, n)
    check(launches["int8"] > 0, "the int8 request launched no kernel")
    want8 = fused_eta_forward_plain(svc8._packed, rows, n_q=3)[:, 1]
    err8 = compare(torch.from_numpy(eta8), want8.double(),
                   PLAIN_TOL["int8"], 0)
    print(f"[serving] int8: predict_eta_batch({n}) ok; scoring {scoring8}; "
          f"launches {launches['int8']}; batch vs plain max abs "
          f"{err8[0]:.3g}; vs the bf16 service max abs "
          f"{float(np.abs(eta8 - eta).max()):.3g} (not a check)")
    return launches


# Requests per kind in the optimize phase (each body different, so the
# ETA fast lane cannot answer a repeat from its cache).
OPT_REPS = 20
# Requests per kind replayed under torch's sync debug mode to count host
# syncs.
SYNC_REPS = 3
# Response values that are rounded distances/durations (rtol 1e-5 plus
# the 0.1 rounding step): their key, or a matrix row of one.
_ROUNDED_KEYS = ("distance", "duration")
_ROUNDED_ROWS = ("distances_m[", "durations_s[")


def _opt_point(i):
    from routest_tpu_torch.data.locations import SEED_LOCATIONS

    name, lat, lon = SEED_LOCATIONS[i]
    return {"lat": lat, "lon": lon, "payload": 1, "name": name}


def _opt_body(stops, rep, capacity=9999, **extra):
    """A route from the warehouse to ``stops`` of the 20 malls, a
    different subset for each ``rep`` (3 is prime to 20: no repeats)."""
    from routest_tpu_torch.data.locations import SEED_LOCATIONS

    body = {"source_point": {"lat": SEED_LOCATIONS[0][1],
                             "lon": SEED_LOCATIONS[0][2]},
            "destination_points": [_opt_point(1 + (rep + 3 * j) % 20)
                                   for j in range(stops)],
            "driver_details": {"driver_name": f"driver-{rep}",
                               "vehicle_type": "car",
                               "vehicle_capacity": capacity,
                               "maximum_distance": 150_000.0,
                               "driver_age": 25 + rep}}
    body.update(extra)
    return body


def _opt_batch(rep):
    """256 ten-stop problems (``MAX_BATCH_PROBLEMS``), seeded per rep."""
    import numpy as np

    rng = np.random.default_rng(1000 + rep)
    items = []
    for i in range(256):
        body = _opt_body(10, 0)
        body["destination_points"] = [
            _opt_point(int(j)) for j in 1 + rng.permutation(20)[:10]]
        body["driver_details"]["driver_age"] = 20 + i % 50
        items.append(body)
    return {"items": items, "use_ml_eta": True,
            "context": {"weather": ["Sunny", "Cloudy", "Stormy"][rep % 3],
                        "traffic": "High"}}


def _opt_matrix(rep):
    """64 points (``MAX_MATRIX_POINTS``) across Metro Manila."""
    import numpy as np

    rng = np.random.default_rng(2000 + rep)
    return {"points": [{"lat": 14.40 + 0.26 * float(a),
                        "lon": 120.96 + 0.14 * float(b)}
                       for a, b in rng.random((64, 2))],
            "vehicle_type": "truck" if rep % 2 else "car"}


_ML = {"use_ml_eta": True, "context": {"weather": "Stormy",
                                       "traffic": "Jam"}}
# kind → (path, body for rep r, is a use_ml_eta request)
OPT_KINDS = {
    "route_1_stop": ("/api/optimize_route", lambda r: _opt_body(1, r),
                     False),
    "route_3_stops": ("/api/optimize_route", lambda r: _opt_body(3, r),
                      False),
    "route_10_stops": ("/api/optimize_route", lambda r: _opt_body(10, r),
                       False),
    "route_10_stops_refine": ("/api/optimize_route", lambda r: _opt_body(
        10, r, capacity=4, refine=True), False),
    "route_10_stops_top_k5": ("/api/optimize_route", lambda r: _opt_body(
        10, r, top_k=5), False),
    "route_10_stops_ml_eta": ("/api/optimize_route", lambda r: _opt_body(
        10, r, **_ML), True),
    "route_3_stops_ml_eta": ("/api/optimize_route", lambda r: _opt_body(
        3, r, **_ML), True),
    "batch_256x10_ml_eta": ("/api/optimize_route_batch", _opt_batch, True),
    "matrix_64": ("/api/matrix", _opt_matrix, False),
}


def _same_answer(got, want, path=""):
    """The card's answer against the port's CPU path: equal keys, orders,
    trip counts, alternatives, geometry and errors; distances and
    durations within rtol 1e-5 (plus the response's 0.1 rounding step);
    ETA fields finite with p10 <= eta <= p90 (their values come from
    the bf16 kernel on the card and f32 on the CPU: not compared); fresh
    request ids; the engine tag naming each device."""
    import math

    key = path.rsplit(".", 1)[-1]
    if isinstance(want, dict):
        check(isinstance(got, dict) and set(got) == set(want),
              f"{path}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            _same_answer(got[k], want[k], f"{path}.{k}")
        if "eta_minutes_ml_p10" in got:
            check(got["eta_minutes_ml_p10"] <= got["eta_minutes_ml"]
                  <= got["eta_minutes_ml_p90"], f"{path}: ETA band")
    elif isinstance(want, list):
        check(isinstance(got, list) and len(got) == len(want),
              f"{path}: length")
        for i, (g, w) in enumerate(zip(got, want)):
            _same_answer(g, w, f"{path}[{i}]")
    elif key == "engine":
        check((got, want) == ("backend:torch-cuda", "backend:torch-cpu"),
              f"{path}: {got}")
    elif key in ("request_id", "eta_completion_time_ml"):
        check(isinstance(got, str) and got, f"{path}: {got!r}")
    elif key.startswith("eta_minutes_ml"):
        check(isinstance(got, float) and math.isfinite(got),
              f"{path}: {got!r}")
    elif isinstance(want, float) and (key in _ROUNDED_KEYS or any(
            r in path for r in _ROUNDED_ROWS)):
        check(abs(got - want) <= 1e-5 * abs(want) + 0.1 + 1e-9,
              f"{path}: {got} vs {want}")
    else:
        check(got == want, f"{path}: {got!r} != {want!r}")


def _kind_path(kind):
    return (OPT_KINDS.get(kind) or ROAD_KINDS[kind])[0]


def _serve_kinds(port, bodies):
    """→ {kind: ([answers], [wall ms])}, one HTTP request per body."""
    out = {}
    for kind in bodies:
        path = _kind_path(kind)
        answers, times = [], []
        for body in bodies[kind]:
            t0 = time.perf_counter()
            status, answer = _request(port, "POST", path, body)
            times.append((time.perf_counter() - t0) * 1e3)
            check(status == 200, f"{kind}: HTTP {status} {answer}")
            answers.append(answer)
        out[kind] = (answers, times)
    return out


def _count_syncs(port, bodies):
    """→ {kind: host syncs per request}, from torch's sync debug mode
    ("warn": one warning per synchronizing CUDA call, raised on the
    server's handler thread, recorded by the process-wide warnings
    hook)."""
    import warnings

    import torch

    per_kind = {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for kind, kind_bodies in bodies.items():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for body in kind_bodies:
                    status, _ = _request(port, "POST", _kind_path(kind),
                                         body)
                    check(status == 200, f"{kind}: HTTP {status}")
            n = sum("synchronizing CUDA operation" in str(w.message)
                    for w in caught)
            per_kind[kind] = n / len(kind_bodies)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return per_kind


def _engine_call(kind, body, device):
    """The engine entry point behind ``kind``'s endpoint, called
    directly (no HTTP, no ETA, no store)."""
    from routest_tpu_torch.optimize import engine

    path = _kind_path(kind)
    if path == "/api/optimize_route_batch":
        return engine.optimize_route_batch(body["items"], device=device)
    if path == "/api/matrix":
        return engine.travel_matrix(body, device=device)
    return engine.optimize_route(body, device=device)


def _engine_ms(bodies, device, new_thread=False):
    """→ {kind: median wall ms of the engine call} on ``device``, each
    call on this thread or (``new_thread``) on a thread of its own, as
    the server runs each request."""
    out = {}
    for kind, kind_bodies in bodies.items():
        times = []
        for body in kind_bodies:
            t0 = time.perf_counter()
            if new_thread:
                worker = threading.Thread(target=_engine_call,
                                          args=(kind, body, device))
                worker.start()
                worker.join()
            else:
                _engine_call(kind, body, device)
            times.append((time.perf_counter() - t0) * 1e3)
        out[kind] = _median(times)
    return out


def _median(values):
    import statistics

    return statistics.median(values)


def phase_optimize():
    """Route optimization through the port's app on the card (matrix,
    solve, refine, ranking and assembly on cuda; ETA through the fused
    kernel), held against the same app on the CPU. → (records per kind,
    kernel launches over the use_ml_eta requests)."""
    from routest_tpu_torch.core.config import Config, ServeConfig
    from routest_tpu_torch.ops.fused_mlp import fused_eta_forward
    from routest_tpu_torch.serve.ml_service import EtaService

    artifact = os.path.join(ROOT, "artifacts", "eta_mlp.msgpack")
    os.environ.pop("RTPU_KERNEL_DTYPE", None)
    # distinct bodies for the timed run, the warm-up and the sync count
    bodies = {kind: [make(r) for r in range(OPT_REPS)]
              for kind, (_, make, _) in OPT_KINDS.items()}
    warm = {kind: [make(OPT_REPS)] for kind, (_, make, _) in
            OPT_KINDS.items()}
    sync_bodies = {kind: [make(OPT_REPS + 1 + r) for r in range(SYNC_REPS)]
                   for kind, (_, make, _) in OPT_KINDS.items()}

    cpu_svc = EtaService(ServeConfig(device="cpu"), model_path=artifact,
                         device="cpu")
    with _Server(cpu_svc, Config(serve=ServeConfig(device="cpu"))) as srv:
        _serve_kinds(srv.port, warm)
        on_cpu = _serve_kinds(srv.port, bodies)
    engine_cpu = _engine_ms(bodies, "cpu")

    svc = EtaService(ServeConfig(), model_path=artifact, device="cuda")
    check(svc.available, f"EtaService not serving: {svc.load_error}")
    launches = {}
    with _Server(svc) as srv:
        _serve_kinds(srv.port, warm)
        on_card = {}
        for kind in OPT_KINDS:
            fused_eta_forward.launches = 0
            on_card.update(_serve_kinds(srv.port, {kind: bodies[kind]}))
            launches[kind] = fused_eta_forward.launches
        syncs = _count_syncs(srv.port, sync_bodies)

        # history: a route just saved on the card, listed and read back
        status, fresh = _request(srv.port, "POST", "/api/optimize_route",
                                 _opt_body(10, 2 * OPT_REPS, **_ML))
        check(status == 200 and fresh["properties"].get("saved") is True,
              f"optimize_route to save: {status}")
        saved = fresh["properties"]
        h_times, d_times = [], []
        for _ in range(OPT_REPS):
            t0 = time.perf_counter()
            status, listing = _request(srv.port, "GET",
                                       "/api/history?limit=20&engine=ml")
            h_times.append((time.perf_counter() - t0) * 1e3)
            check(status == 200 and 0 < len(listing["items"]) <= 20,
                  f"history: {status}")
            t0 = time.perf_counter()
            status, detail = _request(srv.port, "GET",
                                      f"/api/history/{saved['request_id']}")
            d_times.append((time.perf_counter() - t0) * 1e3)
            check(status == 200, f"history detail: {status}")
        first = listing["items"][0]
        check(first["request_id"] == saved["request_id"]
              and first["engine"] == "ml"
              and first["eta_minutes_ml"] == saved["eta_minutes_ml"],
              f"history head: {first}")
        check(detail["result"]["optimized_order"] == saved["optimized_order"]
              and detail["request"]["id"] == saved["request_id"],
              "history detail does not read back the saved route")

    # the engine alone, on this thread and on a fresh thread per call
    _engine_ms(warm, "cuda")
    engine_card = _engine_ms(bodies, "cuda")
    threaded = ("route_1_stop", "route_10_stops")
    engine_thread = _engine_ms({k: bodies[k] for k in threaded}, "cuda",
                               new_thread=True)

    records = {}
    for kind, (_, _, ml) in OPT_KINDS.items():
        card_answers, card_ms = on_card[kind]
        cpu_answers, cpu_ms = on_cpu[kind]
        for got, want in zip(card_answers, cpu_answers):
            _same_answer(got, want, kind)
        records[kind] = {"requests": OPT_REPS,
                         "median_ms": _median(card_ms),
                         "p90_ms": sorted(card_ms)[int(0.9 * OPT_REPS) - 1],
                         "cpu_median_ms": _median(cpu_ms),
                         "syncs_per_request": syncs[kind],
                         "kernel_launches": launches[kind],
                         "engine_ms": engine_card[kind],
                         "engine_cpu_ms": engine_cpu[kind]}
        if kind in engine_thread:
            records[kind]["engine_new_thread_ms"] = engine_thread[kind]
        if ml:
            check(launches[kind] > 0, f"{kind}: no fused kernel launch")
    records["history_list"] = {"requests": OPT_REPS,
                               "median_ms": _median(h_times)}
    records["history_detail"] = {"requests": OPT_REPS,
                                 "median_ms": _median(d_times)}
    batch = on_card["batch_256x10_ml_eta"][0][0]
    check(batch["count"] == 256 and all(
        "eta_minutes_ml" in it["properties"] for it in batch["items"]),
        "batch: an item without its ETA")
    alts = on_card["route_10_stops_top_k5"][0][0]["properties"]
    check(len(alts["alternatives"]) == 5, "top_k 5: alternatives")
    for kind, r in records.items():
        extra = ("" if "cpu_median_ms" not in r else
                 f"; syncs/request {r['syncs_per_request']:.1f}; fused "
                 f"launches {r['kernel_launches']}; port on the CPU "
                 f"{r['cpu_median_ms']:.2f} ms; engine alone "
                 f"{r['engine_ms']:.2f} ms (CPU {r['engine_cpu_ms']:.2f})")
        print(f"[optimize] {kind:24s} cuda median {r['median_ms']:.2f} ms "
              f"over {r['requests']}{extra}")
    print(json.dumps({"optimize": records}))
    return records, sum(launches[k] for k, (_, _, ml) in OPT_KINDS.items()
                        if ml)


# Requests per road kind (each body different; the batch, 256 ten-stop
# problems, takes seconds on the CPU path, so it repeats less).
ROAD_REPS = 20
ROAD_BATCH_REPS = 3
# Requests per kind through the real-data deployment.
MANILA_REPS = 5
# Source-row buckets of the solve timings (a 1-stop route solves 2 rows,
# the 64-point matrix 64 → its 32-row batcher chunks, a 10-stop route 11
# → 16).
SOLVE_BUCKETS = (2, 16, 32)
# Card vs CPU path: durations (GNN in bf16 on the card, f32 on the CPU)
# within the bf16 class plus the response's 0.1 rounding step.
ROAD_DURATION_RTOL = 2e-2
MANILA_OSM = "artifacts/manila_arterials.osm.gz"
MANILA_GNN = "artifacts/road_gnn_manila.msgpack"
METRO_OSM = "artifacts/metro_8192.osm.gz"


def _road_body(stops, rep, shift=0, capacity=9999, **extra):
    """A road-graph route: ``_opt_body``'s stops, priced at a pickup
    hour that moves with ``rep`` (so the GNN prices new hours on the
    card as requests arrive). Kinds with the same stops take different
    ``shift``s of the hour, so no kind is answered from another's
    solved routes in the route cache (its key holds the hour)."""
    body = _opt_body(stops, rep, capacity, **extra)
    body.update(road_graph=True, pickup_time=(
        f"2026-10-14T{(6 + rep + shift) % 24:02d}:30:00"))
    return body


def _road_batch(rep):
    body = _opt_batch(rep)
    for item in body["items"]:
        item.update(road_graph=True, pickup_time="2026-10-14T08:30:00")
    return body


def _road_matrix(rep):
    body = _opt_matrix(rep)
    body.update(road_graph=True,
                pickup_time=f"2026-10-14T{(7 + rep) % 24:02d}:00:00")
    return body


# kind → (path, body for rep r, is a use_ml_eta request)
ROAD_KINDS = {
    "road_1_stop": ("/api/optimize_route", lambda r: _road_body(1, r),
                    False),
    "road_3_stops": ("/api/optimize_route", lambda r: _road_body(3, r),
                     False),
    "road_10_stops": ("/api/optimize_route", lambda r: _road_body(10, r),
                      False),
    "road_10_stops_refine": ("/api/optimize_route", lambda r: _road_body(
        10, r, 1, capacity=4, refine=True), False),
    "road_10_stops_top_k5": ("/api/optimize_route", lambda r: _road_body(
        10, r, 2, top_k=5), False),
    "road_10_stops_ml_eta": ("/api/optimize_route", lambda r: _road_body(
        10, r, 3, **_ML), True),
    "road_matrix_64": ("/api/matrix", _road_matrix, False),
    "road_batch_256x10_ml_eta": ("/api/optimize_route_batch", _road_batch,
                                 True),
}
MANILA_KINDS = ("road_10_stops", "road_10_stops_ml_eta", "road_matrix_64")


def _same_road(got, want, path=""):
    """A road answer on the card against the CPU path: equal keys,
    orders, trips, alternatives' orders, geometry (polyline node
    coordinates), ``distance`` fields, matrix distances, errors and
    ``leg_cost_model``; durations within the bf16 class plus the 0.1
    rounding step; ETA fields finite with p10 <= eta <= p90; fresh
    request ids; the engine tag naming each device."""
    import math

    key = path.rsplit(".", 1)[-1]
    if isinstance(want, dict):
        check(isinstance(got, dict) and set(got) == set(want),
              f"{path}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            _same_road(got[k], want[k], f"{path}.{k}")
        if "eta_minutes_ml_p10" in got:
            check(got["eta_minutes_ml_p10"] <= got["eta_minutes_ml"]
                  <= got["eta_minutes_ml_p90"], f"{path}: ETA band")
    elif isinstance(want, list):
        check(isinstance(got, list) and len(got) == len(want),
              f"{path}: length")
        for i, (g, w) in enumerate(zip(got, want)):
            _same_road(g, w, f"{path}[{i}]")
    elif key == "engine":
        check((got, want) == ("backend:torch-cuda", "backend:torch-cpu"),
              f"{path}: {got}")
    elif key in ("request_id", "eta_completion_time_ml"):
        check(isinstance(got, str) and got, f"{path}: {got!r}")
    elif key.startswith("eta_minutes_ml"):
        check(isinstance(got, float) and math.isfinite(got),
              f"{path}: {got!r}")
    elif want is not None and (key == "duration" or "durations_s[" in path):
        check(abs(got - want) <= ROAD_DURATION_RTOL * abs(want) + 0.1 + 1e-9,
              f"{path}: {got} vs {want}")
    else:
        check(got == want, f"{path}: {got!r} != {want!r}")


def _relax_counts():
    """(relaxations, sweeps, host checks) so far: the flat sweep's and
    the overlay's in-cell (ELL) relaxations together."""
    from routest_tpu_torch.optimize.hierarchy import _relax_ell, relax_from

    return (relax_from.calls + _relax_ell.calls,
            relax_from.sweeps + _relax_ell.sweeps,
            relax_from.checks + _relax_ell.checks)


class _SolveCounter:
    """Counts a router's device solves (``_solve_rows`` calls) while in
    the ``with`` block."""

    def __init__(self, router):
        self.router, self.n = router, 0

    def __enter__(self):
        real = type(self.router)._solve_rows

        def counted(sources, live=None):
            self.n += 1
            return real(self.router, sources, live)

        self.router._solve_rows = counted
        return self

    def __exit__(self, *exc):
        del self.router._solve_rows


def _hold_router(card, cpu, label, rng):
    """The card router's solve against the CPU router's (distances and
    predecessors bitwise) and its GNN edge times (bf16 class) → the
    edge times' max relative error."""
    import numpy as np

    check(card.leg_cost_model == cpu.leg_cost_model == "gnn",
          f"{label}: leg pricer {card.leg_cost_model}/{cpu.leg_cost_model}")
    for n_src in (1, 11, 32, 64):
        sources = rng.integers(0, card.n_nodes, n_src)
        cd, cp = card.shortest(sources)
        wd, wp = cpu.shortest(sources)
        check(cd.tobytes() == wd.tobytes() and cp.tobytes() == wp.tobytes(),
              f"{label}: {n_src}-source solve differs from the CPU path")
    worst = 0.0
    for hour in (3, 8, 17):
        got, want = card.edge_time_s(hour), cpu.edge_time_s(hour)
        err = np.abs(got - want)
        check(bool((err <= 2e-2 * np.abs(want) + 0.5).all()),
              f"{label}: GNN edge times beyond the bf16 class at {hour}h")
        worst = max(worst, float((err / np.abs(want)).max()))
    print(f"[road] {label}: {card.n_nodes} nodes, {len(card.senders)} edges;"
          f" solves at 1/11/32/64 sources bitwise the CPU path's; GNN edge "
          f"times max rel err {worst:.3g}")
    return worst


def _serve_road(kinds, reps, label, pricers=("transformer", "gnn"),
                solver="flat_bf"):
    """Each kind's bodies through an app on the CPU, then on the card;
    → (records per kind, fused launches over the use_ml_eta kinds).
    ``pricers``: the leg pricers the answers and health may name (the
    first is health's); ``solver``: the solver health must name."""
    from routest_tpu_torch.core.config import Config, ServeConfig
    from routest_tpu_torch.ops.fused_mlp import fused_eta_forward
    from routest_tpu_torch.optimize import road_router
    from routest_tpu_torch.serve.ml_service import EtaService

    artifact = os.path.join(ROOT, "artifacts", "eta_mlp.msgpack")
    n = {k: reps.get(k, reps["default"]) for k in kinds}
    bodies = {k: [ROAD_KINDS[k][1](r) for r in range(n[k])] for k in kinds}
    warm = {k: [ROAD_KINDS[k][1](n[k])] for k in kinds}
    sync_bodies = {k: [ROAD_KINDS[k][1](n[k] + 1 + r)
                       for r in range(min(SYNC_REPS, n[k]))] for k in kinds}
    # the engine timed alone on bodies of its own, so that it solves
    # rather than reading the routes the requests above cached
    engine_bodies = {k: [ROAD_KINDS[k][1](n[k] + 1 + SYNC_REPS + r)
                         for r in range(n[k])] for k in kinds}

    cpu_svc = EtaService(ServeConfig(device="cpu"), model_path=artifact,
                         device="cpu")
    with _Server(cpu_svc, Config(serve=ServeConfig(device="cpu"))) as srv:
        _serve_kinds(srv.port, warm)
        on_cpu = _serve_kinds(srv.port, bodies)

    svc = EtaService(ServeConfig(), model_path=artifact, device="cuda")
    check(svc.available, f"EtaService not serving: {svc.load_error}")
    on_card, launches, relax, solves = {}, {}, {}, {}
    card_router = road_router.default_router("cuda")
    with _Server(svc) as srv:
        _serve_kinds(srv.port, warm)
        for kind in kinds:
            fused_eta_forward.launches = 0
            before = _relax_counts()
            with _SolveCounter(card_router) as counter:
                on_card.update(_serve_kinds(srv.port, {kind: bodies[kind]}))
            solves[kind] = counter.n
            launches[kind] = fused_eta_forward.launches
            relax[kind] = [a - b for a, b in zip(_relax_counts(), before)]
        syncs = _count_syncs(srv.port, sync_bodies)
        status, health = _request(srv.port, "GET", "/api/health")
        block = health["checks"]["engine"].get("road_router") or {}
        check(status == 200 and block.get("leg_cost_model") == pricers[-1]
              and block.get("solver") == solver,
              f"{label}: health road_router {block}")
    engine_card = _engine_ms(engine_bodies, "cuda")

    records = {}
    for kind in kinds:
        for got, want in zip(on_card[kind][0], on_cpu[kind][0]):
            _same_road(got, want, kind)
        card_ms, cpu_ms = on_card[kind][1], on_cpu[kind][1]
        relaxations, sweeps, checks = relax[kind]
        n_solves = max(solves[kind], 1)
        records[kind] = {
            "requests": n[kind], "median_ms": _median(card_ms),
            "p90_ms": sorted(card_ms)[max(0, int(0.9 * n[kind]) - 1)],
            "engine_ms": engine_card[kind],
            "cpu_median_ms": _median(cpu_ms),
            "syncs_per_request": syncs[kind],
            "solves_per_request": solves[kind] / n[kind],
            "relaxations_per_solve": relaxations / n_solves,
            "sweeps_per_solve": sweeps / n_solves,
            "checks_per_solve": checks / n_solves,
            "fused_launches": launches[kind]}
        if ROAD_KINDS[kind][2]:
            check(launches[kind] > 0, f"{label} {kind}: no fused launch")
        if kind == "road_10_stops_top_k5":
            check(all(len(a["properties"]["alternatives"]) == 5
                      for a in on_card[kind][0]), "top_k 5: alternatives")
        if ROAD_KINDS[kind][0] == "/api/optimize_route":
            check(all(a["properties"]["leg_cost_model"] in pricers
                      for a in on_card[kind][0]), f"{kind}: leg pricer")
        r = records[kind]
        print(f"[road] {label} {kind:26s} cuda median {r['median_ms']:.2f} "
              f"ms (p90 {r['p90_ms']:.2f}) over {n[kind]}; engine "
              f"{r['engine_ms']:.2f} ms; syncs/request "
              f"{r['syncs_per_request']:.1f}; solves/request "
              f"{r['solves_per_request']:.2f}, relaxations/solve "
              f"{r['relaxations_per_solve']:.1f}, sweeps/solve "
              f"{r['sweeps_per_solve']:.1f}; fused launches "
              f"{r['fused_launches']}; port on the CPU "
              f"{r['cpu_median_ms']:.2f} ms")
    fused = sum(launches[k] for k in kinds if ROAD_KINDS[k][2])
    return records, fused


def _cuda_ms(fn, reps=20):
    """Median wall ms of ``fn`` on the card, synchronized per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return _median(times)


def _solve_record(router, sources, reps):
    """→ {ms, sweeps, syncs} of one ``_solve_rows`` at ``sources`` (syncs:
    the sweep loop's checks plus the one fetch)."""
    def solve():
        router._solve_rows(sources)

    on_card = router.device.type == "cuda"
    if on_card:
        ms = _cuda_ms(solve, reps)
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            solve()
        ms = (time.perf_counter() - t0) * 1e3 / reps
    before = _relax_counts()
    solve()
    calls, sweeps, checks = [a - b for a, b in zip(_relax_counts(), before)]
    return {"ms": ms, "sweeps": sweeps, "syncs": checks + 1, "solves": calls}


def phase_road():
    """Street-network routing on the card (``road_graph: true``): the
    default deployment (generated 2048-node graph, road GNN, route
    transformer) and the real-data one (Manila arterials extract with
    its GNN), each held against the same deployment on the CPU path;
    solve, GNN and transformer timings. → (record, fused launches)."""
    import numpy as np
    import torch

    from routest_tpu_torch.models.gnn import N_EDGE_FEATURES
    from routest_tpu_torch.optimize import road_router

    rng = np.random.default_rng(4)
    for var in ("ROAD_GRAPH_OSM", "ROAD_GNN_PATH", "ROUTE_TRANSFORMER_PATH"):
        os.environ.pop(var, None)
    t0 = time.perf_counter()
    card = road_router.default_router("cuda")
    build_s = time.perf_counter() - t0
    check(card.leg_cost_model == "gnn" and card.has_transformer,
          f"default router: {card.leg_cost_model}, transformer "
          f"{card.has_transformer}")
    cpu = road_router.default_router("cpu")
    gnn_err = {"default": _hold_router(card, cpu, "default", rng)}

    kinds, fused = _serve_road(tuple(ROAD_KINDS),
                               {"default": ROAD_REPS,
                                "road_batch_256x10_ml_eta": ROAD_BATCH_REPS},
                               "default")
    check(card.leg_cost_model == "gnn" and card.has_transformer,
          "the default router dropped a learned pricer while serving")
    batch_solves = kinds["road_batch_256x10_ml_eta"]["solves_per_request"]
    check(batch_solves > 1, "the 2816-row batch did not split into groups")

    solve_ms = {}
    for bucket in SOLVE_BUCKETS:
        sources = rng.integers(0, card.n_nodes, bucket)
        solve_ms[bucket] = {"cuda": _solve_record(card, sources, 20),
                            "cpu": _solve_record(cpu, sources, 5)}
        c, h = solve_ms[bucket]["cuda"], solve_ms[bucket]["cpu"]
        print(f"[road] solve {bucket:2d} sources: cuda {c['ms']:.3f} ms, "
              f"{c['sweeps']} sweeps, {c['syncs']} syncs; CPU path "
              f"{h['ms']:.3f} ms")
    gnn = card._gnn
    feats = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (len(card.senders), N_EDGE_FEATURES)).astype(np.float32)).to(
            card.device)
    gnn_ms = _cuda_ms(lambda: gnn(card._d_coords, card._d_senders,
                                  card._d_receivers, feats, card._d_length,
                                  card._d_speed))
    tf, seq_len = card._transformer
    windows = 4  # a 10-stop tour's edges in seq_len windows
    tf_in = (torch.randn(windows, seq_len, N_EDGE_FEATURES,
                         device=card.device),
             torch.rand(windows, seq_len, device=card.device) * 60.0,
             torch.arange(seq_len, device=card.device),
             torch.ones(windows, seq_len, device=card.device))
    tf_ms = _cuda_ms(lambda: tf(*tf_in[:3], key_mask=tf_in[3]))
    print(f"[road] GNN forward over {len(card.senders)} edges {gnn_ms:.3f} "
          f"ms ({gnn.policy.compute_dtype}); transformer forward "
          f"({windows}×{seq_len}) {tf_ms:.3f} ms; default router built in "
          f"{build_s:.2f} s")

    # The real-data deployment, through the same env knobs a user sets.
    saved = dict(road_router._default_routers)
    road_router._default_routers.clear()
    os.environ["ROAD_GRAPH_OSM"] = os.path.join(ROOT, MANILA_OSM)
    os.environ["ROAD_GNN_PATH"] = os.path.join(ROOT, MANILA_GNN)
    try:
        m_card = road_router.default_router("cuda")
        m_cpu = road_router.default_router("cpu")
        gnn_err["manila"] = _hold_router(m_card, m_cpu, "manila", rng)
        manila, m_fused = _serve_road(MANILA_KINDS,
                                      {"default": MANILA_REPS}, "manila")
        check(m_card.leg_cost_model == "gnn",
              "the Manila router dropped its GNN while serving")
    finally:
        os.environ.pop("ROAD_GRAPH_OSM", None)
        os.environ.pop("ROAD_GNN_PATH", None)
        road_router._default_routers.clear()
        road_router._default_routers.update(saved)
    record = {"kinds": kinds, "manila": manila, "solve_ms": solve_ms,
              "gnn_forward_ms": gnn_ms, "transformer_forward_ms": tf_ms,
              "transformer_windows": [windows, seq_len],
              "gnn_edge_time_max_rel_err": gnn_err,
              "router_build_s": build_s,
              "fused_launches": fused + m_fused}
    print(json.dumps({"road": record}))
    return record, fused + m_fused


# Source buckets of the metro overlay solves (a 1-stop route, a 10-stop
# route or the matrix's 32-row chunks, and the 64-point matrix solved
# whole), timed reps per bucket, and requests per serving kind.
OVERLAY_BUCKETS = (2, 16, 64)
OVERLAY_REPS = 10
OVERLAY_SERVE_REPS = {"default": 10}
OVERLAY_KINDS = ("road_10_stops", "road_10_stops_ml_eta",
                 "road_10_stops_top_k5", "road_matrix_64")
# The 50,066-node OSM-topology extract: intersections of the k=4 kNN
# street graph, 2 bends per street, 10% one-way (the scale bench's first
# row, scripts/bench_osm_scale.py).
OSM50K_INTERSECTIONS = 8543
OSM50K_GAP = 1e-6
# The device the overlay phase holds against the CPU path (a rehearsal
# on a host without a card sets it to "cpu").
CARD = "cuda"
# The overlay phase's metro routers ({"card", "cpu"}), which the live
# phase re-prices.
_METRO = {}


def _strip_timings(d):
    """A stats dict without its ``*_s`` wall-clock entries."""
    if isinstance(d, dict):
        return {k: _strip_timings(v) for k, v in d.items()
                if not k.endswith("_s")}
    if isinstance(d, list):
        return [_strip_timings(x) for x in d]
    return d


def _event_ms(fn, reps):
    """Median ms of ``fn`` between two CUDA events (the device timeline
    from the first enqueue to the last completion, host waits inside
    included)."""
    import torch

    if CARD != "cuda":
        return _cpu_ms(fn, reps)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return _median(times)


def _stage_ms(index, sources):
    """Median ms per query stage over ``OVERLAY_REPS`` ``timed_query``
    calls (after one warm-up)."""
    index.timed_query(sources)
    runs = [index.timed_query(sources)[1] for _ in range(OVERLAY_REPS)]
    return {k: _median([r[k] for r in runs]) for k in runs[0]}


def _device_work(fn):
    """→ {aten_ops, cuda_kernels, cuda_memcpy, syncs} of one call of
    ``fn``: torch ops dispatched (a ``TorchDispatchMode``), device kernel
    and copy events (``torch.profiler``; None when it records no device
    activity), and host syncs (torch's sync debug mode)."""
    import warnings

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    out = {"aten_ops": None, "cuda_kernels": None, "cuda_memcpy": None,
           "syncs": None}
    fn()
    with _Ops() as ops:
        fn()
    out["aten_ops"] = ops.n
    if CARD != "cuda":
        return out
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from routest_tpu_torch.utils.profiling import profiler_slot

    torch.cuda.synchronize()
    try:
        # torch.profiler is process-wide: hold its one slot, as the
        # serving path's device traces do
        with profiler_slot("chip_smoke kernel count"), \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    except Exception as e:  # a record, not a check: keep the phase going
        print(f"[overlay] torch.profiler unavailable: {type(e).__name__}: "
              f"{e}")
        dev = []
    if dev:
        copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in dev)
        out["cuda_kernels"] = len(dev) - copies
        out["cuda_memcpy"] = copies
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out["syncs"] = sum("synchronizing CUDA operation" in str(w.message)
                       for w in caught)
    return out


def _overlay_metro(rng):
    """(a): the metro extract's overlay built on the card and on the CPU
    path, its solves held bitwise to the CPU path's, timed and counted;
    the flat solver's solves beside them. → record."""
    from routest_tpu_torch.data.osm import load_osm
    from routest_tpu_torch.optimize import hierarchy, road_router

    graph = load_osm(os.path.join(ROOT, METRO_OSM))
    routers, build_s = {}, {}
    for dev in (CARD, "cpu"):
        t0 = time.perf_counter()
        routers[dev] = road_router.RoadRouter(
            graph=graph, use_gnn=False, use_transformer=False, device=dev)
        build_s[dev] = time.perf_counter() - t0
    card, cpu = routers[CARD], routers["cpu"]
    _METRO.update(card=card, cpu=cpu)       # the live phase reuses them
    check(card._hier is not None and cpu._hier is not None,
          "metro: no overlay at default knobs")
    check(card.solver_info["solver"] == "hierarchy", "metro solver")
    stats = card._hier.stats
    check(_strip_timings(stats) == _strip_timings(cpu._hier.stats),
          "metro: the card's overlay stats differ from the CPU build's")
    stages = {"contract_s": stats["contraction"]["contract_s"],
              "partition_s": stats["partition_s"],
              "levels_s": [lv["build_s"] for lv in stats["levels"]],
              "labels_s": (stats.get("labels") or {}).get("build_s"),
              "index_s": stats["build_s"], "router_s": build_s[CARD],
              "cpu_index_s": cpu._hier.stats["build_s"],
              "cpu_router_s": build_s["cpu"]}
    print(f"[overlay] metro 8192: {stats['n_levels']} levels, cells "
          f"{[lv['n_cells'] for lv in stats['levels']]}, c_max "
          f"{[lv['c_max'] for lv in stats['levels']]}, b_max "
          f"{[lv['b_max'] for lv in stats['levels']]}, hub labels "
          f"{stats.get('labels', {}).get('nodes')}; built on {CARD} in "
          f"{build_s[CARD]:.2f} s (index {stats['build_s']} s: contract "
          f"{stages['contract_s']}, partition {stages['partition_s']}, "
          f"levels {stages['levels_s']}, labels {stages['labels_s']}); "
          f"CPU path {build_s['cpu']:.2f} s; stats equal")
    os.environ["ROUTEST_HIER_MIN_NODES"] = "0"      # the flat solver
    try:
        flat = road_router.RoadRouter(graph=graph, use_gnn=False,
                                      use_transformer=False, device=CARD)
    finally:
        os.environ.pop("ROUTEST_HIER_MIN_NODES")
    check(flat._hier is None, "metro: ROUTEST_HIER_MIN_NODES=0 kept the "
                              "overlay")
    solves = {}
    for bucket in OVERLAY_BUCKETS:
        src = rng.integers(0, card.n_nodes, bucket)
        cd, cp = card._solve_rows(src)
        wd, wp = cpu._solve_rows(src)
        check(cd.tobytes() == wd.tobytes() and (cp == wp).all(),
              f"metro overlay: {bucket}-source solve differs from the CPU "
              f"path")
        before = [hierarchy._relax_ell.calls, hierarchy._relax_ell.sweeps,
                  hierarchy._relax_ell.checks]
        card._solve_rows(src)
        ell = [a - b for a, b in zip(
            [hierarchy._relax_ell.calls, hierarchy._relax_ell.sweeps,
             hierarchy._relax_ell.checks], before)]
        rec = {"ms": _event_ms(lambda: card._solve_rows(src), OVERLAY_REPS),
               "cpu_ms": _cpu_ms(lambda: cpu._solve_rows(src), 3),
               "stage_ms": _stage_ms(card._hier, src),
               "ell_relaxations": ell[0], "ell_sweeps": ell[1],
               "ell_checks": ell[2],
               **_device_work(lambda: card._solve_rows(src)),
               # sweeps and syncs from one run, ms on the same clock
               "flat": {**_solve_record(flat, src, 1), "ms": _event_ms(
                   lambda: flat._solve_rows(src), OVERLAY_REPS)}}
        solves[bucket] = rec
        print(f"[overlay] metro {bucket:2d} sources: bitwise the CPU path; "
              f"{CARD} {rec['ms']:.3f} ms ({rec['ell_relaxations']} ELL "
              f"relaxations, {rec['ell_sweeps']} sweeps, syncs "
              f"{rec['syncs']}, kernels {rec['cuda_kernels']}, torch ops "
              f"{rec['aten_ops']}); stages "
              + ", ".join(f"{k} {v:.3f}" for k, v in rec["stage_ms"].items())
              + f"; CPU path {rec['cpu_ms']:.3f} ms; flat {rec['flat']['ms']:.3f}"
              f" ms ({rec['flat']['sweeps']} sweeps, {rec['flat']['syncs']}"
              f" syncs)")
    return {"nodes": card.n_nodes, "edges": len(card.senders),
            "overlay": _strip_timings(stats), "build": stages,
            "solves": solves}


def _cpu_ms(fn, reps):
    """Median wall ms of ``fn`` on the host."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return _median(times)


def _overlay_serve():
    """(b): the metro extract as a deployment (``ROAD_GRAPH_OSM``) through
    the port's app on the card against the CPU path. → (records per
    kind, fused launches over the use_ml_eta kind)."""
    from routest_tpu_torch.optimize import road_router

    saved = dict(road_router._default_routers)
    road_router._default_routers.clear()
    os.environ["ROAD_GRAPH_OSM"] = os.path.join(ROOT, METRO_OSM)
    try:
        card = road_router.default_router(CARD)
        cpu = road_router.default_router("cpu")
        check(card.solver_info["solver"] == cpu.solver_info["solver"]
              == "hierarchy", "metro deployment: not on the overlay")
        return _serve_road(OVERLAY_KINDS, OVERLAY_SERVE_REPS, "metro",
                           pricers=("freeflow",), solver="hierarchy")
    finally:
        os.environ.pop("ROAD_GRAPH_OSM", None)
        road_router._default_routers.clear()
        road_router._default_routers.update(saved)


def _overlay_50k(rng):
    """(c): the 50,066-node OSM-topology extract, made from seed 0 and
    written and re-read through the OSM format: build time, cold and
    warm 16-source solves with stage ms, and the oracle gap. → record."""
    import tempfile

    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    from routest_tpu_torch.data.osm import load_osm, save_osm
    from routest_tpu_torch.data.road_graph import (generate_road_graph,
                                                   subdivide_graph)
    from routest_tpu_torch.optimize import road_router

    t0 = time.perf_counter()
    base = generate_road_graph(n_nodes=OSM50K_INTERSECTIONS, k=4, seed=0)
    streets = subdivide_graph(base, bends_per_edge=2, oneway_frac=0.1,
                              seed=0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "metro50k.osm.gz")
        save_osm(path, streets)
        extract = load_osm(path)
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    router = road_router.RoadRouter(graph=extract, use_gnn=False,
                                    use_transformer=False, device=CARD)
    build_s = time.perf_counter() - t0
    check(router._hier is not None, "50k: no overlay")
    stats = router._hier.stats
    pts = np.stack([rng.uniform(14.40, 14.68, 16),
                    rng.uniform(120.96, 121.10, 16)], axis=1).astype(
                        np.float32)
    nodes = router.snap(pts)
    t0 = time.perf_counter()
    dist, pred = router._solve_rows(nodes)
    cold_ms = (time.perf_counter() - t0) * 1e3
    warm_ms = _event_ms(lambda: router._solve_rows(nodes), OVERLAY_REPS)
    stage_ms = _stage_ms(router._hier, nodes)
    work = _device_work(lambda: router._solve_rows(nodes))
    n = router.n_nodes
    adj = sp.coo_matrix((router.length_m, (router.senders, router.receivers)),
                        shape=(n, n)).tocsr()
    want = dijkstra(adj, directed=True, indices=nodes.astype(np.int64))
    finite = np.isfinite(want)
    check(not (dist[finite] > 1e37).any() and not (dist[~finite] < 1e37).any(),
          "50k: reachability differs from the oracle")
    gap = float((np.abs(dist[finite] - want[finite])
                 / np.maximum(want[finite], 1.0)).max())
    check(gap <= OSM50K_GAP, f"50k: oracle gap {gap:.3g} > {OSM50K_GAP}")
    os.environ["ROUTEST_HIER_MIN_NODES"] = "0"      # the flat solver
    try:
        flat = road_router.RoadRouter(graph=extract, use_gnn=False,
                                      use_transformer=False, device=CARD)
    finally:
        os.environ.pop("ROUTEST_HIER_MIN_NODES")
    flat_rec = {**_solve_record(flat, nodes, 1), "ms": _event_ms(
        lambda: flat._solve_rows(nodes), 3)}
    rec = {"nodes": n, "edges": len(router.senders), "make_s": make_s,
           "router_build_s": build_s, "index_build_s": stats["build_s"],
           "overlay": _strip_timings(stats),
           "build": {"contract_s": stats["contraction"]["contract_s"],
                     "partition_s": stats["partition_s"],
                     "levels_s": [lv["build_s"] for lv in stats["levels"]],
                     "labels_s": (stats.get("labels") or {}).get("build_s")},
           "solve_cold_ms": cold_ms, "solve_warm_ms": warm_ms,
           "stage_ms": stage_ms,
           "reachable_frac": float(finite.mean()), "oracle_gap": gap,
           "flat": flat_rec, **work}
    print(f"[overlay] 50k extract: {n} nodes, {len(router.senders)} edges, "
          f"{stats['contraction']['n_contracted']} contracted, "
          f"{stats['n_levels']} levels, {stats.get('labels', {}).get('nodes')}"
          f" label nodes; made in {make_s:.2f} s, router built in "
          f"{build_s:.2f} s (index {stats['build_s']} s); 16 sources cold "
          f"{cold_ms:.2f} ms, warm {warm_ms:.3f} ms (syncs {work['syncs']}, "
          f"kernels {work['cuda_kernels']}); stages " + ", ".join(
              f"{k} {v:.3f}" for k, v in rec["stage_ms"].items())
          + f"; oracle gap {gap:.3g}, reachable {rec['reachable_frac']:.4f};"
          f" flat {flat_rec['ms']:.3f} ms ({flat_rec['sweeps']} sweeps, "
          f"{flat_rec['syncs']} syncs)")
    return rec


def phase_overlay():
    """Street routing at metro scale through the partition overlay:
    (a) the metro extract's overlay on the card held bitwise to the CPU
    path, (b) the metro deployment served over HTTP, (c) the 50k extract
    against scipy's Dijkstra. → (record, fused launches over (b)'s
    use_ml_eta requests)."""
    import numpy as np

    rng = np.random.default_rng(8)
    # Measure builds, not the per-user cache, and write nothing there.
    os.environ["ROUTEST_HIER_CACHE"] = "0"
    for var in ("ROAD_GRAPH_OSM", "ROAD_GNN_PATH", "ROUTE_TRANSFORMER_PATH",
                "ROUTEST_HIER_MIN_NODES"):
        os.environ.pop(var, None)
    metro = _overlay_metro(rng)
    kinds, fused = _overlay_serve()
    osm50k = _overlay_50k(rng)
    record = {"metro_8192": metro, "metro_serving": kinds,
              "osm_50k": osm50k, "fused_launches": fused}
    print(json.dumps({"overlay": record}))
    return record, fused


# ── phase 10: live traffic ──────────────────────────────────────────────

# The probe fleet of the JAX package's live-traffic bench
# (scripts/bench_live_traffic.py): 160 drivers, 6 observations a tick.
LIVE_DRIVERS = 160
LIVE_OBS_PER_TICK = 6
LIVE_TICKS = 12
# A fixed clock: the fleet, the estimator and the customizer read no
# wall time, so the card and the CPU path fold the same events.
LIVE_NOW0 = 1_760_000_000.0
LIVE_REPS = 10
# Over HTTP: probe batches posted, observations per batch, and
# use_ml_eta road routes served under the live metric.
LIVE_PROBE_BATCHES = 20
LIVE_PROBE_OBS = 200
LIVE_ROUTES = 5
# The tracked route: coordinates replayed at the reference's 2-5 s gait,
# and the first stream's length (the reconnect resumes after it).
LIVE_TRACK_POINTS = 3
LIVE_TRACK_FIRST = 1


def _live_fleet(router, corridor, seed=0, jam=True):
    """A seeded ``ProbeFleet`` with a jammed corridor (``jam=False``: the
    same fleet and observations with the corridor flowing), stepped on
    the fixed clock through a bus into the ingester and a fresh
    ``CongestionState``. → (state, fleet events)."""
    from routest_tpu_torch.live.ingest import ProbeIngester
    from routest_tpu_torch.live.probes import CongestionScenario, ProbeFleet
    from routest_tpu_torch.live.state import CongestionState
    from routest_tpu_torch.serve.bus import InMemoryBus

    bus = InMemoryBus()
    state = CongestionState(router.freeflow_time_s)
    ingester = ProbeIngester(bus, state, router.length_m)
    scenario = CongestionScenario(corridor, speed_factor=0.25)
    scenario.set_active(jam)
    fleet = ProbeFleet(router.graph_dict(), LIVE_DRIVERS, bus.publish,
                       seed=seed, scenario=scenario,
                       obs_per_tick=LIVE_OBS_PER_TICK)
    sub = bus.subscribe(fleet.channel)
    events = []
    for t in range(LIVE_TICKS):
        events.extend(fleet.step(now=LIVE_NOW0 + t, hour=8))
        while (ev := sub.get(timeout=0)) is not None:
            ingester.handle(ev)
    sub.close()
    check(ingester.batches == fleet.published == len(events),
          "live: the ingester missed fleet events")
    return state, events


def _live_flip(router, corridor, seed=0, jam=True):
    """``_live_fleet``'s probe stream, then one
    ``MetricCustomizer.run_once`` on ``router``. → (customizer result,
    fleet events, cycle wall s)."""
    from routest_tpu_torch.live.customize import MetricCustomizer

    state, events = _live_fleet(router, corridor, seed, jam)
    t0 = time.perf_counter()
    res = MetricCustomizer(router, state).run_once(now=LIVE_NOW0
                                                   + LIVE_TICKS)
    cycle_s = time.perf_counter() - t0
    check(res.get("flipped"), f"live: no flip on {router.device}: {res}")
    return res, events, cycle_s


def _live_corridor(router, width_m=400.0):
    """The corridor across the graph from its westmost to its eastmost
    node."""
    import numpy as np

    from routest_tpu_torch.live.probes import corridor_edges

    lon = router.coords[:, 1]
    a = tuple(float(v) for v in router.coords[int(np.argmin(lon))])
    b = tuple(float(v) for v in router.coords[int(np.argmax(lon))])
    cor = corridor_edges(router.coords, router.senders, router.receivers,
                         a, b, width_m=width_m)
    check(len(cor) > 0, "live: empty corridor")
    return cor


def _live_hold(card, cpu, label, rng):
    """Live solves at ``OVERLAY_BUCKETS`` sources and ``_meters_along``
    on the card against the CPU path (bitwise), timed; then a 10-stop
    ``road_graph: true`` route through the engine on both, equal as
    JSON. → record."""
    from routest_tpu_torch.optimize import road_router
    from routest_tpu_torch.optimize.engine import optimize_route

    solves = {}
    for bucket in OVERLAY_BUCKETS:
        src = rng.integers(0, card.n_nodes, bucket)
        cd, cp = card._solve_rows(src, card._live)
        wd, wp = cpu._solve_rows(src, cpu._live)
        check(cd.tobytes() == wd.tobytes() and (cp == wp).all(),
              f"live {label}: {bucket}-source solve differs from the CPU "
              f"path")
        cm, wm = card._meters_along(cp, cd), cpu._meters_along(wp, wd)
        check(cm.tobytes() == wm.tobytes(),
              f"live {label}: meters along the {bucket}-source trees differ")
        solves[bucket] = {
            "ms": _event_ms(lambda: card._solve_rows(src, card._live),
                            LIVE_REPS),
            "cpu_ms": _cpu_ms(lambda: cpu._solve_rows(src, cpu._live), 3),
            "meters_ms": _event_ms(lambda: card._meters_along(cp, cd),
                                   LIVE_REPS),
            "distance_metric_ms": _event_ms(lambda: card._solve_rows(src),
                                            LIVE_REPS)}
    saved = dict(road_router._default_routers)
    road_router._default_routers.update({CARD: card, "cpu": cpu})
    try:
        body = _road_body(10, 0)
        got = optimize_route(body, device=CARD)
        want = optimize_route(body, device="cpu")
    finally:
        road_router._default_routers.clear()
        road_router._default_routers.update(saved)
    props = got.get("properties") or {}
    check("error" not in got and props.get("leg_cost_model", "")
          .startswith("live+"), f"live {label}: route {got.get('error')} "
                                f"{props.get('leg_cost_model')}")
    for d in (got, want):
        (d.get("properties") or {}).pop("engine", None)
    check(json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True),
          f"live {label}: the 10-stop route differs from the CPU path")
    return {"solves": solves, "route_leg_cost_model": props[
        "leg_cost_model"], "route_distance_m": props["summary"]["distance"],
        "route_duration_s": props["summary"]["duration"]}


def _install_s(router, metric, epoch):
    """Wall s of one ``install_live_metric`` (the card synchronized)."""
    import torch

    t0 = time.perf_counter()
    router.install_live_metric(metric, epoch)
    if router.device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def _live_metro(rng):
    """(1): the metro overlay of phase 8 re-priced on the card and on the
    CPU path by the same probe stream; payloads, solves, meters and a
    route held bitwise. → record."""
    import tempfile

    import numpy as np

    from routest_tpu_torch.data.osm import load_osm
    from routest_tpu_torch.optimize import road_router

    if not _METRO:
        graph = load_osm(os.path.join(ROOT, METRO_OSM))
        _METRO.update({k: road_router.RoadRouter(
            graph=graph, use_gnn=False, use_transformer=False, device=dev)
            for k, dev in (("card", CARD), ("cpu", "cpu"))})
    card, cpu = _METRO["card"], _METRO["cpu"]
    cor = _live_corridor(card)
    res, events, cycle = {}, {}, {}
    for key, router in (("card", card), ("cpu", cpu)):
        res[key], events[key], cycle[key] = _live_flip(router, cor)
    check(events["card"] == events["cpu"], "live metro: fleet events differ")
    metric = card.live_metric_export()
    check(metric.tobytes() == cpu.live_metric_export().tobytes(),
          "live metro: blended metrics differ")
    hc, hw = card._live.hier, cpu._live.hier
    check(hc is not None and hc.stats.get("customized"),
          "live metro: the overlay was not customized")
    with tempfile.TemporaryDirectory() as d:
        payloads = []
        for name, index in (("card", hc), ("cpu", hw)):
            index._save(os.path.join(d, f"{name}.npz"), {})
            with np.load(os.path.join(d, f"{name}.npz")) as z:
                payloads.append({k: z[k] for k in z.files})
    check(sorted(payloads[0]) == sorted(payloads[1]),
          "live metro: payload keys differ")
    for key, val in payloads[1].items():
        if key == "_stats":
            continue
        check(payloads[0][key].dtype == val.dtype
              and payloads[0][key].tobytes() == val.tobytes(),
              f"live metro: customized payload {key} differs")
    check(_strip_timings(hc.stats) == _strip_timings(hw.stats),
          "live metro: customized stats differ")
    held = _live_hold(card, cpu, "metro", rng)
    epoch = card.live_epoch
    rec = {"nodes": card.n_nodes, "edges": len(card.senders),
           "corridor_edges": len(cor), "fleet_events": len(events["card"]),
           "observations": sum(len(e["obs"]) for e in events["card"]),
           "obs_edges": res["card"]["obs_edges"],
           "customize_s": hc.stats["build_s"],
           "full_build_s": card._hier.stats["build_s"],
           "cpu_customize_s": hw.stats["build_s"],
           "cpu_full_build_s": cpu._hier.stats["build_s"],
           "cycle_s": cycle["card"], "cpu_cycle_s": cycle["cpu"],
           "install_s": _install_s(card, metric, epoch + 1),
           "cpu_install_s": _install_s(cpu, metric, epoch + 1),
           "levels": [lv["n_cells"] for lv in hc.stats["levels"]], **held}
    s = rec["solves"]
    print(f"[live] metro {rec['nodes']} nodes: {rec['fleet_events']} probe "
          f"events ({rec['observations']} observations, corridor "
          f"{rec['corridor_edges']} edges) → {rec['obs_edges']} observed "
          f"edges; customize {rec['customize_s']} s on {CARD} against a "
          f"full build of {rec['full_build_s']} s (CPU path "
          f"{rec['cpu_customize_s']} / {rec['cpu_full_build_s']} s); "
          f"install {rec['install_s']:.3f} s (CPU path "
          f"{rec['cpu_install_s']:.3f}); payloads, solves, meters and the "
          f"10-stop route bitwise the CPU path's; live solve ms "
          + ", ".join(f"{b}: {v['ms']:.3f} (CPU path {v['cpu_ms']:.3f}; "
                      f"distance metric {v['distance_metric_ms']:.3f})"
                      for b, v in s.items()))
    return rec


def _live_flat(rng):
    """(2): the default 2048-node router (GNN, transformer): the metric
    flipped on the card from the probe stream (GNN base priced on the
    card), the same metric installed on the CPU path, solves, meters and
    a route held bitwise. → record."""
    from routest_tpu_torch.optimize import road_router

    card = road_router.default_router(CARD)
    cpu = road_router.default_router("cpu")
    check(card.leg_cost_model == "gnn", "live flat: the GNN is not live")
    res, events, cycle = _live_flip(card, _live_corridor(card), seed=1)
    metric = card.live_metric_export()
    install_cpu = _install_s(cpu, metric, card.live_epoch)
    check(cpu.live_metric_export().tobytes() == metric.tobytes(),
          "live flat: the installed metrics differ")
    held = _live_hold(card, cpu, "flat", rng)
    rec = {"nodes": card.n_nodes, "edges": len(card.senders),
           "fleet_events": len(events), "obs_edges": res["obs_edges"],
           "cycle_s": cycle,
           "install_s": _install_s(card, metric, card.live_epoch + 1),
           "cpu_install_s": install_cpu, **held}
    print(f"[live] flat {rec['nodes']} nodes: {rec['fleet_events']} probe "
          f"events → {rec['obs_edges']} observed edges; flip cycle "
          f"{cycle:.3f} s on {CARD}; install {rec['install_s']:.4f} s (CPU "
          f"path {install_cpu:.4f}); solves, meters and the 10-stop route "
          f"({rec['route_leg_cost_model']}) bitwise the CPU path's; live "
          f"solve ms " + ", ".join(
              f"{b}: {v['ms']:.3f} (CPU path {v['cpu_ms']:.3f})"
              for b, v in rec["solves"].items()))
    return rec


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _sse(port, path, headers=None):
    """A bounded SSE stream's frames → [(id, event)]."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        check(resp.status == 200 and resp.getheader("Content-Type")
              == "text/event-stream", f"stream {path}: {resp.status}")
        body = resp.read().decode()
    finally:
        conn.close()
    frames = []
    for frame in body.split("\n\n")[:-1]:
        head, data = frame.split("\n", 1)
        check(head.startswith("id: ") and data.startswith("data: "),
              f"stream {path}: frame {frame!r}")
        frames.append((int(head[4:]), json.loads(data[6:])))
    return frames


def _wait_for(what, fn, timeout_s, proc, who="live serving"):
    t0 = time.perf_counter()
    while True:
        check(proc.poll() is None, f"{who}: the server exited "
                                   f"({proc.returncode}) waiting for {what}")
        try:
            out = fn()
        except OSError:
            out = None
        if out:
            return out, time.perf_counter() - t0
        check(time.perf_counter() - t0 < timeout_s,
              f"{who}: no {what} in {timeout_s} s")
        time.sleep(0.1)


def _live_serve(rng):
    """(3): ``python -m routest_tpu_torch.serve`` with ``RTPU_LIVE=1`` on
    the card: probes over HTTP until ``/api/live`` reads a flipped
    metric, ``use_ml_eta`` road routes priced ``live+``, then a seeded
    tracked route over SSE and a ``Last-Event-ID`` reconnect; the fused
    kernel's launches over the server's requests from its
    ``serve_listening`` and ``serve_stopped`` log lines. → record."""
    import signal
    import tempfile

    import numpy as np

    from routest_tpu_torch.optimize import road_router

    port = _free_port()
    env = dict(os.environ, PORT=str(port), RTPU_HOST="127.0.0.1",
               RTPU_LIVE="1", RTPU_LIVE_CUSTOMIZE_S="0.5",
               ROUTEST_HIER_CACHE="0",
               ROUTEST_DEVICE=CARD)
    for var in ("ROAD_GRAPH_OSM", "ROAD_GNN_PATH", "ROUTE_TRANSFORMER_PATH",
                "ROUTEST_HIER_MIN_NODES", "REDIS_URL", "ETA_MODEL_PATH"):
        env.pop(var, None)
    log = tempfile.TemporaryFile(mode="w+")
    t_start = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "routest_tpu_torch.serve"],
                            cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    try:
        _, boot_s = _wait_for("ping", lambda: _request(
            port, "GET", "/api/ping")[0] == 200, 300, proc)

        def live():
            return _request(port, "GET", "/api/live")[1]

        snap, ready_s = _wait_for("live ready", lambda: (
            live() if live().get("ready") else None), 300, proc)
        check(snap["epoch"] == 0 and snap["channel"] == "rtpu.probes",
              f"live serving: {snap}")
        n_edges = snap["ingest"]["edges"]
        check(n_edges == len(road_router.default_router("cpu").senders),
              "live serving: not the default graph")
        t_probe = time.perf_counter()
        for k in range(LIVE_PROBE_BATCHES):
            edges = rng.integers(0, n_edges, LIVE_PROBE_OBS)
            speeds = rng.uniform(1.5, 14.0, LIVE_PROBE_OBS)
            status, out = _request(port, "POST", "/api/probe", {
                "obs": [[int(e), round(float(v), 3)]
                        for e, v in zip(edges, speeds)],
                "t": time.time(), "hour": 8, "driver": f"smoke{k}"})
            check(status == 200 and out == {"status": "published",
                                             "count": LIVE_PROBE_OBS},
                  f"/api/probe: {status} {out}")
        probes_s = time.perf_counter() - t_probe
        snap, flip_s = _wait_for("a live metric", lambda: (
            live() if live().get("epoch", 0) >= 1 else None), 120, proc)
        status, health = _request(port, "GET", "/api/health")
        check(health["checks"]["engine"]["live"]["epoch"] >= 1
              and health["checks"]["bus"]["backend"] == "memory",
              f"live serving: health {health['checks']['engine'].get('live')}")
        routes, route_ms = [], []
        for r in range(LIVE_ROUTES):
            t0 = time.perf_counter()
            status, out = _request(port, "POST", "/api/optimize_route",
                                   _road_body(10, r, 5, **_ML))
            route_ms.append((time.perf_counter() - t0) * 1e3)
            props = (out or {}).get("properties") or {}
            check(status == 200 and props.get("leg_cost_model", "")
                  .startswith("live+"), f"live route: {status} "
                                        f"{props.get('leg_cost_model')}")
            check(props["eta_minutes_ml_p10"] <= props["eta_minutes_ml"]
                  <= props["eta_minutes_ml_p90"], "live route: ETA band")
            routes.append(out)
        scoring = health["checks"]["model"]["scoring"]
        check(scoring["kernel"] == ("cuda_fused" if CARD == "cuda"
                                    else "torch_plain"),
              f"live serving: scoring {scoring}")
        coords = routes[0]["geometry"]["coordinates"][:LIVE_TRACK_POINTS]
        check(len(coords) == LIVE_TRACK_POINTS, "tracked route too short")
        props = routes[0]["properties"]
        status, out = _request(port, "POST", "/api/confirm_route", {
            "driver_details": {"driver_name": "smoke-driver",
                               "vehicle_type": "car"},
            "route_details": {"geometry": {"coordinates": coords},
                              "properties": {
                                  "destinations": [{"lat": 14.55,
                                                    "lon": 121.02}],
                                  "summary": props["summary"]}},
            "sim_seed": 7})
        # the destination carries lat/lon: registered for dispatch
        # re-optimization (dispatch is on by default)
        check(status == 200 and out.get("status")
              == "route simulation initialized."
              and set(out) == {"status", "dispatch_id"},
              f"/api/confirm_route: {status} {out}")
        t0 = time.perf_counter()
        first = _sse(port, "/api/realtime_feed?channel=smoke-driver&"
                     f"max_events={LIVE_TRACK_FIRST}", {"Last-Event-ID": "0"})
        rest = _sse(port, "/api/realtime_feed?channel=smoke-driver&max_events="
                    f"{LIVE_TRACK_POINTS - LIVE_TRACK_FIRST}",
                    {"Last-Event-ID": str(LIVE_TRACK_FIRST)})
        track_s = time.perf_counter() - t0
        frames = first + rest
        check([i for i, _ in frames] == list(range(1, LIVE_TRACK_POINTS + 1)),
              f"tracked route: event ids {[i for i, _ in frames]}")
        check([len(ev["remaining_routes"]) for _, ev in frames]
              == list(range(LIVE_TRACK_POINTS, 0, -1))
              and all(ev["assigned_driver"] == "smoke-driver"
                      for _, ev in frames), "tracked route: frames")
        final = live()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.seek(0)
        text = log.read()
        log.close()
        if proc.returncode not in (0, -signal.SIGTERM):
            print(f"[live] server log tail:\n{text[-3000:]}")
    check(proc.returncode in (0, -signal.SIGTERM),
          f"live serving: the server exited {proc.returncode} at SIGTERM")
    counts = {}
    for line in text.splitlines():
        try:
            event = json.loads(line)
        except ValueError:
            continue
        if isinstance(event, dict) and event.get("event") in (
                "serve_listening", "serve_stopped"):
            counts[event["event"]] = event["fused_launches"]
    check(len(counts) == 2, f"live serving: launch counts logged {counts}")
    # Only the use_ml_eta routes score ETAs among the server's requests.
    launches = counts["serve_stopped"] - counts["serve_listening"]
    if CARD == "cuda":
        check(launches > 0, f"live serving: no fused launch over "
                            f"{LIVE_ROUTES} use_ml_eta routes")
    rec = {"boot_s": boot_s, "live_ready_s": ready_s,
           "probe_batches": LIVE_PROBE_BATCHES,
           "probe_observations": LIVE_PROBE_BATCHES * LIVE_PROBE_OBS,
           "probes_post_s": probes_s, "flip_after_probes_s": flip_s,
           "epoch": final["epoch"],
           "edges_observed": final["ingest"]["edges_observed"],
           "flips": final["customize"]["flips"],
           "route_median_ms": _median(route_ms),
           "route_leg_cost_model": routes[0]["properties"]["leg_cost_model"],
           "fused_launches": launches, "tracked_frames": len(frames),
           "resumed_ids": [i for i, _ in rest], "track_read_s": track_s,
           "server_exit": proc.returncode,
           "wall_s": time.perf_counter() - t_start}
    print(f"[live] serving: booted in {boot_s:.1f} s, live ready after "
          f"{ready_s:.1f} s more; {rec['probe_observations']} observations "
          f"over {LIVE_PROBE_BATCHES} /api/probe posts ({probes_s:.2f} s), "
          f"epoch >= 1 {flip_s:.2f} s later (now epoch {rec['epoch']}, "
          f"{rec['edges_observed']} edges observed); {LIVE_ROUTES} use_ml_eta"
          f" road routes ({rec['route_leg_cost_model']}) median "
          f"{rec['route_median_ms']:.2f} ms, {launches} fused launches; "
          f"tracked route: {len(frames)} frames, reconnect resumed at ids "
          f"{rec['resumed_ids']}")
    return rec, launches


def phase_live():
    """Live traffic on the card: (1) the metro overlay re-priced by a
    probe stream, (2) the default router's live metric, (3) the live
    loop through the port's server. → (record, fused launches over
    (3)'s use_ml_eta routes)."""
    import numpy as np

    rng = np.random.default_rng(10)
    os.environ["ROUTEST_HIER_CACHE"] = "0"
    metro = _live_metro(rng)
    flat = _live_flat(rng)
    serving, launches = _live_serve(rng)
    record = {"metro_8192": metro, "default_2048": flat,
              "serving": serving}
    print(json.dumps({"live": record}))
    return record, launches


# ── phase 11: dispatch ──────────────────────────────────────────────────

# Drains through the batched dispatch solver: problems per drain, and
# stops per problem (12 as scripts/bench_dispatch.py's problems, 32 the
# default RTPU_DISPATCH_MAX_STOPS).
DISPATCH_BATCHES = (1, 4, 16, 64)
DISPATCH_STOPS = (12, 32)
DISPATCH_REPS = 5
DISPATCH_CPU_REPS = 2
# Over HTTP: concurrent matrix-mode requests, and geographic requests
# with windows at 20 stops over SEED_LOCATIONS.
DISPATCH_CONCURRENT = 64
DISPATCH_GEO_REPS = 10
DISPATCH_PAGES = ("/", "/ui", "/health", "/lib/classify.js",
                  "/lib/dashboard_logic.js", "/lib/missing.js", "/up")
DISPATCH_OPS = ("/api/version", "/api/metrics",
                "/api/metrics?format=prometheus")
# The re-optimization check's RTPU_DISPATCH_DEGRADE_RATIO: the jam (a
# quarter of the speed on the observed corridor edges, blended by
# confidence, routed around where it can) raises the corridor plan's
# cost by about a tenth on the default graph; the far plan's stays
# exactly 1.0.
REOPT_RATIO = 1.05


def _dispatch_problem(rng, n, windows=False, diagonal=False):
    """``scripts/bench_dispatch.py::_problem``'s recipe (points on a
    60×60 square, costs rounded to 0.001, demands 1-3, capacity 7, budget
    500), with about one stop in ten over capacity (demand 9), one in
    twelve unreachable (its depot legs 300 each way), windows that open
    within 50 and close 20-400 later (one in four never closes), and on
    request a non-zero diagonal. → solver arguments."""
    import numpy as np

    from routest_tpu_torch.optimize.vrp import NO_WINDOW

    pts = np.round(rng.random((n + 1, 2)) * 60.0, 3)
    dist = np.round(np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)),
                    3).astype(np.float32)
    demands = rng.integers(1, 4, n).astype(np.float32)
    demands[rng.random(n) < 0.1] = 9.0
    far = 1 + np.flatnonzero(rng.random(n) < 1 / 12)
    dist[0, far] = dist[far, 0] = 300.0
    if diagonal:
        dist[np.diag_indices(n + 1)] = rng.integers(1, 5, n + 1)
    tw_open = tw_close = None
    if windows:
        tw_open = rng.integers(0, 50, n).astype(np.float32)
        tw_close = (tw_open + rng.integers(20, 400, n)).astype(np.float32)
        tw_close[rng.random(n) < 0.25] = NO_WINDOW
    return dist, demands, 7.0, 500.0, tw_open, tw_close


def _dispatch_drains(rng):
    """(1): drains of ``DISPATCH_BATCHES`` × ``DISPATCH_STOPS`` through
    ``solve_host_dispatch_batch`` on the card, every plan bitwise the CPU
    path's; ms per drain, solves/s, syncs, kernels and torch ops per
    drain, the CPU path's ms. → {"<batch>x<stops>": record}."""
    from routest_tpu_torch.optimize.vrp import solve_host_dispatch_batch

    out = {}
    for stops in DISPATCH_STOPS:
        for batch in DISPATCH_BATCHES:
            probs = [_dispatch_problem(rng, stops, windows=i % 4 == 3,
                                       diagonal=i == 0)
                     for i in range(batch)]
            args = [list(x) for x in zip(*probs)]

            def drain(device, args=args):
                return solve_host_dispatch_batch(
                    *args[:4], tw_opens=args[4], tw_closes=args[5],
                    device=device)

            got, want = drain(CARD), drain("cpu")
            for i, (g, w) in enumerate(zip(got, want)):
                check(g == w, f"dispatch {batch}x{stops}: problem {i}'s "
                              f"plan differs from the CPU path: {g} {w}")
            ms = _cpu_ms(lambda: drain(CARD), DISPATCH_REPS)
            work = _device_work(lambda: drain(CARD))
            rec = {"ms_per_drain": ms,
                   "solves_per_s": batch / (ms / 1e3),
                   "syncs_per_drain": work["syncs"],
                   "cuda_kernels_per_drain": work["cuda_kernels"],
                   "cuda_memcpy_per_drain": work["cuda_memcpy"],
                   "torch_ops_per_drain": work["aten_ops"],
                   "cpu_ms_per_drain": _cpu_ms(lambda: drain("cpu"),
                                               DISPATCH_CPU_REPS),
                   "trips": sum(len(p["trips"]) for p in got),
                   "spilled": sum(len(p["spilled"]) for p in got),
                   "unroutable": sum(len(p["unroutable"]) for p in got),
                   "penalty": sum(p["penalty"] for p in got)}
            out[f"{batch}x{stops}"] = rec
            print(f"[dispatch] drain {batch:2d} x {stops} stops on "
                  f"{CARD}: {ms:.2f} ms ({rec['solves_per_s']:.1f} solves/"
                  f"s), {rec['syncs_per_drain']} syncs, "
                  f"{rec['cuda_kernels_per_drain']} kernels, "
                  f"{rec['torch_ops_per_drain']} torch ops; CPU path "
                  f"{rec['cpu_ms_per_drain']:.2f} ms; plans bitwise "
                  f"({rec['trips']} trips, {rec['spilled']} spilled, "
                  f"{rec['unroutable']} unroutable)")
    return out


def _raw(port, path):
    """→ (status, content type, body bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _geo_dispatch_body(rep, n=20, **extra):
    """A geographic body over SEED_LOCATIONS: the warehouse and ``n`` of
    the malls from a rotating start, windows on every third stop."""
    from routest_tpu_torch.data.locations import SEED_LOCATIONS

    malls = SEED_LOCATIONS[1:]
    dests = [{"lat": malls[(rep + i) % len(malls)][1],
              "lon": malls[(rep + i) % len(malls)][2],
              "payload": 1 + (rep + i) % 3} for i in range(n)]
    body = {"source_point": {"lat": SEED_LOCATIONS[0][1],
                             "lon": SEED_LOCATIONS[0][2]},
            "destination_points": dests,
            "driver_details": {"driver_name": f"geo-{rep}",
                               "vehicle_type": "car",
                               "vehicle_capacity": 6 + rep % 4,
                               "maximum_distance": 60_000},
            "time_windows": [[0, None] if i % 3 else
                             [60 * (i % 5), 900 + 120 * i + 30 * rep]
                             for i in range(n)]}
    body.update(extra)
    return body


def _same_dispatch(got, want, path="dispatch"):
    """The card app's dispatch answer against the CPU app's: equal JSON,
    but ``cost``/``baseline_cost``/``penalty`` within rtol 1e-5 plus the
    0.001 rounding step (geographic matrices come from the card's
    haversine)."""
    key = path.rsplit(".", 1)[-1]
    if isinstance(want, dict):
        check(isinstance(got, dict) and set(got) == set(want),
              f"{path}: keys {sorted(got or {})} != {sorted(want)}")
        for k in want:
            _same_dispatch(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        check(isinstance(got, list) and len(got) == len(want),
              f"{path}: length")
        for i, (g, w) in enumerate(zip(got, want)):
            _same_dispatch(g, w, f"{path}[{i}]")
    elif key in ("cost", "baseline_cost", "penalty"):
        check(abs(got - want) <= 1e-5 * abs(want) + 1e-3 + 1e-9,
              f"{path}: {got} vs {want}")
    else:
        check(got == want, f"{path}: {got!r} != {want!r}")


def _dispatch_http(rng):
    """(2) and (4): an app on the card and one on the CPU: concurrent
    matrix-mode requests (merged by the batcher), geographic requests
    with windows, confirm / complete / complete again, confirm_route
    with lat/lon stops, then the pages and ops routes. → record."""
    from routest_tpu_torch.core.config import Config, ServeConfig
    from routest_tpu_torch.serve.ml_service import EtaService

    artifact = os.path.join(ROOT, "artifacts", "eta_mlp.msgpack")
    matrix_bodies = []
    for i in range(DISPATCH_CONCURRENT):
        dist, dem, cap, maxd, o, c = _dispatch_problem(
            rng, 12, windows=i % 4 == 3, diagonal=i == 0)
        body = {"matrix": dist.tolist(), "demands": dem.tolist(),
                "capacity": cap, "max_distance": maxd}
        if o is not None:
            body["time_windows"] = [[float(a), None if b >= 1e30
                                     else float(b)] for a, b in zip(o, c)]
        matrix_bodies.append(body)
    geo_bodies = [_geo_dispatch_body(r) for r in range(DISPATCH_GEO_REPS)]
    confirm = _geo_dispatch_body(DISPATCH_GEO_REPS, n=8, confirm=True,
                                 sim_seed=5)
    confirm["driver_details"].pop("vehicle_type")   # no driver simulation
    route_dests = geo_bodies[0]["destination_points"][:4]
    coords = ([[geo_bodies[0]["source_point"]["lon"],
                geo_bodies[0]["source_point"]["lat"]]]
              + [[d["lon"], d["lat"]] for d in route_dests])
    confirm_route = {
        "route_details": {"geometry": {"coordinates": coords},
                          "properties": {"summary": {"duration": 600,
                                                     "distance": 9000,
                                                     "trips": 1},
                                         "destinations": route_dests}},
        "driver_details": {"driver_name": "confirm-dispatch",
                           "vehicle_type": "car", "vehicle_capacity": 10,
                           "maximum_distance": 80_000}}

    def serve(srv, concurrent):
        answers = {"matrix": [None] * len(matrix_bodies)}
        t0 = time.perf_counter()
        if concurrent:
            barrier = threading.Barrier(len(matrix_bodies))

            def worker(i):
                barrier.wait()
                answers["matrix"][i] = _request(srv.port, "POST",
                                                "/api/dispatch",
                                                matrix_bodies[i])

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(len(matrix_bodies))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            answers["matrix"] = [_request(srv.port, "POST", "/api/dispatch",
                                          b) for b in matrix_bodies]
        answers["matrix_wall_ms"] = (time.perf_counter() - t0) * 1e3
        answers["state"] = _request(srv.port, "GET", "/api/dispatch")
        answers["geo"], answers["geo_ms"] = [], []
        for body in geo_bodies:
            t0 = time.perf_counter()
            answers["geo"].append(_request(srv.port, "POST",
                                           "/api/dispatch", body))
            answers["geo_ms"].append((time.perf_counter() - t0) * 1e3)
        status, conf = _request(srv.port, "POST", "/api/dispatch", confirm)
        answers["confirm"] = (status, conf)
        did = conf.get("dispatch_id")
        answers["complete"] = [_request(srv.port, "POST", "/api/dispatch",
                                        {"complete": did})
                               for _ in range(2)]
        answers["confirm_route"] = _request(srv.port, "POST",
                                            "/api/confirm_route",
                                            confirm_route)
        answers["pages"] = {p: _raw(srv.port, p)
                            for p in DISPATCH_PAGES + DISPATCH_OPS}
        return answers

    cpu_svc = EtaService(ServeConfig(device="cpu"), model_path=artifact,
                         device="cpu")
    with _Server(cpu_svc, Config(serve=ServeConfig(device="cpu"))) as srv:
        want = serve(srv, concurrent=False)
    svc = EtaService(ServeConfig(), model_path=artifact, device=CARD)
    with _Server(svc, Config(serve=ServeConfig(device=CARD))) as srv:
        got = serve(srv, concurrent=True)

    for kind in ("matrix", "geo"):
        for i, (g, w) in enumerate(zip(got[kind], want[kind])):
            check(g[0] == w[0] == 200, f"dispatch {kind} {i}: HTTP {g[0]} "
                                       f"(CPU app {w[0]}): {g[1]}")
            _same_dispatch(g[1], w[1], f"dispatch.{kind}[{i}]")
    batcher = got["state"][1]["batcher"]
    check(batcher["merged_requests"] > 0,
          f"dispatch: {DISPATCH_CONCURRENT} concurrent requests never "
          f"merged: {batcher}")
    check(got["confirm"][0] == want["confirm"][0] == 200,
          f"dispatch confirm: {got['confirm']}")
    _same_dispatch(got["confirm"][1], want["confirm"][1], "dispatch.confirm")
    check([c[0] for c in got["complete"]] == [c[0] for c in
                                              want["complete"]] == [200, 404],
          f"dispatch complete: {got['complete']}")
    check(got["confirm_route"] == want["confirm_route"]
          and "dispatch_id" in got["confirm_route"][1],
          f"confirm_route: {got['confirm_route']} vs "
          f"{want['confirm_route']}")
    for path in DISPATCH_PAGES + DISPATCH_OPS:
        (gs, gt, gb), (ws, wt, wb) = got["pages"][path], want["pages"][path]
        check((gs, gt) == (ws, wt), f"{path}: {gs} {gt} vs {ws} {wt}")
        if path in DISPATCH_PAGES:
            check(gb == wb, f"{path}: the bytes differ from the CPU app's")
        elif "prometheus" not in path:
            check(set(json.loads(gb)) == set(json.loads(wb)),
                  f"{path}: keys differ")
    check(got["pages"]["/lib/missing.js"][0] == 404, "lib: unknown name")
    version = json.loads(got["pages"]["/api/version"][2])
    print(f"[dispatch] http on {CARD}: {DISPATCH_CONCURRENT} concurrent "
          f"matrix requests in {got['matrix_wall_ms']:.1f} ms over "
          f"{batcher['dispatches']} drains ({batcher['merged_requests']} "
          f"merged); geographic 20 stops median "
          f"{_median(got['geo_ms']):.2f} ms (CPU app "
          f"{_median(want['geo_ms']):.2f}); confirm/complete/complete "
          f"200/200/404; confirm_route "
          f"{got['confirm_route'][1]['dispatch_id']}; pages and ops routes "
          f"as the CPU app's")
    return {"concurrent_requests": DISPATCH_CONCURRENT,
            "concurrent_wall_ms": got["matrix_wall_ms"],
            "cpu_sequential_wall_ms": want["matrix_wall_ms"],
            "batcher": batcher,
            "geo_requests": DISPATCH_GEO_REPS,
            "geo_median_ms": _median(got["geo_ms"]),
            "geo_cpu_median_ms": _median(want["geo_ms"]),
            "confirm_route_dispatch_id": got["confirm_route"][1][
                "dispatch_id"],
            "pages": {p: got["pages"][p][0]
                      for p in DISPATCH_PAGES + DISPATCH_OPS},
            "build": version["build"]}


def _dispatch_reopt():
    """(3): re-optimization on a live flip, on the default router (phase
    10's): a corridor flowing, two dispatches confirmed (one along the
    corridor, one far from it), then the corridor jammed; one
    ``ReoptLoop.tick()`` on the card and on the CPU path must re-solve
    exactly the corridor dispatch, stream its ``plan_update`` on its
    channel and agree on the new plan. → record."""
    import types

    import numpy as np

    from routest_tpu_torch.core.config import (Config, DispatchConfig,
                                               ServeConfig)
    from routest_tpu_torch.dispatch import DispatchProblem, plan_cost
    from routest_tpu_torch.optimize import road_router
    from routest_tpu_torch.serve import app as app_mod
    from routest_tpu_torch.serve.bus import InMemoryBus

    card = road_router.default_router(CARD)
    cpu = road_router.default_router("cpu")
    corridor = _live_corridor(card)
    on_cor = np.unique(card.senders[corridor])
    on_cor = on_cor[np.argsort(card.coords[on_cor, 1])]
    cor_nodes = on_cor[np.linspace(0, len(on_cor) - 1, 7).astype(int)]
    # far: the node farthest from the corridor and its 5 nearest nodes
    d2 = ((card.coords[:, None, :] - card.coords[None, on_cor, :]) ** 2
          ).sum(-1).min(axis=1)
    far0 = int(np.argmax(d2))
    near = np.argsort(((card.coords - card.coords[far0]) ** 2).sum(-1))
    far_nodes = near[:6]

    def flip(jam, epoch):
        _live_flip(card, corridor, seed=2, jam=jam)
        metric = card.live_metric_export()
        for router in (card, cpu):
            router.install_live_metric(metric, epoch)

    epoch0 = max(card.live_epoch, cpu.live_epoch) + 1
    flip(False, epoch0)
    sides = {}
    for name, router, device in (("card", card, CARD), ("cpu", cpu, "cpu")):
        bus = InMemoryBus()
        fake = types.SimpleNamespace(
            live=types.SimpleNamespace(ready=True, router=router))
        svc = app_mod._dispatch_service(
            Config(serve=ServeConfig(device=device),
                   dispatch=DispatchConfig(reopt_poll_s=0.0,
                                           degrade_ratio=REOPT_RATIO)),
            fake, bus, (2.0, 5.0))
        recs = []
        for label, nodes in (("corridor", cor_nodes), ("far", far_nodes)):
            latlon = card.coords[nodes].astype(np.float32)
            n = len(nodes) - 1
            matrix = svc.matrix_fn(latlon)
            dem = np.ones(n, np.float32)
            plan = svc.batcher.solve([DispatchProblem(
                matrix, dem, 3.0, 1e6)])[0]
            recs.append(svc.registry.register(
                channel=f"reopt-{label}", latlon=latlon, demands=dem,
                capacity=3.0, max_cost=1e6, plan=plan,
                baseline_cost=plan_cost(matrix, plan),
                epoch=svc.epoch_fn()))
        check(svc.reopt.tick()["result"] == "armed", "reopt: not armed")
        subs = {r.channel: bus.subscribe(r.channel) for r in recs}
        sides[name] = (svc, recs, subs)
    cor_rec, far_rec = sides["card"][1]
    check([r.plan for r in sides["card"][1]]
          == [r.plan for r in sides["cpu"][1]],
          "reopt: the confirmed plans differ from the CPU path's")

    cor_base = cor_rec.baseline_cost
    flip(True, epoch0 + 1)
    ticks, frames, t_tick = {}, {}, {}
    for name, (svc, recs, subs) in sides.items():
        t0 = time.perf_counter()
        ticks[name] = svc.reopt.tick()
        t_tick[name] = (time.perf_counter() - t0) * 1e3
        frames[name] = {ch: sub.get(timeout=5.0)
                        for ch, sub in subs.items()}
        for sub in subs.values():
            sub.close()
    tick = ticks["card"]
    check(tick["result"] == "resolved"
          and tick["resolved"] == [cor_rec.id]
          and tick["degraded"] == [cor_rec.id],
          f"reopt: not exactly the corridor dispatch re-solved: {tick}")
    check(ticks["cpu"]["resolved"] == tick["resolved"],
          f"reopt: the CPU path re-solved {ticks['cpu']}")
    ev = frames["card"][cor_rec.channel]
    check(ev is not None and ev.get("event") == "plan_update"
          and ev["dispatch_id"] == cor_rec.id
          and ev["epoch"] == epoch0 + 1,
          f"reopt: no plan_update on {cor_rec.channel}: {ev}")
    check(frames["card"][far_rec.channel] is None,
          f"reopt: a frame on the far channel: "
          f"{frames['card'][far_rec.channel]}")
    _same_dispatch(ev, frames["cpu"][cor_rec.channel], "reopt.plan_update")
    rec = {"corridor_edges": int(len(corridor)),
           "corridor_stops": len(cor_nodes) - 1,
           "far_stops": len(far_nodes) - 1,
           "resolved": tick["resolved"], "checked": tick["checked"],
           "previous_cost": ev["reason"]["previous_cost"],
           "new_cost": ev["reason"]["new_cost"],
           "corridor_ratio": ev["reason"]["previous_cost"]
           / max(cor_base, 1e-9),
           "far_ratio": plan_cost(sides["card"][0].matrix_fn(far_rec.latlon),
                                  far_rec.plan) / far_rec.baseline_cost,
           "tick_ms": t_tick["card"], "cpu_tick_ms": t_tick["cpu"]}
    print(f"[dispatch] reopt: flip to epoch {epoch0 + 1} re-solved "
          f"{tick['resolved']} of {tick['checked']} (corridor plan "
          f"ratio {rec['corridor_ratio']:.4f}, cost {rec['previous_cost']} "
          f"→ {rec['new_cost']}; far plan ratio {rec['far_ratio']:.4f}); "
          f"plan_update on {cor_rec.channel}, "
          f"equal to the CPU path's; tick {rec['tick_ms']:.1f} ms (CPU "
          f"path {rec['cpu_tick_ms']:.1f})")
    return rec


def phase_dispatch():
    """Dispatch on the card: (1) solver drains held bitwise against the
    CPU path, (2) dispatch over HTTP against an app on the CPU, (3)
    re-optimization on a live flip, (4) the pages and ops routes. →
    record."""
    import numpy as np
    import torch

    rng = np.random.default_rng(11)
    record = {"device": torch.cuda.get_device_name(0) if CARD == "cuda"
              else CARD}
    record["drains"] = _dispatch_drains(rng)
    record["http"] = _dispatch_http(rng)
    record["reopt"] = _dispatch_reopt()
    print(json.dumps({"dispatch": record}))
    return record


# ── phase 12: the serving core ──────────────────────────────────────────

# Wire frames: the batch endpoint's largest bucket, and the most rows a
# frame may hold (MAX_BATCH_ROWS: 32 launches at bucket 4096).
WIRE_ROWS = (4096, 131_072)
# Timed 4096-row requests per transport (JSON, wire over HTTP, channel).
WIRE_REPS = 10
# /api/predict_eta traffic threads during the ETA hot swap.
SWAP_THREADS = 8
# use_ml_eta optimize requests persisted through PostgREST, then more
# while it is down (journaled).
PERSIST_REQUESTS = 20
PERSIST_OUTAGE_REQUESTS = 5
WIRE_CT = "application/x-rtpu-wire"


def _http(port, method, path, body=b"", headers=None, timeout=300):
    """→ (status, {header: value} with Set-Cookie as a list, body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        head = {}
        for k, v in resp.getheaders():
            if k.lower() == "set-cookie":
                head.setdefault("Set-Cookie", []).append(v)
            else:
                head[k] = v
        return resp.status, head, resp.read()
    finally:
        conn.close()


def _wire_batch(rng, n):
    """A seeded columnar body of ``n`` rows and the same rows as an RTW1
    frame, featurized as the JSON path featurizes them."""
    import numpy as np

    from routest_tpu_torch.serve import wirecodec

    weather = ["Cloudy", "Stormy", "Sunny", "Windy", "Fog"]
    traffic = ["High", "Jam", "Low", "Medium", "Gridlock"]
    body = {"distance_m": rng.uniform(200.0, 40_000.0, n).round(1).tolist(),
            "weather": [weather[i] for i in rng.integers(0, 5, n)],
            "traffic": [traffic[i] for i in rng.integers(0, 5, n)],
            "driver_age": rng.integers(18, 70, n).astype(float).tolist(),
            "pickup_time": [
                (dt.datetime(2026, 10, 12) + dt.timedelta(minutes=int(m)))
                .isoformat() for m in rng.integers(0, 7 * 24 * 60, n)]}
    pickups = [dt.datetime.fromisoformat(p) for p in body["pickup_time"]]
    pickup_ms = np.asarray([np.datetime64(p, "ms") for p in pickups],
                           "datetime64[ms]").astype(np.int64)
    frame = wirecodec.encode_eta_request(
        np.asarray(_batch_rows(body), np.float32), pickup_ms)
    return json.dumps(body).encode(), frame


def _same_as_json(wire_raw, json_raw, what):
    """A wire answer against the JSON answer on the same rows: minutes,
    bands (rounded as the JSON path rounds) and completion stamps
    bitwise."""
    import numpy as np

    from routest_tpu_torch.serve import wirecodec

    wire = wirecodec.decode_eta_response(wire_raw)
    js = json.loads(json_raw)
    n = js["count"]
    check(len(wire["minutes"]) == n, f"{what}: {len(wire['minutes'])} rows")
    pairs = [("eta_minutes_ml", wire["minutes"])] + [
        (f"eta_minutes_ml_{k}", v) for k, v in wire["bands"].items()]
    check(sorted(k for k, _ in pairs)
          == sorted(k for k in js if k.startswith("eta_minutes_ml")),
          f"{what}: columns")
    for key, col in pairs:
        want = np.asarray([np.nan if v is None else v for v in js[key]],
                          np.float64)
        check(np.round(col, 4).tobytes() == want.tobytes(),
              f"{what}: {key} not bitwise the JSON path's")
    ms = np.asarray(wire["completion_ms"], np.int64)
    iso = np.datetime_as_string(ms.astype("datetime64[ms]"), unit="s")
    check([None if m == wirecodec.COMPLETION_NAT else str(s)
           for m, s in zip(ms, iso)] == js["eta_completion_time_ml"],
          f"{what}: completion stamps")
    check(np.isfinite(wire["minutes"]).all()
          and (wire["bands"]["p10"] <= wire["minutes"]).all()
          and (wire["minutes"] <= wire["bands"]["p90"]).all(),
          f"{what}: band or finiteness")


def _wire_phase(rng, artifact):
    """(a): the HTTP negotiation and the channel on the card, then
    ``python -m routest_tpu_torch.serve`` with ``RTPU_WIRE=1``."""
    import signal
    import tempfile

    from routest_tpu_torch.core.config import ServeConfig
    from routest_tpu_torch.ops.fused_mlp import fused_eta_forward
    from routest_tpu_torch.serve import wirecodec
    from routest_tpu_torch.serve.ml_service import EtaService
    from routest_tpu_torch.serve.wirechannel import (WireChannelClient,
                                                     WireChannelServer)

    svc = EtaService(ServeConfig(), model_path=artifact, device=CARD)
    check(svc.available, f"wire: EtaService not serving: {svc.load_error}")
    os.environ["RTPU_WIRE"] = "1"
    try:
        srv = _Server(svc)
    finally:
        os.environ.pop("RTPU_WIRE")
    batches = {n: _wire_batch(rng, n) for n in WIRE_ROWS}
    rec = {"rows": {}}
    launches = 0
    with srv:
        port = srv.port
        chan = WireChannelServer(srv.server.get_app().wire_handlers,
                                 "127.0.0.1", 0)
        chan.start()
        client = WireChannelClient("127.0.0.1", chan.port)
        try:
            for n, (body, frame) in batches.items():
                fused_eta_forward.launches = 0
                status, head, wire_raw = _http(
                    port, "POST", "/api/predict_eta_batch", frame,
                    {"Content-Type": WIRE_CT})
                wire_launches = fused_eta_forward.launches
                launches += wire_launches
                check(status == 200 and head["Content-Type"] == WIRE_CT,
                      f"wire {n}: {status}")
                status, _, json_raw = _http(
                    port, "POST", "/api/predict_eta_batch", body,
                    {"Content-Type": "application/json"})
                check(status == 200, f"json {n}: {status}")
                _same_as_json(wire_raw, json_raw, f"wire {n} rows")
                fused_eta_forward.launches = 0
                status, chan_raw = client.request(
                    "/api/predict_eta_batch", frame, timeout=300)
                launches += fused_eta_forward.launches
                check(status == 200 and chan_raw == wire_raw,
                      f"channel {n}: {status}, not the HTTP frame")
                rec["rows"][n] = {"wire_launches": wire_launches,
                                  "frame_bytes": len(frame),
                                  "json_bytes": len(body),
                                  "response_frame_bytes": len(wire_raw),
                                  "json_response_bytes": len(json_raw)}
            if CARD == "cuda":
                check(rec["rows"][4096]["wire_launches"] == 1
                      and rec["rows"][131_072]["wire_launches"] == 32,
                      f"wire launches {rec['rows']}")
            body, frame = batches[4096]
            times = {"json": [], "wire": [], "channel": []}
            for _ in range(WIRE_REPS):
                for kind in times:
                    t0 = time.perf_counter()
                    if kind == "channel":
                        status, _ = client.request("/api/predict_eta_batch",
                                                   frame)
                    else:
                        status, _, _ = _http(
                            port, "POST", "/api/predict_eta_batch",
                            body if kind == "json" else frame,
                            {"Content-Type": "application/json"
                             if kind == "json" else WIRE_CT})
                    times[kind].append((time.perf_counter() - t0) * 1e3)
                    check(status == 200, f"timed {kind}: {status}")
            rec["median_ms_4096"] = {k: _median(v) for k, v in times.items()}
            status, head, raw = _http(port, "POST", "/api/predict_eta_batch",
                                      b"RTW1junk", {"Content-Type": WIRE_CT})
            code, message = wirecodec.decode_error_frame(raw)
            check(status == 400 and code == 400 and "malformed" in message,
                  f"malformed frame: {status} {message}")
        finally:
            client.close()
            chan.stop()
    with _Server(svc) as off:  # RTPU_WIRE unset: the same request → 415
        status, _, raw = _http(off.port, "POST", "/api/predict_eta_batch",
                               batches[4096][1], {"Content-Type": WIRE_CT})
        check(status == 415 and "RTPU_WIRE" in json.loads(raw)["error"],
              f"wire off: {status}")
    # the server entry point: the channel it starts, and its log's
    # launch counts
    port, wire_port = _free_port(), _free_port()
    env = dict(os.environ, PORT=str(port), RTPU_HOST="127.0.0.1",
               RTPU_WIRE="1", RTPU_WIRE_PORT=str(wire_port),
               ROUTEST_DEVICE=CARD, ETA_MODEL_PATH=artifact)
    log = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, "-m", "routest_tpu_torch.serve"],
                            cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    try:
        _, boot_s = _wait_for("ping", lambda: _request(
            port, "GET", "/api/ping")[0] == 200, 300, proc)
        client = WireChannelClient("127.0.0.1", wire_port)
        try:
            status, raw = client.request("/api/predict_eta_batch",
                                         batches[4096][1], timeout=120)
        finally:
            client.close()
        check(status == 200, f"server channel: {status}")
        _, _, json_raw = _http(port, "POST", "/api/predict_eta_batch",
                               batches[4096][0],
                               {"Content-Type": "application/json"})
        _same_as_json(raw, json_raw, "server channel")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.seek(0)
        text = log.read()
        log.close()
    check(proc.returncode in (0, -signal.SIGTERM),
          f"wire server exited {proc.returncode}: {text[-2000:]}")
    events = [json.loads(line) for line in text.splitlines()
              if line.startswith("{")]
    names = {e.get("event") for e in events}
    check("wire_channel_listening" in names, "server: no wire channel")
    counts = {e["event"]: e["fused_launches"] for e in events
              if e.get("event") in ("serve_listening", "serve_stopped")}
    server_launches = counts["serve_stopped"] - counts["serve_listening"]
    if CARD == "cuda":
        check(server_launches == 2, f"server launches {server_launches}")
    rec.update(server_boot_s=boot_s, server_launches=server_launches)
    m = rec["median_ms_4096"]
    print(f"[serving-core] wire: 4096 and 131072 rows bitwise the JSON "
          f"path (minutes, bands, stamps) over HTTP and the channel; "
          f"launches per request "
          f"{[r['wire_launches'] for r in rec['rows'].values()]}; median "
          f"ms per 4096-row request: JSON {m['json']:.2f}, wire "
          f"{m['wire']:.2f}, channel {m['channel']:.2f}; 400 error frame, "
          f"415 with wire off; the server's channel answered "
          f"({server_launches} launches, boot {boot_s:.1f} s)")
    return rec, launches


def _swap_phase(artifact_dir):
    """(b): the ETA model hot-swapped under concurrent traffic, then a
    truncated replacement rejected."""
    import shutil

    from routest_tpu_torch.core.config import ServeConfig
    from routest_tpu_torch.obs import get_registry
    from routest_tpu_torch.ops.fused_mlp import fused_eta_forward
    from routest_tpu_torch.serve.ml_service import EtaService, golden_batch

    point = os.path.join(ROOT, "artifacts", "eta_mlp_point.msgpack")
    quantile = os.path.join(ROOT, "artifacts", "eta_mlp.msgpack")
    path = os.path.join(artifact_dir, "eta_served.msgpack")
    shutil.copyfile(point, path)
    svc = EtaService(ServeConfig(reload_sec=0.2), model_path=path,
                     device=CARD)
    check(svc.available and svc.quantiles == (), "swap: point model")
    swaps = get_registry().counter("rtpu_model_swaps_total", "",
                                   ("result",))
    rejected0 = swaps.labels(result="rejected").value
    gen0 = svc.generation
    stop = threading.Event()
    results, failures = [], []
    flip = {}

    def traffic(k):
        i = 0
        while not stop.is_set():
            i += 1
            t0 = time.perf_counter()
            try:
                status, out = _request(port, "POST", "/api/predict_eta", {
                    "summary": {"distance": 1000 + 37 * i + k},
                    "weather": "Stormy", "traffic": "Jam",
                    "pickup_time": "2026-10-16T08:30:00",
                    "driver_age": 30 + k})
                results.append((t0, status, out))
            except Exception as e:
                failures.append(f"{type(e).__name__}: {e}")

    def watch():
        # the flip is done once the model field follows the serving
        # reference (the last of the fields a swap copies)
        while not stop.is_set():
            if svc.quantiles and "t" not in flip:
                flip["t"] = time.perf_counter()
            time.sleep(0.001)

    with _Server(svc) as srv:
        port = srv.port
        threads = [threading.Thread(target=traffic, args=(k,))
                   for k in range(SWAP_THREADS)]
        threads.append(threading.Thread(target=watch))
        for t in threads:
            t.start()
        try:
            time.sleep(1.0)
            with open(quantile, "rb") as f:
                data = f.read()
            with open(path + ".tmp", "wb") as f:
                f.write(data)
            t_replace = time.perf_counter()
            os.replace(path + ".tmp", path)
            deadline = time.perf_counter() + 60
            while "t" not in flip and time.perf_counter() < deadline:
                time.sleep(0.01)
            check("t" in flip, "swap: the generation never moved")
            swap_s = flip["t"] - t_replace
            time.sleep(1.0)
            gen1, fp1 = svc.generation, svc.fingerprint
            # a truncated replacement: rejected, the quantile model serves
            with open(path + ".tmp", "wb") as f:
                f.write(data[: len(data) // 2])
            os.replace(path + ".tmp", path)
            deadline = time.perf_counter() + 30
            while (swaps.labels(result="rejected").value == rejected0
                   and time.perf_counter() < deadline):
                time.sleep(0.05)
            time.sleep(0.5)
        finally:
            stop.set()
            for t in threads:
                t.join(60)
            svc._watcher_stop.set()
    check(not any(t.is_alive() for t in threads), "swap: traffic hung")
    check(not failures, f"swap: {len(failures)} failed: {failures[:3]}")
    bad = [(s, o) for _, s, o in results if s != 200]
    check(not bad, f"swap: {len(bad)} non-200 answers: {bad[:3]}")
    after = pre = torn = 0
    for t0, _, out in results:
        band = {"eta_minutes_ml_p10", "eta_minutes_ml_p90"} & set(out)
        if band and (len(band) != 2 or not (
                out["eta_minutes_ml_p10"] <= out["eta_minutes_ml"]
                <= out["eta_minutes_ml_p90"])):
            torn += 1
        if t0 > flip["t"]:
            after += 1
            check(len(band) == 2, f"swap: a band missing after the flip "
                                  f"{out}")
        elif not band:
            pre += 1
    check(torn == 0, f"swap: {torn} torn answers")
    check(gen1 == gen0 + 1 and svc.quantiles == (0.1, 0.5, 0.9),
          f"swap: generation {gen0} → {gen1}")
    check(swaps.labels(result="rejected").value == rejected0 + 1
          and svc.generation == gen1 and svc.fingerprint == fp1
          and svc.available, "swap: the truncated file was not rejected")
    # the gate alone, on a quiet service: the golden batch on the
    # replacement's batcher (and the live model's compare)
    fresh = EtaService(ServeConfig(), model_path=quantile, device=CARD)
    flushes = fresh._batcher.stats["flushes"]
    fused_eta_forward.launches = 0
    ok, verdict = svc._verify_swap(fresh)
    golden_launches = fused_eta_forward.launches
    golden_flushes = fresh._batcher.stats["flushes"] - flushes
    check(ok and verdict.get("divergence") == 0.0,
          f"swap gate: {ok} {verdict}")
    if CARD == "cuda":
        check(golden_flushes == 1 and golden_launches == 2,
              f"swap gate launches {golden_launches}, flushes "
              f"{golden_flushes}")
    rec = {"requests": len(results), "failed": 0, "torn": 0,
           "point_answers_before_flip": pre, "answers_after_flip": after,
           "swap_s": swap_s, "generation": [gen0, gen1],
           "rejected_truncated": True, "golden_launches": golden_launches,
           "golden_flushes_replacement": golden_flushes,
           "golden_rows": len(golden_batch())}
    print(f"[serving-core] swap: {len(results)} /api/predict_eta answers "
          f"from {SWAP_THREADS} threads, 0 failed, 0 torn; point → quantile "
          f"flip {swap_s:.3f} s after the file was replaced (generation "
          f"{gen0} → {gen1}), {after} answers after it all banded; the "
          f"truncated copy rejected; golden gate {golden_launches} launches "
          f"({golden_flushes} on the replacement)")
    return rec


def _persist_phase(artifact):
    """(c): optimize persisted through the in-repo fake PostgREST, an
    outage journaled, the restart replayed."""
    import importlib.util

    import numpy as np

    from routest_tpu_torch.core.config import load_config
    from routest_tpu_torch.obs import get_registry
    from routest_tpu_torch.serve.ml_service import EtaService

    # by path: an installed package named ``tests`` would shadow the
    # repository's (a directory without ``__init__.py``)
    spec = importlib.util.spec_from_file_location(
        "fake_postgrest", os.path.join(ROOT, "tests", "fake_postgrest.py"))
    fake = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fake)
    start_fake_postgrest = fake.start_fake_postgrest

    pg, pg_thread, url = start_fake_postgrest()
    pg_port = pg.server_address[1]
    env = {"SUPABASE_URL": url, "SUPABASE_SERVICE_ROLE_KEY": "smoke-key",
           "RTPU_STORE_COOLDOWN_S": "0.5", "ROUTEST_DEVICE": CARD}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        config = load_config()
        svc = EtaService(config.serve, model_path=artifact, device=CARD)
        srv = _Server(svc, config)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    acked, ms = [], []
    pg2 = None

    def optimize(rep):
        t0 = time.perf_counter()
        status, out = _request(port, "POST", "/api/optimize_route",
                               _opt_body(3, rep, **_ML))
        ms.append((time.perf_counter() - t0) * 1e3)
        props = (out or {}).get("properties") or {}
        check(status == 200 and props.get("saved") is True
              and np.isfinite(props.get("eta_minutes_ml", np.nan)),
              f"persist: optimize {status} {props.get('saved')}")
        acked.append(props["request_id"])
        return props

    try:
        with srv:
            port = srv.port
            check(srv.server.get_app().store.kind == "postgrest",
                  "persist: not the PostgREST store")
            for rep in range(PERSIST_REQUESTS):
                optimize(rep)
            _, hist = _request(port, "GET", "/api/history?limit=100")
            check(sorted(i["request_id"] for i in hist["items"])
                  == sorted(acked), "persist: history before the outage")
            state = pg.state
            pg.shutdown()
            pg.server_close()
            pg_thread.join(10)
            t_down = time.perf_counter()
            for rep in range(PERSIST_OUTAGE_REQUESTS):
                check(optimize(PERSIST_REQUESTS + rep).get("degraded")
                      is True, "persist: outage write not marked degraded")
            status, hist = _request(port, "GET", "/api/history")
            check(status == 200 and hist == {"items": [], "degraded": True},
                  f"persist: history in the outage {status} {hist}")
            status, one = _request(port, "GET", f"/api/history/{acked[0]}")
            check(status == 503 and one.get("degraded") is True,
                  f"persist: detail in the outage {status} {one}")
            _, health = _request(port, "GET", "/api/health")
            journal = health["checks"]["store"]["resilience"]["journal_depth"]
            check(journal == 2 * PERSIST_OUTAGE_REQUESTS,
                  f"persist: journal depth {journal}")
            pg2, pg2_thread, _ = start_fake_postgrest(pg_port)
            pg2.state = state  # the database restarts with its rows
            t_up = time.perf_counter()
            while True:
                _, health = _request(port, "GET", "/api/health")
                store = health["checks"]["store"]
                if store["status"] == "ok" and \
                        store["resilience"]["journal_depth"] == 0:
                    break
                check(time.perf_counter() - t_up < 30,
                      f"persist: no replay {store}")
                time.sleep(0.1)
            replay_s = time.perf_counter() - t_up
            _, hist = _request(port, "GET", "/api/history?limit=100")
            check(sorted(i["request_id"] for i in hist["items"])
                  == sorted(acked), "persist: an acknowledged write lost")
            for rid in acked:
                status, one = _request(port, "GET", f"/api/history/{rid}")
                check(status == 200 and one["result"] is not None
                      and one["result"]["eta_minutes_ml"] is not None,
                      f"persist: {rid} read back {status}")
    finally:
        if pg2 is not None:
            pg2.shutdown()
            pg2.server_close()
            pg2_thread.join(10)
    hist = get_registry().get("rtpu_store_op_seconds")
    op_ms = {f"{op}/{backend}": {"n": child.count,
                                 "median_ms": child.quantile(0.5) * 1e3}
             for (op, backend), child in hist.items()
             if backend == "postgrest"}
    rec = {"acknowledged": len(acked), "read_back": len(acked),
           "outage_writes": PERSIST_OUTAGE_REQUESTS,
           "journal_depth": journal, "replay_s": replay_s,
           "outage_s": t_up - t_down,
           "optimize_median_ms": _median(ms), "store_op_ms": op_ms}
    ops = ", ".join(f"{k} {v['median_ms']:.2f} ms (n {v['n']})"
                    for k, v in sorted(op_ms.items()))
    print(f"[serving-core] persistence: {len(acked)} acknowledged "
          f"use_ml_eta optimize writes, {PERSIST_OUTAGE_REQUESTS} of them "
          f"journaled in the outage (depth {journal}), replayed "
          f"{replay_s:.2f} s after the restart, every one read back; store "
          f"op medians (histogram): {ops}")
    return rec


def _auth_phase(artifact):
    """(d): ``ROUTEST_AUTH=require`` boots and gates the DELETE; the
    Sanctum cookie flow."""
    from routest_tpu_torch.core.config import ServeConfig
    from routest_tpu_torch.serve.ml_service import EtaService

    svc = EtaService(ServeConfig(), model_path=artifact, device=CARD)
    os.environ["ROUTEST_AUTH"] = "require"
    try:
        srv = _Server(svc)
    finally:
        os.environ.pop("ROUTEST_AUTH")
    with srv:
        port = srv.port
        status, reg = _request(port, "POST", "/api/auth/register", {
            "name": "Smoke", "email": "smoke@example.com",
            "password": "s3cretpass"})
        check(status == 201 and reg.get("token"), f"register: {status}")
        status, login = _request(port, "POST", "/api/auth/login", {
            "email": "smoke@example.com", "password": "s3cretpass"})
        check(status == 200 and login.get("token"), f"login: {status}")
        bearer = {"Authorization": f"Bearer {login['token']}"}
        _, route = _request(port, "POST", "/api/optimize_route",
                            _opt_body(3, 0))
        rid = route["properties"]["request_id"]
        status, _, _ = _http(port, "DELETE", f"/api/history/{rid}")
        check(status == 401, f"DELETE without a bearer: {status}")
        status, _, _ = _http(port, "DELETE", f"/api/history/{rid}",
                             headers=bearer)
        check(status == 204, f"DELETE with a bearer: {status}")
        status, head, _ = _http(port, "GET", "/sanctum/csrf-cookie")
        xsrf_line = head.get("Set-Cookie", [""])[0]
        xsrf = xsrf_line.split(";", 1)[0].split("=", 1)[1]
        check(status == 204 and xsrf_line.startswith("XSRF-TOKEN=")
              and "SameSite=Lax" in xsrf_line, f"csrf cookie: {xsrf_line}")
        status, head, _ = _http(
            port, "POST", "/api/auth/login", json.dumps({
                "email": "smoke@example.com", "password": "s3cretpass"}),
            {"Content-Type": "application/json", "X-XSRF-TOKEN": xsrf,
             "Cookie": f"XSRF-TOKEN={xsrf}"})
        session = [c for c in head.get("Set-Cookie", [])
                   if c.startswith("routest_session=")]
        check(status == 200 and session and "HttpOnly" in session[0],
              f"session cookie: {head.get('Set-Cookie')}")
        token = session[0].split(";", 1)[0].split("=", 1)[1]
        status, _, raw = _http(port, "GET", "/api/user", headers={
            "Cookie": f"XSRF-TOKEN={xsrf}; routest_session={token}"})
        check(status == 200 and json.loads(raw)["email"]
              == "smoke@example.com", f"/api/user by cookie: {status}")
    print("[serving-core] auth: ROUTEST_AUTH=require booted; register 201, "
          "login 200, DELETE /api/history/<id> 401 without a bearer and "
          "204 with one; the Sanctum flow set XSRF-TOKEN and an HttpOnly "
          "routest_session that /api/user accepts")
    return {"register": 201, "login": 200, "delete_without_bearer": 401,
            "delete_with_bearer": 204, "cookies": ["XSRF-TOKEN",
                                                   "routest_session"]}


def _gnn_swap_phase(artifact_dir):
    """(e): the road GNN hot-swapped on the card: a foreign and a
    truncated artifact rejected, a Manila install and a default re-install
    accepted."""
    import shutil

    import numpy as np

    from routest_tpu_torch.data.osm import load_osm
    from routest_tpu_torch.optimize.road_router import RoadRouter

    default_gnn = os.path.join(ROOT, "artifacts", "road_gnn.msgpack")
    manila_gnn = os.path.join(ROOT, MANILA_GNN)
    path = os.path.join(artifact_dir, "road_gnn_served.msgpack")
    shutil.copyfile(default_gnn, path)

    def replace(src_bytes):
        with open(path + ".tmp", "wb") as f:
            f.write(src_bytes)
        os.replace(path + ".tmp", path)

    def route(router):
        pts = router.coords[[0, len(router.coords) // 2, -1]]
        return router.route_legs(pts, hour=8)

    with open(default_gnn, "rb") as f:
        default_bytes = f.read()
    with open(manila_gnn, "rb") as f:
        manila_bytes = f.read()
    router = RoadRouter(gnn_path=path, device=CARD)
    check(router.leg_cost_model == "gnn", "gnn swap: no GNN on the default")
    gen0, live = router._model_gen, router._gnn
    table = router.edge_time_s(8).copy()
    replace(manila_bytes)  # another graph's artifact: the gate refuses it
    check(route(router).cost_model == "gnn" and router._gnn is live
          and router._model_gen == gen0, "gnn swap: foreign accepted")
    replace(default_bytes[: len(default_bytes) // 2])
    check(route(router).cost_model == "gnn" and router._gnn is live
          and router._model_gen == gen0, "gnn swap: truncated accepted")
    t0 = time.perf_counter()
    replace(default_bytes)
    legs = route(router)
    swap_s = time.perf_counter() - t0
    check(legs.cost_model == "gnn" and router._model_gen == gen0 + 1
          and router._gnn is not live, "gnn swap: re-install refused")
    check(np.allclose(router.edge_time_s(8), table, rtol=ROAD_DURATION_RTOL),
          "gnn swap: the re-installed GNN prices differently")
    # the Manila deployment: free-flow until its artifact arrives
    graph = load_osm(os.path.join(ROOT, MANILA_OSM))
    mpath = os.path.join(artifact_dir, "road_gnn_manila_served.msgpack")
    manila = RoadRouter(graph=graph, gnn_path=mpath, use_transformer=False,
                        device=CARD)
    check(route(manila).cost_model == "freeflow", "manila: GNN too early")
    mgen = manila._model_gen
    with open(mpath + ".tmp", "wb") as f:
        f.write(manila_bytes)
    os.replace(mpath + ".tmp", mpath)
    check(route(manila).cost_model == "gnn"
          and manila._model_gen == mgen + 1, "manila: install refused")
    want = RoadRouter(graph=graph, gnn_path=manila_gnn,
                      use_transformer=False, device=CARD).edge_time_s(8)
    check(np.allclose(manila.edge_time_s(8), want, rtol=ROAD_DURATION_RTOL),
          "manila: swapped GNN prices differ from a fresh router's")
    print(f"[serving-core] gnn swap: the default router refused Manila's "
          f"artifact and a truncated file, re-installed its own in "
          f"{swap_s * 1e3:.1f} ms (generation {gen0} → {gen0 + 1}, the "
          f"same prices); the Manila router went free-flow → gnn (generation "
          f"{mgen} → {mgen + 1}), prices within rtol {ROAD_DURATION_RTOL} of "
          f"a fresh router's")
    return {"default": {"generation": [gen0, gen0 + 1],
                        "rejected": ["foreign", "truncated"],
                        "reinstall_ms": swap_s * 1e3},
            "manila": {"generation": [mgen, mgen + 1]}}


def phase_serving_core():
    """Phase 12: (a) the wire path, (b) the ETA hot swap, (c) PostgREST
    persistence through an outage, (d) auth, (e) the GNN hot swap. →
    (record, fused launches over (a)'s wire requests)."""
    import shutil
    import tempfile

    import numpy as np

    rng = np.random.default_rng(12)
    artifact = os.path.join(ROOT, "artifacts", "eta_mlp.msgpack")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    artifact_dir = tempfile.mkdtemp(prefix="serving-core-",
                                    dir=os.path.join(ROOT, "build"))
    try:
        wire, launches = _wire_phase(rng, artifact)
        record = {"wire": wire, "swap": _swap_phase(artifact_dir),
                  "persist": _persist_phase(artifact),
                  "auth": _auth_phase(artifact),
                  "gnn_swap": _gnn_swap_phase(artifact_dir)}
    finally:
        shutil.rmtree(artifact_dir, ignore_errors=True)
    print(json.dumps({"serving_core": record}))
    return record, launches


# ── phase 13: training ──────────────────────────────────────────────────

# scripts/train_eta.py's defaults: 500,000 rows (the committed baseline's
# 450k/50k split), 30 epochs, seed 0; its acceptance margins.
TRAIN_ROWS = 500_000
TRAIN_EPOCHS = 30
POINT_MARGIN = 1.02
QUANTILE_MARGIN = 1.10
COVERAGE_TOL = 0.02
# Extra arguments of (b)'s CLI run (none: the defaults; a CPU rehearsal
# passes a shorter run).
TRAIN_CLI_ARGS = ()
# (c): card against the CPU path, F32_POLICY, on the same batches.
PARITY_STEPS = 20
PARITY_RTOL, PARITY_ATOL = 1e-4, 1e-6
# (g): a seeded XGBoost-schema ensemble.
GBDT_TREES = 300
GBDT_DEPTH = 8
GBDT_ROWS = 4096
GBDT_NAN_FRAC = 0.01
GBDT_REPS = 20


def _baseline_rmse():
    from routest_tpu_torch.train.baseline import load_baseline

    record = load_baseline()
    check(record is not None
          and record["n_train"] + record["n_eval"] == TRAIN_ROWS,
          f"train: no committed baseline for {TRAIN_ROWS} rows: {record}")
    return float(record["rmse_minutes"])


def _train_fit(baseline):
    """(a) ``fit`` at the script's defaults on the card, and the kernels
    and syncs of one step. → record."""
    import torch

    from routest_tpu_torch.core import prng
    from routest_tpu_torch.core.config import TrainConfig
    from routest_tpu_torch.data.features import batch_from_mapping
    from routest_tpu_torch.data.synthetic import (generate_dataset,
                                                  train_eval_split)
    from routest_tpu_torch.models.eta_mlp import EtaMLP, fit_normalizer
    from routest_tpu_torch.train.loop import (fit, make_optimizer,
                                              make_train_step)

    train, ev = train_eval_split(generate_dataset(TRAIN_ROWS, seed=0))
    t0 = time.perf_counter()
    result = fit(EtaMLP(), train, ev, TrainConfig(epochs=TRAIN_EPOCHS),
                 device=CARD)
    if CARD == "cuda":
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps = result.optimizer.count
    check(result.eval_rmse <= baseline * POINT_MARGIN,
          f"train (a): eval RMSE {result.eval_rmse:.4f} > baseline "
          f"{baseline:.4f} × {POINT_MARGIN}")
    # One step on a throwaway model: kernels, copies and syncs.
    x = batch_from_mapping(train)
    model = EtaMLP().init(prng.prng_key(0), *fit_normalizer(x)).to(CARD)
    step = make_train_step(model, make_optimizer(model, TrainConfig()))
    xb = torch.from_numpy(x[:8192]).to(CARD)
    yb = torch.from_numpy(train["eta_minutes"][:8192]).to(CARD)
    wb = torch.ones(8192, device=CARD)
    work = _device_work(lambda: step(xb, yb, wb))
    rec = {"rows": TRAIN_ROWS, "epochs": TRAIN_EPOCHS, "steps": steps,
           "eval_rmse": result.eval_rmse, "baseline_rmse": baseline,
           "rmse_ratio": result.eval_rmse / baseline, "fit_s": fit_s,
           "steps_per_s": steps / fit_s, "ms_per_step": fit_s * 1e3 / steps,
           "final_loss": result.train_losses[-1], "step": work}
    print(f"[train] (a) fit {TRAIN_ROWS} rows × {TRAIN_EPOCHS} epochs on "
          f"{CARD}: eval RMSE {result.eval_rmse:.4f} (baseline "
          f"{baseline:.4f}, ratio {rec['rmse_ratio']:.4f}); {fit_s:.2f} s, "
          f"{steps} steps, {rec['steps_per_s']:.1f} steps/s, "
          f"{rec['ms_per_step']:.3f} ms/step; one step: {work}")
    return rec


def _train_cli(tmp, baseline):
    """(b) ``python -m routest_tpu_torch.train --quantiles 0.1,0.5,0.9``
    at the defaults, on the card. → (record, artifact path)."""
    path = os.path.join(tmp, "eta_quantile.msgpack")
    report_path = os.path.join(tmp, "training_report_cuda.json")
    env = dict(os.environ, ROUTEST_DEVICE=CARD)
    env.pop("ETA_MODEL_PATH", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "routest_tpu_torch.train", "--quantiles",
         "0.1,0.5,0.9", "--save", path, "--report", report_path,
         *TRAIN_CLI_ARGS],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(f"[train] CLI output tail:\n{proc.stdout[-3000:]}\n"
              f"{proc.stderr[-3000:]}")
    check(proc.returncode == 0, f"train (b): the CLI exited "
                                f"{proc.returncode}")
    with open(report_path) as f:
        report = json.load(f)
    check(report["mlp_rmse_minutes"] <= baseline * QUANTILE_MARGIN,
          f"train (b): RMSE {report['mlp_rmse_minutes']:.4f} > "
          f"{baseline:.4f} × {QUANTILE_MARGIN}")
    for level, cov in report["coverage"].items():
        check(abs(cov - float(level)) <= COVERAGE_TOL,
              f"train (b): coverage {cov:.4f} of quantile {level}")
    rec = dict(report, cli_wall_s=wall)
    print(f"[train] (b) CLI quantile run: RMSE "
          f"{report['mlp_rmse_minutes']:.4f} (≤ {baseline:.4f} × "
          f"{QUANTILE_MARGIN}); coverage {report['coverage']}; fit "
          f"{report['mlp_fit_seconds']:.2f} s, {report['ms_per_step']:.3f} "
          f"ms/step; baseline {report['cpu_baseline_source']}; "
          f"{wall:.1f} s of wall with the process start")
    return rec, path


def _train_score(path, rng):
    """(b) the CLI's artifact through ``fused_eta.cu`` in bf16 and int8
    against the plain version, then served by an ``EtaService`` on the
    card. → (record, fused launches over the served requests)."""
    import numpy as np
    import torch

    from routest_tpu_torch.core.config import ServeConfig
    from routest_tpu_torch.ops.fused_mlp import (fused_eta_forward,
                                                 fused_eta_forward_plain,
                                                 pack_eta_params)
    from routest_tpu_torch.serve.ml_service import EtaService, golden_batch
    from routest_tpu_torch.train.checkpoint import load_model

    model, params = load_model(path)
    n_q = len(model.quantiles)
    rows = np.concatenate([golden_batch(), random_rows(rng, 4096)])
    x = torch.from_numpy(rows).to(CARD)
    errs = {}
    for variant in ("bfloat16", "int8"):
        packed = pack_eta_params(model, params, dtype=variant, device=CARD)
        errs[variant] = compare(fused_eta_forward(packed, x, n_q=n_q),
                                fused_eta_forward_plain(packed, x, n_q=n_q),
                                PLAIN_TOL[variant], n_q)[0]
    svc = EtaService(ServeConfig(), model_path=path, device=CARD)
    check(svc.available, f"train (b): the artifact does not serve: "
                         f"{svc.load_error}")
    fused_eta_forward.launches = 0
    preds = svc.predict_batch(rows[-4096:])
    eta, _ = svc.predict_eta_minutes(weather="Sunny", traffic="High",
                                     distance_m=9000.0,
                                     pickup_time="2026-07-29T08:00:00")
    launches = fused_eta_forward.launches
    check(np.isfinite(preds).all() and (np.diff(preds, axis=1) >= 0).all()
          and eta is not None, "train (b): served quantiles")
    if CARD == "cuda":
        check(launches > 0, "train (b): no fused launch serving the "
                            "trained artifact")
    print(f"[train] (b) the trained artifact through the fused kernel: "
          f"max abs vs plain bf16 {errs['bfloat16']:.3g}, int8 "
          f"{errs['int8']:.3g}; served on {svc.scoring_info()}, {launches} "
          f"fused launches over a 4096-row batch and one single-row ETA")
    return {"max_abs_vs_plain": errs, "scoring": svc.scoring_info(),
            "fused_launches": launches}, launches


def _train_parity():
    """(c) the same init and 20 steps on the same batches, F32_POLICY,
    on the card and on the CPU path. → record."""
    import numpy as np

    from routest_tpu_torch.core.config import TrainConfig
    from routest_tpu_torch.core.dtypes import F32_POLICY
    from routest_tpu_torch.data.synthetic import generate_dataset
    from routest_tpu_torch.models.eta_mlp import EtaMLP
    from routest_tpu_torch.train.loop import fit

    cfg = TrainConfig(epochs=1)
    train = generate_dataset(PARITY_STEPS * cfg.batch_size, seed=3)
    ev = generate_dataset(4096, seed=4)
    runs = {dev: fit(EtaMLP(policy=F32_POLICY), train, ev, cfg, device=dev)
            for dev in (CARD, "cpu")}
    check(runs[CARD].optimizer.count == PARITY_STEPS,
          f"train (c): {runs[CARD].optimizer.count} steps")
    got, want = runs[CARD].params, runs["cpu"].params
    max_abs = max_rel = 0.0
    for g_layer, w_layer in zip(got["layers"], want["layers"]):
        for key in ("w", "b"):
            g, w = g_layer[key], w_layer[key]
            err = np.abs(g - w)
            bad = err > PARITY_ATOL + PARITY_RTOL * np.abs(w)
            check(not bad.any(), f"train (c): {int(bad.sum())} params "
                                 f"beyond rtol {PARITY_RTOL} / atol "
                                 f"{PARITY_ATOL}")
            max_abs = max(max_abs, float(err.max()))
            big = np.abs(w) > 1e-3
            if big.any():
                max_rel = max(max_rel, float((err[big] / np.abs(w[big]))
                                             .max()))
    rec = {"steps": PARITY_STEPS, "max_abs_diff": max_abs,
           "max_rel_diff_above_1e-3": max_rel,
           "eval_rmse": {"card": runs[CARD].eval_rmse,
                         "cpu": runs["cpu"].eval_rmse}}
    print(f"[train] (c) {PARITY_STEPS} F32 steps, card vs CPU path: params "
          f"max abs diff {max_abs:.3g}, max rel {max_rel:.3g} (|p| > 1e-3); "
          f"within rtol {PARITY_RTOL} / atol {PARITY_ATOL}")
    return rec


def _train_bootstrap(tmp):
    """(d) ``python -m routest_tpu_torch.serve`` with ``ETA_MODEL_PATH``
    at a missing file: it trains, writes and serves. → (record, fused
    launches over its requests)."""
    import signal
    import tempfile

    from routest_tpu_torch.train.checkpoint import load_model

    path = os.path.join(tmp, "boot", "eta_mlp.msgpack")
    port = _free_port()
    env = dict(os.environ, PORT=str(port), RTPU_HOST="127.0.0.1",
               ETA_MODEL_PATH=path, ROUTEST_DEVICE=CARD)
    log = tempfile.TemporaryFile(mode="w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "routest_tpu_torch.serve"],
                            cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    try:
        _, boot_s = _wait_for("ping", lambda: _request(
            port, "GET", "/api/ping")[0] == 200, 600, proc)
        status, single = _request(port, "POST", "/api/predict_eta", {
            "summary": {"distance": 12_000}, "weather": "Sunny",
            "traffic": "High", "pickup_time": "2026-07-29T08:00:00",
            "driver_age": 35})
        check(status == 200 and single["eta_minutes_ml"] > 0,
              f"bootstrap /api/predict_eta: {status} {single}")
        status, batch = _request(port, "POST", "/api/predict_eta_batch", {
            "distance_m": [500.0 * (i + 1) for i in range(64)],
            "weather": ["Sunny", "Stormy"] * 32,
            "traffic": ["Low", "Jam"] * 32, "driver_age": [30] * 64,
            "pickup_time": "2026-07-29T08:00:00"})
        check(status == 200 and batch["count"] == 64,
              f"bootstrap /api/predict_eta_batch: {status}")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.seek(0)
        text = log.read()
        log.close()
        if proc.returncode not in (0, -signal.SIGTERM):
            print(f"[train] bootstrap server log tail:\n{text[-3000:]}")
    check(proc.returncode in (0, -signal.SIGTERM),
          f"bootstrap: the server exited {proc.returncode} at SIGTERM")
    events = {}
    for line in text.splitlines():
        try:
            event = json.loads(line)
        except ValueError:
            continue
        if isinstance(event, dict) and "event" in event:
            events.setdefault(event["event"], event)
            if event["event"] == "serve_stopped":
                events["serve_stopped"] = event
    for name in ("model_bootstrap_started", "model_bootstrap_finished",
                 "serve_listening", "serve_stopped"):
        check(name in events, f"bootstrap: no {name} log line")
    launches = (events["serve_stopped"]["fused_launches"]
                - events["serve_listening"]["fused_launches"])
    if CARD == "cuda":
        check(launches > 0, "bootstrap: no fused launch over its requests")
    model, _ = load_model(path)
    rec = {"boot_s": boot_s, "wall_s": time.perf_counter() - t0,
           "eval_rmse": events["model_bootstrap_finished"]["eval_rmse_min"],
           "hidden": list(model.hidden), "fused_launches": launches,
           "server_exit": proc.returncode}
    print(f"[train] (d) bootstrap: served after {boot_s:.1f} s (trained "
          f"eval RMSE {rec['eval_rmse']}, artifact {rec['hidden']}); "
          f"/api/predict_eta and a 64-row batch 200; {launches} fused "
          f"launches over them")
    return rec, launches


def _train_road(tmp):
    """(e) the GNN and transformer trainers at their scripts' defaults on
    ``generate_road_graph(2048, seed 0)``; both artifacts load into a
    router through the fingerprint gate. → record."""
    from routest_tpu_torch.optimize.road_router import RoadRouter
    from routest_tpu_torch.train import gnn as train_gnn
    from routest_tpu_torch.train import transformer as train_tf
    from routest_tpu_torch.train.checkpoint import save_gnn, save_transformer

    rec = {}
    paths = {"gnn": os.path.join(tmp, "road_gnn.msgpack"),
             "transformer": os.path.join(tmp, "route_transformer.msgpack")}
    for name, mod in (("gnn", train_gnn), ("transformer", train_tf)):
        report = mod.train(mod.parse_args(["--device", CARD]))
        model, graph = report.pop("_model"), report.pop("_graph")
        check(report["beats_naive"], f"train (e): the {name} does not beat "
                                     f"naive physics: {report}")
        if name == "gnn":
            save_gnn(paths[name], model, graph)
        else:
            save_transformer(paths[name], model, graph,
                             seq_len=report["seq_len"])
        rec[name] = report
    router = RoadRouter(gnn_path=paths["gnn"],
                        transformer_path=paths["transformer"], device=CARD)
    check(router.leg_cost_model == "gnn" and router.has_transformer,
          "train (e): the trained artifacts fail the fingerprint gate")
    g, t = rec["gnn"], rec["transformer"]
    print(f"[train] (e) GNN: held-out RMSE {g['gnn_rmse_s']:.2f} s vs naive "
          f"{g['naive_rmse_s']:.2f} (held-out hours "
          f"{g['gnn_rmse_held_hours_s']:.2f} vs "
          f"{g['naive_rmse_held_hours_s']:.2f}), {g['steps']} steps, "
          f"{g['ms_per_step']:.3f} ms/step; transformer: "
          f"{t['transformer_rmse_s']:.2f} s vs naive {t['naive_rmse_s']:.2f} "
          f"(held-out hours {t['transformer_rmse_held_hours_s']:.2f} vs "
          f"{t['naive_rmse_held_hours_s']:.2f}), {t['steps']} steps, "
          f"{t['ms_per_step']:.3f} ms/step; both live on a {CARD} router "
          f"through the fingerprint gate")
    return rec


def _train_live(tmp):
    """(f) one ``ContinuousTrainer.run_once`` on the default router
    (its GNN copied to a temp path) with phase 10's seeded probe fleet;
    the router swaps to the new artifact. → record."""
    import shutil

    import numpy as np

    from routest_tpu_torch.live.trainer import ContinuousTrainer
    from routest_tpu_torch.optimize.road_router import RoadRouter

    path = os.path.join(tmp, "live_gnn.msgpack")
    shutil.copy(os.path.join(ROOT, "artifacts", "road_gnn.msgpack"), path)
    router = RoadRouter(gnn_path=path, use_transformer=False, device=CARD)
    check(router.leg_cost_model == "gnn", "train (f): the GNN is not live")
    state, events = _live_fleet(router, _live_corridor(router), seed=1)
    before = router.edge_time_s(8).copy()
    trainer = ContinuousTrainer(router, state)
    t0 = time.perf_counter()
    res = trainer.run_once()
    cycle_s = time.perf_counter() - t0
    check(res.get("trained"), f"train (f): {res}")
    router._maybe_reload_models()
    after = router.edge_time_s(8)
    changed = int((after != before).sum())
    check(router.leg_cost_model == "gnn" and changed > 0,
          "train (f): the router did not swap to the retrained GNN")
    legs = router.route_legs(router.coords[[0, 600, 1200, 1800]], hour=8)
    durations = legs.duration_matrix()
    check(np.isfinite(durations).all() and (durations[~np.eye(4, dtype=bool)]
                                            > 0).all(),
          "train (f): the 3-stop route's legs")
    rec = dict(res, fleet_events=len(events), cycle_s=cycle_s,
               edges_changed=changed,
               median_abs_change_s=float(np.median(np.abs(after - before))))
    print(f"[train] (f) live retrain on {CARD}: {res['observations']} "
          f"observations, {res['edges_labeled']} edges labeled, loss "
          f"{res['loss']}, cycle {cycle_s:.3f} s; the router swapped: "
          f"{changed} edge times changed (median "
          f"{rec['median_abs_change_s']:.3f} s); a 3-stop route's legs "
          f"priced")
    return rec


def _gbdt_json(path, seed=13):
    """A seeded ensemble in XGBoost's JSON schema: ``GBDT_TREES`` trees up
    to ``GBDT_DEPTH`` deep, splits on the ABI's features at thresholds in
    their ranges, leaf values in minutes."""
    import random

    import numpy as np

    rng = random.Random(seed)
    ranges = [(0.0, 1.0)] * 8 + [(0.0, 7.0), (0.0, 24.0), (0.0, 60.0),
                                 (18.0, 70.0)]

    def tree():
        lc, rc, cond, split, default = [], [], [], [], []

        def grow(depth):
            nid = len(lc)
            for a in (lc, rc):
                a.append(-1)
            cond.append(0.0)
            split.append(0)
            default.append(0)
            if depth >= GBDT_DEPTH or (depth > 2 and rng.random() < 0.1):
                cond[nid] = rng.uniform(-0.5, 1.5)
                return nid
            f = rng.randrange(12)
            lo, hi = ranges[f]
            cond[nid] = float(np.float32(0.5 if f < 8
                                         else rng.uniform(lo, hi)))
            split[nid], default[nid] = f, rng.randrange(2)
            lc[nid] = grow(depth + 1)
            rc[nid] = grow(depth + 1)
            return nid

        grow(0)
        return {"left_children": lc, "right_children": rc,
                "split_conditions": cond, "split_indices": split,
                "default_left": default}

    with open(path, "w") as f:
        json.dump({"learner": {
            "objective": {"name": "reg:squarederror"},
            "learner_model_param": {"base_score": "12.5"},
            "gradient_booster": {"model": {"trees": [
                tree() for _ in range(GBDT_TREES)]}}}}, f)


def _train_gbdt(tmp, rng):
    """(g) the XGBoost JSON through ``EtaService`` on the card and on the
    CPU path at 4096 rows: leaf cursors bitwise, predictions within 1e-6
    relative, ms per batch. → record."""
    import numpy as np
    import torch

    from routest_tpu_torch.core.config import ServeConfig
    from routest_tpu_torch.serve.ml_service import EtaService

    path = os.path.join(tmp, "xgb_eta_model.json")
    _gbdt_json(path)
    card = EtaService(ServeConfig(), model_path=path, device=CARD)
    cpu = EtaService(ServeConfig(), model_path=path, device="cpu")
    for svc in (card, cpu):
        check(svc.available and svc.scoring_info()["family"] == "xgboost",
              f"train (g): {svc.load_error} {svc.scoring_info()}")
    rows = random_rows(rng, GBDT_ROWS)
    nan_rows = rng.choice(GBDT_ROWS, int(GBDT_ROWS * GBDT_NAN_FRAC),
                          replace=False)
    rows[nan_rows, rng.integers(0, 12, len(nan_rows))] = np.nan
    x_card = torch.from_numpy(rows).to(CARD)
    x_cpu = torch.from_numpy(rows)
    gb_card, gb_cpu = card._model.gbdt, cpu._model.gbdt
    cur_card = gb_card.leaf_cursors(card._params, x_card).cpu()
    cur_cpu = gb_cpu.leaf_cursors(cpu._params, x_cpu)
    check(torch.equal(cur_card, cur_cpu), "train (g): leaf cursors differ "
          f"in {int((cur_card != cur_cpu).sum())} of {cur_cpu.numel()}")
    got = card._model.apply(card._params, x_card).cpu().numpy()
    want = cpu._model.apply(cpu._params, x_cpu).numpy()
    err = np.abs(got.astype(np.float64) - want)
    check(np.isfinite(got).all() and (err <= 1e-6 * np.abs(want)
                                      + 1e-6).all(),
          f"train (g): predictions beyond 1e-6 relative: max abs "
          f"{err.max():.3g}")
    served = card.predict_batch(rows)
    check(np.array_equal(np.isnan(served), np.isnan(cpu.predict_batch(rows)))
          and int(np.isnan(served).sum()) == len(nan_rows),
          "train (g): served NaN rows")
    ms = _event_ms(lambda: card._model.apply(card._params, x_card),
                   GBDT_REPS)
    serve_ms = _cpu_ms(lambda: card.predict_batch(rows), GBDT_REPS)
    rec = {"trees": GBDT_TREES, "max_depth": gb_card.max_depth,
           "max_nodes": gb_card.max_nodes, "rows": GBDT_ROWS,
           "nan_rows": len(nan_rows), "max_abs_err": float(err.max()),
           "ms_per_batch": ms, "served_ms_per_batch": serve_ms,
           "cpu_ms_per_batch": _cpu_ms(
               lambda: cpu._model.apply(cpu._params, x_cpu), 3)}
    print(f"[train] (g) XGBoost JSON, {GBDT_TREES} trees (descent "
          f"{gb_card.max_depth} rounds, {gb_card.max_nodes} nodes): leaf "
          f"cursors bitwise the CPU path's over {GBDT_ROWS} rows "
          f"({len(nan_rows)} with a NaN), predictions max abs diff "
          f"{err.max():.3g}; {ms:.4f} ms per 4096-row batch on {CARD} "
          f"(through EtaService {serve_ms:.3f} ms; CPU path "
          f"{rec['cpu_ms_per_batch']:.3f} ms)")
    return rec


def _quiet_host(timeout_s=10.0):
    """Phase 13 times the training path itself: no thread of an earlier
    phase (a reload watcher, a server, a loop) may still share the host.
    Waits up to ``timeout_s`` for stopping threads to end, then fails
    naming any that are left."""
    deadline = time.perf_counter() + timeout_s
    while True:
        left = [t for t in threading.enumerate()
                if t is not threading.main_thread() and t.is_alive()]
        if not left or time.perf_counter() > deadline:
            break
        left[0].join(0.1)
    check(not left, "train: threads of earlier phases still run: "
          f"{sorted(t.name for t in left)}")
    print("[train] no thread of an earlier phase runs")


def phase_train():
    """Phase 13, training on the card: (a) the ETA fit at the script's
    defaults, (b) the quantile CLI and its artifact through the fused
    kernel, (c) card against the CPU path, (d) the serve bootstrap, (e)
    the GNN and transformer trainers, (f) the live retrainer, (g) the
    XGBoost family. → (record, fused launches of (b)'s and (d)'s
    serving)."""
    import tempfile

    import numpy as np

    rng = np.random.default_rng(13)
    _quiet_host()
    baseline = _baseline_rmse()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        record = {"fit": _train_fit(baseline)}
        record["cli"], artifact = _train_cli(tmp, baseline)
        record["cli_scoring"], score_launches = _train_score(artifact, rng)
        record["parity"] = _train_parity()
        record["bootstrap"], boot_launches = _train_bootstrap(tmp)
        record["road"] = _train_road(tmp)
        record["live_retrain"] = _train_live(tmp)
        record["gbdt"] = _train_gbdt(tmp, rng)
    record["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"train": record}))
    return record, score_launches + boot_launches


def phase_times(rng):
    """Per-bucket times of every variant on the served artifact
    (quantile): → {variant: [row per batch]}."""
    import torch

    from routest_tpu_torch.ops.fused_mlp import (_TILES, fused_eta_forward,
                                                 fused_eta_forward_plain,
                                                 pack_eta_params, tile_rows)
    from routest_tpu_torch.train.checkpoint import load_model

    model, params = load_model(os.path.join(ROOT, "artifacts",
                                            "eta_mlp.msgpack"))
    n_q = len(model.quantiles)
    # the model's own work, from its unpadded layers: 2 operations per
    # multiply-add, one weight per multiply-add, and an f32 bias (and for
    # int8 an f32 scale) per output column
    mac = sum(layer["w"].shape[0] * layer["w"].shape[1]
              for layer in params["layers"])
    cols = sum(layer["w"].shape[1] for layer in params["layers"])
    table = {}
    for dtype_name in VARIANTS:
        packed = pack_eta_params(model, params, dtype=dtype_name,
                                 device="cuda")
        weight_bytes = (mac * WEIGHT_BYTES[dtype_name]
                        + cols * 4 * (2 if dtype_name == "int8" else 1))
        launch = packed["launch"]
        if launch.slabs is not None:
            print(f"[times] {dtype_name:8s} model bytes {weight_bytes} "
                  f"(bound); slab stream per block {launch.slabs.numel()} B")
        rows = table[dtype_name] = []
        for b in SERVING_BUCKETS + SCALING_BATCHES:
            x = torch.from_numpy(random_rows(rng, b)).cuda()
            tile = (32 if dtype_name == "float32" else
                    tile_rows(b, launch.dims, launch.dtype, launch.sms))
            tiles = (tile,) if dtype_name == "float32" else _TILES
            by_tile = {t: graph_ms(lambda: fused_eta_forward(
                packed, x, n_q=n_q, tile=t)) for t in tiles}
            eager_ms, enqueue_ms = time_ms(
                lambda: fused_eta_forward(packed, x, n_q=n_q),
                max(20, min(500, 50_000 // b)))
            plain_ms, _ = time_ms(
                lambda: fused_eta_forward_plain(packed, x, n_q=n_q),
                max(5, min(50, 20_000 // b)))
            flop_s = 2.0 * b * mac / PEAK_FLOPS[dtype_name]
            byte_s = (b * 12 * 4 + b * n_q * 4 + weight_bytes) / H100_HBM_BYTES_S
            rows.append({"batch": b, "tile": tile, "ms": by_tile[tile],
                         "ms_by_tile": by_tile, "eager_ms": eager_ms,
                         "enqueue_ms": enqueue_ms, "plain_ms": plain_ms,
                         "bound_ms": max(flop_s, byte_s) * 1e3,
                         "bound_by": ("operations" if flop_s >= byte_s
                                      else "bytes"),
                         "serving_bucket": b in SERVING_BUCKETS})
            r = rows[-1]
            tiles_txt = ", ".join(f"{t}-row {ms:.5f}"
                                  for t, ms in by_tile.items())
            print(f"[times] {dtype_name:8s} batch {b:5d}: kernel "
                  f"{r['ms']:.5f} ms ({tiles_txt}); eager {eager_ms:.5f} ms, "
                  f"host enqueue {enqueue_ms:.5f} ms; plain {plain_ms:.4f} "
                  f"ms; bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    print(json.dumps({"timings": table}))
    return table


# ── phase 14: observability ──────────────────────────────────────────

OBS_BATCH = 4096
OBS_SPLIT_REPS = 5           # untraced 4096-row requests for the split
OBS_BURST = 8                # optimize requests in the store-error burst
OBS_OVERHEAD_REPS = 200      # single-row requests per tracing setting
OBS_SPANS = ("replica.request", "replica.handler", "batcher.queue_wait",
             "batcher.flush", "batcher.pad", "batcher.device_compute")


def _obs_batch(rng, n):
    """A seeded columnar ``/api/predict_eta_batch`` body of ``n`` rows."""
    return {"distance_m": rng.uniform(200.0, 40_000.0, n).round(1).tolist(),
            "weather": rng.choice(["Sunny", "Stormy", "Cloudy"], n).tolist(),
            "traffic": rng.choice(["Low", "High", "Jam"], n).tolist(),
            "driver_age": rng.uniform(18.0, 70.0, n).round(1).tolist(),
            "pickup_time": ["2026-10-17T08:30:00"] * n}


def _obs_post(port, path, body, traceparent=None):
    """→ (status, headers, JSON) of one JSON POST, with a W3C
    ``traceparent`` when given."""
    headers = {"Content-Type": "application/json"}
    if traceparent:
        headers["traceparent"] = traceparent
    status, head, raw = _http(port, "POST", path, json.dumps(body).encode(),
                              headers)
    return status, head, json.loads(raw or b"null")


def _obs_trace_events(path):
    """The fused kernel's launches and the host↔device copies in one
    ``torch.profiler`` Chrome trace → ([(name, µs)], {"HtoD": µs,
    "DtoH": µs}). A launch is named by phase 2's mangled-name fragment
    or, demangled, by its stem (``fused_eta_tc_kernel<false, 16>``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    stems = {k.split("I", 1)[0] for k in KERNEL_SYMBOLS}
    kernels, copies = [], {"HtoD": 0.0, "DtoH": 0.0}
    for e in events:
        name = str(e.get("name", ""))
        cat = str(e.get("cat", "")).lower()
        if cat == "kernel" and any(s in name for s in stems):
            kernels.append((name, float(e.get("dur") or 0.0)))
        elif cat == "gpu_memcpy":
            for direction in copies:
                if direction in name:
                    copies[direction] += float(e.get("dur") or 0.0)
    return kernels, copies


def _obs_spans(port, trace_id):
    status, out = _request(port, "GET", f"/api/trace?trace_id={trace_id}")
    check(status == 200, f"/api/trace: {status}")
    return {s["name"]: s for s in out["spans"]}


def _obs_tracing(port, rng):
    """(a): one 4096-row request sent with a ``traceparent``: one trace
    id from ``replica.request`` down to ``batcher.device_compute``, whose
    device trace names the fused kernel; a 64-row request through the
    fast lane; then the span split of untraced 4096-row requests."""
    import uuid

    trace_id = uuid.UUID(int=int(rng.integers(1, 2**62))).hex
    tp = f"00-{trace_id}-00f067aa0ba902b7-01"
    t0 = time.perf_counter()
    status, head, out = _obs_post(port, "/api/predict_eta_batch",
                                  _obs_batch(rng, OBS_BATCH), tp)
    wall_ms = (time.perf_counter() - t0) * 1e3
    check(status == 200 and len(out["eta_minutes_ml"]) == OBS_BATCH,
          f"traced batch: {status}")
    check(head.get("X-Trace-Id") == trace_id, f"X-Trace-Id {head}")
    spans = _obs_spans(port, trace_id)
    check(set(OBS_SPANS) <= set(spans), f"trace spans {sorted(spans)}")
    check({s["trace_id"] for s in spans.values()} == {trace_id},
          "one trace id across the request")
    for child, parent in (("replica.handler", "replica.request"),
                          ("batcher.queue_wait", "replica.handler"),
                          ("batcher.flush", "batcher.queue_wait"),
                          ("batcher.pad", "batcher.flush"),
                          ("batcher.device_compute", "batcher.flush")):
        check(spans[child]["parent_id"] == spans[parent]["span_id"],
              f"{child} not under {parent}")
    compute = spans["batcher.device_compute"]
    trace_dir = compute["attrs"].get("device_trace_dir")
    check(trace_dir and not compute["attrs"].get("device_trace_error"),
          f"device_compute carries no device trace: {compute['attrs']}")
    kernels, copies = _obs_trace_events(os.path.join(trace_dir, "trace.json"))
    check(kernels, "the span's device trace names no fused_eta kernel")
    traced = {"wall_ms": wall_ms,
              "spans_ms": {n: spans[n]["duration_ms"] for n in OBS_SPANS},
              "kernel": kernels[0][0], "kernel_launches": len(kernels),
              "kernel_ms": sum(d for _, d in kernels) / 1e3,
              "h2d_ms": copies["HtoD"] / 1e3, "d2h_ms": copies["DtoH"] / 1e3}
    # a fast-lane-sized request: fastlane.predict between handler and
    # queue_wait
    small_id = uuid.UUID(int=int(rng.integers(1, 2**62))).hex
    status, _, _ = _obs_post(port, "/api/predict_eta_batch",
                             _obs_batch(rng, 64),
                             f"00-{small_id}-00f067aa0ba902b8-01")
    small = _obs_spans(port, small_id)
    check(status == 200 and "fastlane.predict" in small
          and small["batcher.queue_wait"]["parent_id"]
          == small["fastlane.predict"]["span_id"]
          and small["fastlane.predict"]["parent_id"]
          == small["replica.handler"]["span_id"],
          f"fast-lane trace {sorted(small)}")
    # the split without the profiler: untraced (budget spent) requests
    runs = []
    for _ in range(OBS_SPLIT_REPS):
        rid = uuid.UUID(int=int(rng.integers(1, 2**62))).hex
        t0 = time.perf_counter()
        status, _, _ = _obs_post(port, "/api/predict_eta_batch",
                                 _obs_batch(rng, OBS_BATCH),
                                 f"00-{rid}-00f067aa0ba902b9-01")
        wall = (time.perf_counter() - t0) * 1e3
        check(status == 200, f"split batch: {status}")
        spans = _obs_spans(port, rid)
        if "device_trace_dir" in spans["batcher.device_compute"]["attrs"]:
            continue          # a capture left in the budget: not a split
        runs.append({"wall_ms": wall, **{n: spans[n]["duration_ms"]
                                         for n in OBS_SPANS}})
    split = {k: _median([r[k] for r in runs]) for k in runs[0]}
    print(f"[obs] tracing: trace {trace_id} through "
          f"{' > '.join(OBS_SPANS)}; traced request {wall_ms:.2f} ms, "
          f"device_compute span {traced['spans_ms']['batcher.device_compute']:.3f}"
          f" ms, {len(kernels)} launch(es) of {kernels[0][0]} "
          f"{traced['kernel_ms']:.4f} ms, H2D {traced['h2d_ms']:.4f} ms, "
          f"D2H {traced['d2h_ms']:.4f} ms; untraced median: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    return {"traced": traced, "split_median_ms": split}


def _obs_efficiency(port):
    status, out = _request(port, "GET", "/api/efficiency")
    check(status == 200, f"/api/efficiency: {status}")
    return out


def _obs_rows(eff, program):
    prog = eff["ledger"]["programs"][program]
    buckets = {int(b): (w["rows"], w["padded"])
               for b, w in prog["buckets"].items()}
    return prog["rows"], prog["padded_rows"], prog["cached_rows"], \
        prog["calls"], buckets


def _obs_goodput(port, rng):
    """(b): ``eta_score`` real and padded rows per bucket equal what was
    sent; a road route and a dispatch reach ``route_solve`` and
    ``dispatch_solve``; the watchdog reads ``no_artifact``."""
    r0, p0, c0, _, b0 = _obs_rows(_obs_efficiency(port), "eta_score")
    small = _obs_batch(rng, 100)
    for body in (_obs_batch(rng, OBS_BATCH), small, small):
        status, _, _ = _obs_post(port, "/api/predict_eta_batch", body)
        check(status == 200, f"goodput batch: {status}")
    r1, p1, c1, _, b1 = _obs_rows(_obs_efficiency(port), "eta_score")
    per_bucket = {b: (b1[b][0] - b0.get(b, (0, 0))[0],
                      b1[b][1] - b0.get(b, (0, 0))[1]) for b in b1}
    per_bucket = {b: v for b, v in per_bucket.items() if v != (0, 0)}
    check((r1 - r0, p1 - p0, c1 - c0) == (OBS_BATCH + 100,
                                          OBS_BATCH + 512, 100),
          f"eta_score ledger: rows {r1 - r0}, padded {p1 - p0}, "
          f"cached {c1 - c0}")
    check(per_bucket == {OBS_BATCH: (OBS_BATCH, OBS_BATCH),
                         512: (100, 512)},
          f"eta_score per bucket {per_bucket}")
    status, out = _request(port, "POST", "/api/optimize_route",
                           _road_body(3, 0))
    check(status == 200, f"road route: {status} {out}")
    status, out = _request(port, "POST", "/api/dispatch",
                           _geo_dispatch_body(0, n=8))
    check(status == 200, f"/api/dispatch: {status} {out}")
    eff = _obs_efficiency(port)
    calls = {p: eff["ledger"]["programs"][p]["calls"]
             for p in ("route_solve", "dispatch_solve")}
    check(all(v > 0 for v in calls.values()), f"ledger calls {calls}")
    check(eff["watchdog"]["status"] == "no_artifact"
          and eff["ledger"]["identity"]["backend"] == CARD,
          f"watchdog {eff['watchdog'].get('status')}, identity "
          f"{eff['ledger']['identity']}")
    status, health = _request(port, "GET", "/api/health")
    check(health["checks"]["engine"]["efficiency"]["status"] == "no_artifact",
          f"health efficiency {health['checks']['engine'].get('efficiency')}")
    rec = {"eta_score_per_bucket": {str(b): {"rows": v[0], "padded": v[1]}
                                    for b, v in per_bucket.items()},
           "cached_rows": c1 - c0, "calls": calls,
           "watchdog": eff["watchdog"]["status"],
           "identity": eff["ledger"]["identity"]}
    print(f"[obs] goodput: eta_score per bucket {rec['eta_score_per_bucket']}"
          f", cached {c1 - c0}; route_solve / dispatch_solve calls "
          f"{calls}; watchdog {rec['watchdog']} on "
          f"{rec['identity']['device']}")
    return rec


def _obs_swap_and_page(port, model_path, recorder_dir):
    """(d): a hot swap records ``model.swap``; a burst of optimize
    requests whose writes fail at ``store.http`` takes the store SLO to
    ``page``; one ``slo_page`` bundle ranks the swap among its suspects
    and ``/api/incidents`` lists it."""
    import shutil

    tmp = model_path + ".tmp"
    shutil.copy(os.path.join(ROOT, "artifacts", "eta_mlp.msgpack"), tmp)
    os.replace(tmp, model_path)
    t0 = time.perf_counter()
    while True:
        status, out = _request(port, "GET", "/api/changes?kind=model.swap")
        if out.get("count"):
            break
        check(time.perf_counter() - t0 < 60, "no model.swap recorded")
        time.sleep(0.1)
    swap_s = time.perf_counter() - t0
    for rep in range(OBS_BURST):
        status, out = _request(port, "POST", "/api/optimize_route",
                               _opt_body(3, rep))
        props = (out or {}).get("properties") or {}
        check(status == 200 and props.get("degraded") is True,
              f"burst optimize: {status} {props.get('degraded')}")
    t0 = time.perf_counter()
    while True:
        status, slo = _request(port, "GET", "/api/slo")
        state = slo["objectives"]["availability:store"]["state"]
        if state == "page":
            break
        check(time.perf_counter() - t0 < 30, f"store SLO stays {state}")
        time.sleep(0.1)
    t0 = time.perf_counter()
    while True:
        status, inc = _request(port, "GET", "/api/incidents")
        pages = [i for i in inc["incidents"] if i["reason"] == "slo_page"]
        if pages:
            break
        check(time.perf_counter() - t0 < 30, "no slo_page incident")
        time.sleep(0.1)
    kinds = [s["event"]["kind"] for s in pages[0]["suspects"]]
    check("model.swap" in kinds, f"suspects {kinds}")
    bundles = [d for d in os.listdir(recorder_dir) if "_slo_page_" in d]
    check(len(bundles) == 1, f"slo_page bundles {bundles}")
    with open(os.path.join(recorder_dir, bundles[0], "suspects.json")) as f:
        check("model.swap" in [s["event"]["kind"]
                               for s in json.load(f)["suspects"]],
              "suspects.json lacks the swap")
    burn = slo["objectives"]["availability:store"]
    print(f"[obs] SLO: model.swap recorded {swap_s:.2f} s after the copy;"
          f" {OBS_BURST} journaled writes paged availability:store (burn "
          f"fast {burn['burn_fast']}, slow {burn['burn_slow']}); bundle "
          f"{bundles[0]} suspects {kinds}")
    return {"swap_s": swap_s, "burn_fast": burn["burn_fast"],
            "burn_slow": burn["burn_slow"], "suspects": kinds,
            "bundle": bundles[0]}


def _obs_profile(port, rng, recorder_dir):
    """(e): ``POST /api/debug/profile`` under ``RTPU_PROFILE_DEVICE=1``
    writes ``profile.folded`` and a device trace naming the kernel."""
    t0 = time.perf_counter()
    while True:   # an SLO edge may have armed a capture of its own
        status, _, out = _obs_post(port, "/api/debug/profile",
                                   {"duration_s": 1.0})
        if status == 202:
            break
        check(status == 409 and time.perf_counter() - t0 < 30,
              f"/api/debug/profile: {status} {out}")
        time.sleep(0.2)
    check(out["armed"] and out["profiler"]["device_trace_error"] is None,
          f"profiler: {out['profiler']}")
    for _ in range(3):
        status, _, _ = _obs_post(port, "/api/predict_eta_batch",
                                 _obs_batch(rng, OBS_BATCH))
        check(status == 200, f"profiled batch: {status}")
    t0 = time.perf_counter()
    while True:
        found = [d for d in os.listdir(recorder_dir)
                 if "_profile_manual_api_" in d and os.path.exists(
                     os.path.join(recorder_dir, d, "profile.json"))]
        if found:
            break
        check(time.perf_counter() - t0 < 30, "no profile bundle")
        time.sleep(0.1)
    bundle = os.path.join(recorder_dir, found[0])
    files = sorted(os.listdir(bundle))
    check({"profile.folded", "profile.json", "device_trace.json"}
          <= set(files), f"profile bundle files {files}")
    with open(os.path.join(bundle, "profile.json")) as f:
        meta = json.load(f)
    check(meta["device_trace_error"] is None and meta["samples"] > 0,
          f"profile meta {meta.get('device_trace_error')}")
    kernels, copies = _obs_trace_events(
        os.path.join(bundle, "device_trace.json"))
    check(kernels, "the profile's device trace names no fused_eta kernel")
    print(f"[obs] profile: {meta['samples']} stack samples, "
          f"{len(kernels)} fused launches in the device trace "
          f"({sum(d for _, d in kernels) / 1e3:.4f} ms), bundle {found[0]}")
    return {"samples": meta["samples"], "kernel_launches": len(kernels),
            "kernel_ms": sum(d for _, d in kernels) / 1e3}


def _obs_server(rng, tmp):
    """(a), (b), (d), (e) through ``python -m routest_tpu_torch.serve``
    on the card. → record."""
    import shutil
    import signal

    port = _free_port()
    model_path = os.path.join(tmp, "eta.msgpack")
    shutil.copy(os.path.join(ROOT, "artifacts", "eta_mlp_point.msgpack"),
                model_path)
    recorder_dir = os.path.join(tmp, "postmortems")
    env = dict(os.environ, PORT=str(port), RTPU_HOST="127.0.0.1",
               ROUTEST_DEVICE=CARD, ETA_MODEL_PATH=model_path,
               ROUTEST_RELOAD_SEC="0.2", ROUTEST_HIER_CACHE="0",
               RTPU_OBS_SAMPLE="1.0",
               RTPU_OBS_DEVICE_TRACE_DIR=os.path.join(tmp, "traces"),
               # the boot self-check's flush takes the first capture
               RTPU_OBS_DEVICE_TRACE_MAX="2",
               RTPU_SLO_FAST_S="2", RTPU_SLO_SLOW_S="10",
               RTPU_SLO_TICK_S="0.25",
               RTPU_RECORDER_DIR=recorder_dir,
               RTPU_RECORDER_MIN_INTERVAL_S="0",
               RTPU_RECORDER_FOLLOWUP_S="0",
               RTPU_PROFILE_DEVICE="1", RTPU_PROFILE_DURATION_S="1",
               RTPU_PROFILE_MIN_INTERVAL_S="0",
               RTPU_CHAOS_SPEC="store.http:error=1.0",
               RTPU_STORE_BACKOFF_MS="0")
    for var in ("ROAD_GRAPH_OSM", "ROAD_GNN_PATH", "ROUTE_TRANSFORMER_PATH",
                "ROUTEST_HIER_MIN_NODES", "REDIS_URL", "SUPABASE_URL",
                "RTPU_EFF_KERNEL_ARTIFACT", "RTPU_KERNEL_DTYPE", "RTPU_LIVE"):
        env.pop(var, None)
    log = open(os.path.join(tmp, "server.log"), "w+")
    t_start = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "routest_tpu_torch.serve"],
                            cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    try:
        _, boot_s = _wait_for("ping", lambda: _request(
            port, "GET", "/api/ping")[0] == 200, 300, proc, "obs serving")
        rec = {"boot_s": boot_s, "tracing": _obs_tracing(port, rng)}
        rec["slo"] = _obs_swap_and_page(port, model_path, recorder_dir)
        rec["goodput"] = _obs_goodput(port, rng)
        rec["profile"] = _obs_profile(port, rng, recorder_dir)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.seek(0)
        text = log.read()
        log.close()
        if proc.returncode not in (0, -signal.SIGTERM):
            print(f"[obs] server log tail:\n{text[-3000:]}")
    check(proc.returncode in (0, -signal.SIGTERM),
          f"obs serving: the server exited {proc.returncode} at SIGTERM")
    counts = {}
    for line in text.splitlines():
        try:
            event = json.loads(line)
        except ValueError:
            continue
        if isinstance(event, dict) and event.get("event") in (
                "serve_listening", "serve_stopped"):
            counts[event["event"]] = event["fused_launches"]
    check(len(counts) == 2, f"obs serving: launch counts logged {counts}")
    rec["server_fused_launches"] = (counts["serve_stopped"]
                                    - counts["serve_listening"])
    if CARD == "cuda":
        check(rec["server_fused_launches"] > 0,
              "obs serving: no fused launch over the served requests")
    rec["server_wall_s"] = time.perf_counter() - t_start
    return rec


def _obs_chaos(rng, tmp):
    """(c), in this process (a spec armed at boot would fail the
    server's own self-check, as it does the JAX server's): the first
    two scoring requests under ``device.compute:error=1@2`` answer as
    the JAX app does and launch nothing, the third is bitwise the
    fault-free answer; ``store.http`` errors against the fake PostgREST
    journal the writes, which are read back after recovery."""
    import importlib.util

    from routest_tpu_torch import chaos
    from routest_tpu_torch.core.config import (Config, ServeConfig,
                                               load_config)
    from routest_tpu_torch.ops.fused_mlp import fused_eta_forward
    from routest_tpu_torch.serve.ml_service import EtaService

    artifact = os.path.join(ROOT, "artifacts", "eta_mlp.msgpack")
    config = load_config()
    svc = EtaService(config.serve, model_path=artifact, device=CARD)
    body = _obs_batch(rng, OBS_BATCH)
    answers, launches = [], []
    card = Config(serve=ServeConfig(device=CARD))
    with _Server(svc, card) as srv:
        chaos.configure(chaos.ChaosEngine(spec="device.compute:error=1@2",
                                          seed=0))
        try:
            for _ in range(3):
                before = fused_eta_forward.launches
                answers.append(_request(srv.port, "POST",
                                        "/api/predict_eta_batch", body))
                launches.append(fused_eta_forward.launches - before)
        finally:
            chaos.configure(None)
        again = _request(srv.port, "POST", "/api/predict_eta_batch", body)
    for status, out in answers[:2]:
        check(status == 503 and out == {"error": "model unavailable"},
              f"device.compute fault answered {status} {out}")
    check(answers[2][0] == 200 and again[0] == 200, "recovery answers")
    check(answers[2][1] == again[1], "the third answer is not the "
                                     "fault-free one")
    if CARD == "cuda":
        check(launches[:2] == [0, 0] and launches[2] >= 1,
              f"fused launches per request under faults {launches}")
    # store.http through the fake PostgREST
    spec = importlib.util.spec_from_file_location(
        "fake_postgrest", os.path.join(ROOT, "tests", "fake_postgrest.py"))
    fake = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fake)
    pg, pg_thread, url = fake.start_fake_postgrest()
    env = {"SUPABASE_URL": url, "SUPABASE_SERVICE_ROLE_KEY": "smoke-key",
           "RTPU_STORE_COOLDOWN_S": "0.2", "RTPU_STORE_BACKOFF_MS": "0"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cfg = load_config()
        srv = _Server(EtaService(cfg.serve, model_path=artifact,
                                 device=CARD), cfg)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    try:
        with srv:
            chaos.configure(chaos.ChaosEngine(spec="store.http:error=1.0@3",
                                              seed=0))
            try:
                status, out = _request(srv.port, "POST",
                                       "/api/optimize_route", _opt_body(3, 1))
            finally:
                chaos.configure(None)
            props = out["properties"]
            check(status == 200 and props.get("saved") is True
                  and props.get("degraded") is True,
                  f"store.http fault: {status} {props}")
            time.sleep(0.25)          # the breaker's cooldown
            status, health = _request(srv.port, "GET", "/api/health")
            store = health["checks"]["store"]
            check(store["status"] == "ok"
                  and store["resilience"]["journal_depth"] == 0,
                  f"store after recovery {store}")
            status, hist = _request(srv.port, "GET", "/api/history")
            check(props["request_id"] in [i["request_id"]
                                          for i in hist["items"]],
                  "the journaled write was not read back")
    finally:
        pg.shutdown()
        pg.server_close()
        pg_thread.join(timeout=10)
    print(f"[obs] chaos: device.compute answered "
          f"{[a[0] for a in answers]} with fused launches {launches}, the "
          f"third bitwise the fault-free answer; store.http journaled the "
          f"write and read it back after recovery")
    return {"device_compute_status": [a[0] for a in answers],
            "device_compute_launches": launches,
            "store_journaled_and_read_back": True}


def _obs_export(rng, tmp):
    """(f): ``python -m routest_tpu_torch.train.export`` on the shipped
    artifact; ``ETA_MODEL_PATH`` serves the file (``torch_export``, no
    fused launch) within phase 9's kernel-vs-plain tolerance of the
    kernel-served artifact, and bitwise the program before saving (the
    CLI's own check) and the loaded file's program (here)."""
    import numpy as np
    import torch

    from routest_tpu_torch.core.config import load_config
    from routest_tpu_torch.ops.fused_mlp import fused_eta_forward
    from routest_tpu_torch.serve.ml_service import EtaService
    from routest_tpu_torch.train.checkpoint import (default_model_path,
                                                    load_exported_serving_fn)

    artifact = os.path.join(ROOT, "artifacts", "eta_mlp.msgpack")
    out = os.path.join(tmp, "eta_mlp.pt2")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "routest_tpu_torch.train.export",
                          "--model", artifact, "--out", out, "--device", CARD],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(run.returncode == 0 and os.path.exists(out),
          f"export CLI rc {run.returncode}: {run.stderr[-2000:]}")
    old = os.environ.get("ETA_MODEL_PATH")
    os.environ["ETA_MODEL_PATH"] = out
    try:
        config = load_config()
        svc = EtaService(config.serve, model_path=default_model_path(
            config.model), device=CARD)
    finally:
        if old is None:
            os.environ.pop("ETA_MODEL_PATH")
        else:
            os.environ["ETA_MODEL_PATH"] = old
    check(svc.available and svc.kernel == "torch_export",
          f"export not served: {svc.kernel} {svc.load_error}")
    ref = EtaService(config.serve, model_path=artifact, device=CARD)
    rows = random_rows(rng, OBS_BATCH)
    body = _obs_batch(rng, OBS_BATCH)
    with _Server(svc, config) as srv:
        status, health = _request(srv.port, "GET", "/api/health")
        scoring = health["checks"]["model"]["scoring"]
        check(scoring["kernel"] == "torch_export"
              and scoring["family"] == "eta_mlp", f"health {scoring}")
        before = fused_eta_forward.launches
        status, answer = _request(srv.port, "POST",
                                  "/api/predict_eta_batch", body)
        export_launches = fused_eta_forward.launches - before
        got = svc.predict_batch(rows)
    check(status == 200 and export_launches == 0,
          f"export served {status} with {export_launches} fused launches")
    before = fused_eta_forward.launches
    want = ref.predict_batch(rows)
    check(fused_eta_forward.launches > before or CARD != "cuda",
          "the msgpack artifact did not launch fused_eta")
    n_q = len(ref.quantiles)
    err = compare(torch.from_numpy(np.asarray(got, np.float32)),
                  torch.from_numpy(np.asarray(want, np.float32)),
                  TOL["bfloat16"], n_q)
    # The CLI held the loaded file bitwise to the program before saving
    # (its exit code); the served answers are that file's program's.
    with torch.no_grad():
        direct = load_exported_serving_fn(out, CARD)(
            torch.from_numpy(rows).to(CARD)).cpu().numpy()
    check(np.array_equal(np.asarray(got), direct),
          "the served export is not bitwise its program")
    print(f"[obs] export: CLI {cli_s:.1f} s (its file bitwise the program "
          f"before saving), served as torch_export with 0 fused launches, "
          f"bitwise the file's program; vs the kernel-served artifact max "
          f"abs {err[0]:.4g}, rel {err[1]:.4g} (tol {TOL['bfloat16']})")
    return {"cli_s": cli_s, "max_abs_err_vs_kernel": err[0],
            "max_rel_err_vs_kernel": err[1], "bitwise_vs_program": True}


def _obs_overhead_run():
    """The body of (g), run in a fresh process by :func:`_obs_overhead`:
    single-row ``/api/predict_eta`` wall ms with tracing off, at the
    default sample rate and at 1.0, in turns on one app (each request a
    new distance: no cache hit). → {setting: {p50_ms, p95_ms, n}}."""
    from routest_tpu_torch.core.config import load_config, load_obs_config
    from routest_tpu_torch.obs import trace
    from routest_tpu_torch.serve.ml_service import EtaService

    artifact = os.path.join(ROOT, "artifacts", "eta_mlp.msgpack")
    config = load_config()
    svc = EtaService(config.serve, model_path=artifact, device=CARD)
    settings = {"off": dict(enabled=False),
                "default": dict(sample_rate=load_obs_config({}).sample_rate),
                "1.0": dict(sample_rate=1.0)}
    samples = {k: [] for k in settings}
    km = 1000
    with _Server(svc, config) as srv:
        for _ in range(2):        # off, default, 1.0, twice in turn
            for name, kw in settings.items():
                trace.configure_tracer(trace.Tracer(**kw))
                for _ in range(OBS_OVERHEAD_REPS // 2):
                    km += 1
                    t0 = time.perf_counter()
                    status, _ = _request(srv.port, "POST",
                                         "/api/predict_eta",
                                         {"summary": {"distance": km}})
                    samples[name].append((time.perf_counter() - t0) * 1e3)
                    check(status == 200, f"overhead request {status}")
    out = {}
    for name, ms in samples.items():
        ms = sorted(ms)
        out[name] = {"p50_ms": ms[len(ms) // 2],
                     "p95_ms": ms[int(0.95 * (len(ms) - 1))], "n": len(ms)}
    return out


def _obs_overhead(smi_line):
    """(g), a record and not a gate: :func:`_obs_overhead_run` in a
    fresh process, so that this script's heap (every earlier phase's
    graphs and routers) does not time the garbage collector in with
    the spans."""
    from routest_tpu_torch.core.config import load_obs_config

    run = subprocess.run(
        [sys.executable, "-c", "import json, os, chip_smoke; "
         "chip_smoke.CARD = os.environ['ROUTEST_DEVICE']; "
         "print(json.dumps(chip_smoke._obs_overhead_run()))"],
        cwd=ROOT, env=dict(os.environ, ROUTEST_DEVICE=CARD),
        capture_output=True, text=True, timeout=600)
    check(run.returncode == 0, f"overhead run rc {run.returncode}: "
                               f"{run.stderr[-2000:]}")
    rec = json.loads(run.stdout.strip().splitlines()[-1])
    rec["default_sample_rate"] = load_obs_config({}).sample_rate
    rec["card"] = smi_line
    print(f"[obs] overhead ({smi_line}, a fresh process): single-row p95 "
          f"off {rec['off']['p95_ms']:.3f} ms, default "
          f"{rec['default']['p95_ms']:.3f} ms, 1.0 {rec['1.0']['p95_ms']:.3f}"
          f" ms (p50 {rec['off']['p50_ms']:.3f} / "
          f"{rec['default']['p50_ms']:.3f} / {rec['1.0']['p50_ms']:.3f})")
    return rec


def phase_obs(smi_line):
    """Phase 14, the replica's observability spine on the card. →
    record."""
    import tempfile

    import numpy as np

    from routest_tpu_torch.ops.fused_mlp import fused_eta_forward

    rng = np.random.default_rng(14)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        record = _obs_server(rng, tmp)
        before = fused_eta_forward.launches
        record["chaos"] = _obs_chaos(rng, tmp)
        record["export"] = _obs_export(rng, tmp)
        record["overhead"] = _obs_overhead(smi_line)
        record["fused_launches_in_process"] = (fused_eta_forward.launches
                                               - before)
    record["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"observability": record}))
    launches = (record["server_fused_launches"]
                + record["fused_launches_in_process"])
    if CARD == "cuda":
        check(record["fused_launches_in_process"] > 0,
              "observability: no fused launch in this process")
    return record, launches


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
        err_random = phase_random(rng)
        phase = "artifacts"
        err_artifacts = phase_artifacts(rng)
        phase = "serving"
        launches = phase_serving(rng)
        phase = "optimize"
        _, optimize_launches = phase_optimize()
        phase = "road"
        _, road_launches = phase_road()
        phase = "overlay"
        _, overlay_launches = phase_overlay()
        phase = "live"
        _, live_launches = phase_live()
        phase = "dispatch"
        phase_dispatch()
        phase = "serving-core"
        _, core_launches = phase_serving_core()
        phase = "train"
        _, train_launches = phase_train()
        phase = "observability"
        _, obs_launches = phase_obs(smi_line)
        phase = "times"
        table = phase_times(rng)
    except Exception as e:
        print(f"chip_smoke: phase {phase} FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    kernels = []
    for variant, kernel_name in KERNEL_NAMES.items():
        # the 4096-row bucket the batch endpoint fills
        row = next(r for r in table[variant]
                   if r["batch"] == SERVING_BUCKETS[-1])
        kernels.append({
            "name": kernel_name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES, "launches": launches[variant],
            "max_abs_err": max(err_random[variant], err_artifacts[variant]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "batch": row["batch"], "tile": row["tile"],
            "eager_ms": row["eager_ms"], "enqueue_ms": row["enqueue_ms"]})
    # the optimize path serves bf16: its launches over the use_ml_eta
    # requests
    kernels[0]["launches_optimize"] = optimize_launches
    # ... and over the road phase's use_ml_eta requests
    kernels[0]["launches_road"] = road_launches
    # ... and over the metro overlay deployment's use_ml_eta requests
    kernels[0]["launches_overlay"] = overlay_launches
    # ... and over the live phase's use_ml_eta routes (a server process)
    kernels[0]["launches_live"] = live_launches
    # ... and over phase 12's wire frames (4096 and 131,072 rows, HTTP
    # and channel)
    kernels[0]["launches_serving_core"] = core_launches
    # ... and over phase 13's serving of trained models: the bootstrap
    # server's requests and the CLI artifact's EtaService
    kernels[0]["launches_train"] = train_launches
    # ... and over phase 14's: the traced server's requests and this
    # process's chaos, export-comparison and overhead requests
    kernels[0]["launches_observability"] = obs_launches
    print(json.dumps({"kernels": kernels}))
    print(f"{smi_line}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
