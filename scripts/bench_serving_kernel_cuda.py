"""Per-bucket record of the served ETA artifact: the hand-written kernel
against its plain PyTorch version, on the card.

The port's counterpart of ``scripts/bench_serving_kernel.py``. On the
artifact serving loads (``artifacts/eta_mlp.msgpack``: quantiles, bf16
compute), at every bucket of ``ServeConfig.batch_buckets`` and two
larger batches, for each kernel variant (bf16 and int8):

- ``fused_eta.cu`` at each tile the kernel is built for (16 and 32 rows
  per block): device time per launch from a CUDA graph of launches
  (``utils/cuda_timing.graph_ms``); the faster tile is kept;
- the kernel at that tile launched eagerly, back to back, as a flush
  launches it (``utils/cuda_timing.time_ms``);
- the plain version (``fused_eta_forward_plain``), eagerly the same way.

Each time is the median of ``--repeats`` measurements. The kernel wins
a batch when its eager time is below the plain version's.

Writes two records (``--out`` names another directory for both):

- ``artifacts/serving_kernel_cuda.json``: ``rows`` for the served dtype
  (``batch``, ``kernel_us``, ``kernel_mpreds_s``, ``kernel_tile``,
  ``kernel_eager_us``, ``plain_us``, ``plain_mpreds_s``, ``winner``),
  every dtype's rows under ``rows_by_dtype``; the goodput watchdog pins
  its expected curve from ``rows`` (``obs/efficiency.py``);
- ``artifacts/kernel_bench_cuda.json``: the selection table serving
  reads and names in health
  (``serve/ml_service.py::EtaService._fused_selection``; a table in
  which the plain version won a batch is refused there): per
  dtype under ``by_dtype`` (the served dtype's also at the top level),
  rows of ``batch``, ``kernel_tile`` and ``winner``, and
  ``kernel_wins_max_bucket``: the largest batch up to which the kernel
  won every measured batch.

Both carry ``backend``, ``device`` (``torch.cuda.get_device_name``),
``power_limit`` (``nvidia-smi``), the torch and CUDA versions and
``recorded_unix``. ``--cpu`` measures the plain version on the host for
testing: its records say ``backend: "cpu"``, which selection and the
watchdog refuse, and it writes only where ``--out`` says.

Usage: python3 scripts/bench_serving_kernel_cuda.py [--out DIR]
       [--batches 8 64 ...] [--repeats 5] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SCALING_BATCHES = (8192, 16384)
DTYPES = ("bfloat16", "int8")
SERVING_RECORD = "serving_kernel_cuda.json"
SELECTION_RECORD = "kernel_bench_cuda.json"


def power_limit():
    """``nvidia-smi``'s power limit of card 0 ("700.00 W"), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    line = out.strip().splitlines()[0] if out.strip() else ""
    return line.rsplit(",", 1)[-1].strip() if "," in line else None


def _median_ms(measure, repeats):
    return statistics.median(measure() for _ in range(repeats))


def _host_ms(fn, iters):
    """Median host ms per call (the CPU run's stand-in for CUDA events)."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def measure_dtype(model, params, dtype, x_all, batches, device, repeats):
    """→ rows for one kernel variant (module docstring)."""
    import torch

    from routest_tpu_torch.ops.fused_mlp import (_TILES, fused_eta_forward,
                                                 fused_eta_forward_plain,
                                                 pack_eta_params)
    from routest_tpu_torch.utils.cuda_timing import graph_ms, time_ms

    packed = pack_eta_params(model, params, dtype=dtype, device=device)
    n_q = len(model.quantiles)
    rows = []
    for b in batches:
        x = torch.from_numpy(x_all[:b]).to(device)

        def kernel(tile):
            return lambda: fused_eta_forward(packed, x, n_q=n_q, tile=tile)

        def plain():
            return fused_eta_forward_plain(packed, x, n_q=n_q)

        if device == "cuda":
            by_tile = {t: _median_ms(lambda: graph_ms(kernel(t)), repeats)
                       for t in _TILES}
            tile = min(by_tile, key=by_tile.get)
            eager = _median_ms(lambda: time_ms(
                kernel(tile), max(20, min(500, 50_000 // b)))[0], repeats)
            plain_ms = _median_ms(lambda: time_ms(
                plain, max(5, min(50, 20_000 // b)))[0], repeats)
        else:   # the wrapper runs the plain version on a CPU tensor
            plain_ms = _host_ms(plain, repeats)
            tile, eager = _TILES[0], _host_ms(kernel(_TILES[0]), repeats)
            by_tile = {tile: eager}
        rows.append({
            "batch": b, "kernel_tile": tile,
            "kernel_us": by_tile[tile] * 1e3,
            "kernel_us_by_tile": {str(t): ms * 1e3
                                  for t, ms in by_tile.items()},
            "kernel_mpreds_s": b / (by_tile[tile] * 1e3),
            "kernel_eager_us": eager * 1e3,
            "plain_us": plain_ms * 1e3,
            "plain_mpreds_s": b / (plain_ms * 1e3),
            "winner": "kernel" if eager < plain_ms else "plain",
            "speedup": plain_ms / eager})
        r = rows[-1]
        print(f"[{dtype}] batch {b:5d}: kernel {r['kernel_us']:.3f} us "
              f"(tile {tile}; by tile {r['kernel_us_by_tile']}), eager "
              f"{r['kernel_eager_us']:.3f} us, plain {r['plain_us']:.3f} us "
              f"-> {r['winner']}", flush=True)
    return rows


def win_bucket(rows) -> int:
    """The largest batch up to which the kernel won every measured batch
    (0 when it lost the smallest)."""
    win = 0
    for row in sorted(rows, key=lambda r: r["batch"]):
        if row["winner"] != "kernel":
            break
        win = row["batch"]
    return win


def main(argv=None) -> int:
    from routest_tpu_torch.core.config import ServeConfig

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", type=int, nargs="+",
                        default=list(ServeConfig.batch_buckets)
                        + list(SCALING_BATCHES))
    parser.add_argument("--dtypes", nargs="+", default=list(DTYPES))
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--model", default=os.path.join(
        REPO, "artifacts", "eta_mlp.msgpack"))
    parser.add_argument("--cpu", action="store_true",
                        help="measure on the host (a record selection and "
                             "the watchdog refuse); needs --out")
    parser.add_argument("--out", help="directory for both records "
                                      "(default: artifacts/)")
    args = parser.parse_args(argv)
    if args.cpu and not args.out:
        parser.error("--cpu writes only where --out says")

    import torch

    from routest_tpu_torch.data.features import batch_from_mapping
    from routest_tpu_torch.data.synthetic import generate_dataset
    from routest_tpu_torch.ops.fused_mlp import resolve_kernel_dtype
    from routest_tpu_torch.train.checkpoint import load_model

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("bench_serving_kernel_cuda: no CUDA device (use --cpu)",
              file=sys.stderr)
        return 2
    model, params = load_model(args.model)
    served = resolve_kernel_dtype(model)   # the variant the card serves
    x_all = batch_from_mapping(generate_dataset(max(args.batches), seed=7))
    batches = sorted(set(args.batches))
    by_dtype = {d: measure_dtype(model, params, d, x_all, batches, device,
                                 args.repeats) for d in args.dtypes}
    identity = {
        "backend": device,
        "device": (torch.cuda.get_device_name(0) if device == "cuda"
                   else "cpu"),
        "power_limit": power_limit() if device == "cuda" else None,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "recorded_unix": int(time.time()),
        "script": "scripts/bench_serving_kernel_cuda.py",
        "model": os.path.relpath(os.path.abspath(args.model), REPO),
        "quantiles": list(model.quantiles), "kernel_dtype": served,
        "repeats": args.repeats}
    wins = {d: win_bucket(rows) for d, rows in by_dtype.items()}
    serving = dict(identity, rows=by_dtype.get(served, []),
                   rows_by_dtype=by_dtype,
                   kernel_wins_max_bucket=wins.get(served, 0),
                   kernel_wins_max_bucket_by_dtype=wins)
    tables = {d: {"rows": [{k: r[k] for k in ("batch", "kernel_tile",
                                              "winner", "kernel_eager_us",
                                              "plain_us")}
                           for r in rows],
                  "kernel_wins_max_bucket": wins[d]}
              for d, rows in by_dtype.items()}
    selection = dict(identity, **tables.get(served, {}), by_dtype=tables)
    out = args.out or os.path.join(REPO, "artifacts")
    os.makedirs(out, exist_ok=True)
    for name, record in ((SERVING_RECORD, serving),
                         (SELECTION_RECORD, selection)):
        with open(os.path.join(out, name), "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
        print(f"wrote {os.path.join(out, name)}")
    print(json.dumps({"kernel_wins_max_bucket": wins,
                      "device": identity["device"],
                      "power_limit": identity["power_limit"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
