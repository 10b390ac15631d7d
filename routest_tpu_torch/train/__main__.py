"""Train the ETA model on the card: ``python -m routest_tpu_torch.train``.

The counterpart of ``scripts/train_eta.py``:

1. the delivery dataset (``data/synthetic.py``, or ``--csv``), split
   90/10 by ``train_eval_split``;
2. the CPU baseline RMSE: sklearn's HistGradientBoosting trained here
   where sklearn is installed; where it is not (the card's machine),
   the committed ``artifacts/baseline.json``, read only when its
   ``n_train + n_eval`` is this dataset's size. That record is never
   rewritten;
3. ``fit`` on the device (the card unless ``--device cpu`` or
   ``ROUTEST_DEVICE=cpu``), saved as an ``RTPU1`` artifact to ``--save``
   or ``ETA_MODEL_PATH`` (one of them is required, and neither may
   name an artifact the JAX package ships);
4. acceptance: eval RMSE ≤ baseline × 1.02 for a point model, × 1.10
   for a quantile model (its median minimizes absolute, not squared,
   error), with per-quantile coverage for quantile models. The report,
   stamped with the device's name and power limit, goes to
   ``artifacts/training_report_cuda.json`` unless ``--report`` names
   another path. Exits 1 when the run misses its margin.

    python -m routest_tpu_torch.train [--n 500000] [--epochs 30]
        [--seed 0] [--csv PATH] [--quick] [--quantiles 0.1,0.5,0.9]
        [--save PATH] [--report PATH] [--device cuda|cpu]

The training settings start from the environment (``RTPU_TRAIN_BATCH``,
``RTPU_LR``, ``RTPU_EPOCHS``, ``RTPU_SEED``, ``RTPU_CKPT_DIR``; see
``core/config.py``); ``--epochs``, ``--seed`` and ``--quick`` override
them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m routest_tpu_torch.train")
    parser.add_argument("--n", type=int, default=500_000)
    parser.add_argument("--epochs", type=int, default=None,
                        help="default: RTPU_EPOCHS, else 30")
    parser.add_argument("--seed", type=int, default=None,
                        help="default: RTPU_SEED, else 0")
    parser.add_argument("--csv", type=str, default=None,
                        help="train from a delivery-history CSV "
                             "(data/csv_io.py schema)")
    parser.add_argument("--quick", action="store_true",
                        help="50,000 rows, 8 epochs")
    parser.add_argument("--quantiles", type=str, default=None,
                        help="comma-separated quantile levels including "
                             "0.5, e.g. 0.1,0.5,0.9 (pinball loss)")
    parser.add_argument("--save", default=None,
                        help="artifact path (default: ETA_MODEL_PATH)")
    parser.add_argument("--report", default=None,
                        help="report path (default: artifacts/"
                             "training_report_cuda.json)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.quick:
        args.n, args.epochs = 50_000, 8
    return args


def train_config(args: argparse.Namespace):
    """The environment's ``TrainConfig`` (``RTPU_TRAIN_BATCH``,
    ``RTPU_LR``, ``RTPU_EPOCHS``, ``RTPU_SEED``, ``RTPU_CKPT_DIR``), with
    the ``--epochs`` and ``--seed`` flags overriding it."""
    import dataclasses

    from routest_tpu_torch.core.config import load_config

    overrides = {k: getattr(args, k) for k in ("epochs", "seed")
                 if getattr(args, k) is not None}
    return dataclasses.replace(load_config().train, **overrides)


def baseline_rmse(train, ev, n_rows: int) -> dict:
    """Step 2: the CPU baseline, trained here or read from the committed
    record. Raises SystemExit when neither is possible."""
    from routest_tpu_torch.train.baseline import (baseline_path,
                                                  load_baseline,
                                                  train_cpu_baseline)

    try:
        import sklearn  # noqa: F401
    except ImportError:
        record = load_baseline()
        if record is None:
            raise SystemExit(f"sklearn is not installed and there is no "
                             f"baseline record at {baseline_path()}")
        if record["n_train"] + record["n_eval"] != n_rows:
            raise SystemExit(
                f"sklearn is not installed, and the committed baseline "
                f"({baseline_path()}) was trained on "
                f"{record['n_train'] + record['n_eval']} rows, not "
                f"{n_rows}")
        print(f"      sklearn is not installed: read the committed "
              f"baseline {baseline_path()} ({record['n_train']}/"
              f"{record['n_eval']} rows)")
        return dict(record, source="committed")
    baseline = train_cpu_baseline(train, ev)
    public = {k: v for k, v in baseline.items() if not k.startswith("_")}
    return dict(public, source="trained")


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    model_path = args.save or os.environ.get("ETA_MODEL_PATH")
    if not model_path:
        raise SystemExit("no artifact path: pass --save PATH or set "
                         "ETA_MODEL_PATH")

    from routest_tpu_torch.core.config import resolve_device
    from routest_tpu_torch.data.features import batch_from_mapping
    from routest_tpu_torch.data.synthetic import (generate_dataset,
                                                  train_eval_split)
    from routest_tpu_torch.models.eta_mlp import EtaMLP
    from routest_tpu_torch.train.checkpoint import save_model
    from routest_tpu_torch.train.loop import fit
    from routest_tpu_torch.train.report import (artifacts_path,
                                                device_record,
                                                refuse_jax_artifact,
                                                write_report)

    refuse_jax_artifact(model_path)
    cfg = train_config(args)
    dev = resolve_device(args.device, "routest_tpu_torch.train")
    if args.csv:
        from routest_tpu_torch.data.csv_io import load_csv

        print(f"[1/4] dataset: {args.csv}")
        data = load_csv(args.csv)
    else:
        print(f"[1/4] dataset: n={args.n}")
        data = generate_dataset(args.n, seed=cfg.seed)
    n_rows = len(data["eta_minutes"])
    train, ev = train_eval_split(data)
    print(f"      train={len(train['eta_minutes'])} "
          f"eval={len(ev['eta_minutes'])} target std="
          f"{float(np.std(ev['eta_minutes'])):.2f} min")

    print("[2/4] CPU baseline (HistGradientBoosting)…")
    baseline = baseline_rmse(train, ev, n_rows)
    print(f"      RMSE={baseline['rmse_minutes']:.3f} min")

    quantiles = (tuple(float(v) for v in args.quantiles.split(","))
                 if args.quantiles else ())
    print(f"[3/4] MLP on {dev}: epochs={cfg.epochs}"
          + (f" quantiles={list(quantiles)}" if quantiles else ""))
    model = EtaMLP(quantiles=quantiles)
    t0 = time.perf_counter()
    result = fit(model, train, ev, cfg,
                 log_every=max(1, cfg.epochs // 5), device=dev)
    fit_s = time.perf_counter() - t0
    steps = result.optimizer.count
    print(f"      RMSE={result.eval_rmse:.3f} min in {fit_s:.1f}s "
          f"({steps} steps, {fit_s * 1e3 / max(steps, 1):.3f} ms/step)")
    save_model(model_path, model)
    print(f"      artifact → {model_path}")

    margin = 1.10 if quantiles else 1.02
    print(f"[4/4] acceptance: RMSE ≤ CPU baseline RMSE × {margin}")
    ok = result.eval_rmse <= baseline["rmse_minutes"] * margin
    report = {
        "n": n_rows,
        "epochs": cfg.epochs,
        "cpu_baseline_rmse_minutes": baseline["rmse_minutes"],
        "cpu_baseline_source": baseline["source"],
        "mlp_rmse_minutes": result.eval_rmse,
        "rmse_ratio": result.eval_rmse / baseline["rmse_minutes"],
        "rmse_margin": margin,
        "mlp_fit_seconds": fit_s,
        "steps": steps,
        "ms_per_step": fit_s * 1e3 / max(steps, 1),
        "device": device_record(dev),
        "passed": bool(ok),
    }
    if quantiles:
        import torch

        x = torch.from_numpy(batch_from_mapping(ev)).to(dev)
        y = np.asarray(ev["eta_minutes"], np.float32)
        with torch.no_grad():
            preds = model.apply_quantiles(x).float().cpu().numpy()
        report["quantiles"] = list(quantiles)
        report["coverage"] = {
            f"{q:g}": float((y <= preds[:, i]).mean())
            for i, q in enumerate(quantiles)}
        print(f"      coverage: {report['coverage']}")
    out = write_report(args.report
                       or artifacts_path("training_report_cuda.json"), report)
    print(f"      {'PASS' if ok else 'FAIL'} "
          f"(ratio {report['rmse_ratio']:.4f}) → {out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
