"""CPU baseline: the golden-RMSE reference the trained model must match.

A copy of ``routest_tpu/train/baseline.py`` without its writer: the
port never rewrites the committed record. sklearn is imported inside
``train_cpu_baseline``, so the module loads where sklearn is missing
(the card's machine) and ``load_baseline`` reads the committed record
there.

BASELINE.json demands "RMSE ≤ CPU-baseline RMSE", but the reference never
committed the baseline (empty ``notebooks/``, LFS-pointer model —
SURVEY.md §6). So the baseline is built here: a sklearn
HistGradientBoostingRegressor (the same model family as the reference's
XGBoost artifact) trained on the same 12-feature matrix. Its eval RMSE is
frozen to ``artifacts/baseline.json`` and the test suite asserts the JAX
model stays within tolerance of it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

from routest_tpu_torch.data.features import batch_from_mapping


def train_cpu_baseline(train_data: Dict[str, np.ndarray],
                       eval_data: Dict[str, np.ndarray]) -> Dict:
    from sklearn.ensemble import HistGradientBoostingRegressor

    x_train = batch_from_mapping(train_data)
    y_train = np.asarray(train_data["eta_minutes"], np.float64)
    x_eval = batch_from_mapping(eval_data)
    y_eval = np.asarray(eval_data["eta_minutes"], np.float64)

    model = HistGradientBoostingRegressor(
        max_iter=300, learning_rate=0.08, max_depth=None, random_state=0
    )
    t0 = time.time()
    model.fit(x_train, y_train)
    fit_s = time.time() - t0

    pred = model.predict(x_eval)
    rmse = float(np.sqrt(np.mean((pred - y_eval) ** 2)))

    # Single-row latency — the reference's serving mode (one HTTP request =
    # one model row, ``Flaskr/ml.py:51-53``): measures config 1 of
    # BASELINE.json.
    one = x_eval[:1]
    for _ in range(3):
        model.predict(one)
    t0 = time.time()
    n_single = 200
    for i in range(n_single):
        model.predict(x_eval[i % len(x_eval): i % len(x_eval) + 1])
    single_row_s = (time.time() - t0) / n_single

    # Bulk CPU throughput for context.
    t0 = time.time()
    model.predict(x_eval)
    bulk_s = time.time() - t0

    return {
        "model": "sklearn.HistGradientBoostingRegressor(max_iter=300)",
        "rmse_minutes": rmse,
        "fit_seconds": fit_s,
        "single_row_latency_s": single_row_s,
        "single_row_preds_per_sec": 1.0 / single_row_s,
        "bulk_preds_per_sec": len(x_eval) / bulk_s,
        "n_train": len(y_train),
        "n_eval": len(y_eval),
        "_model_obj": model,
    }


def baseline_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "artifacts",
        "baseline.json",
    )


def load_baseline(path: Optional[str] = None) -> Optional[Dict]:
    path = path or baseline_path()
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
