"""Tensorized GBDT inference: tree ensembles as batched gather chains.

The counterpart of ``routest_tpu/models/gbdt.py``. The reference's
production model is an XGBoost regressor (``Flaskr/ml.py`` walks its
pickled trees one row at a time on a CPU). Here a fitted ensemble is
exported once into padded ``(T, max_nodes)`` arrays — split feature,
threshold, left and right child, leaf value, NaN direction — that live
on the device, and inference keeps a ``(B, T)`` cursor of the current
node per (row, tree) through ``max_depth`` rounds of
``cursor = where(x[f] < thr, left, right)``. Leaves point at themselves,
so rounds past a shallow tree's leaf change nothing. The prediction is
the base score plus the sum of the trees' leaf values.

The comparison is the ensemble's own, evaluated as declared: XGBoost
sends ``x < thr`` left (``strict=True``), sklearn ``x <= thr``. A
threshold is never nudged to turn one into the other: ``nextafter(0.0,
-inf)`` is subnormal, and a device that flushes subnormals to zero would
turn every ``x < 0`` split into ``x <= 0``. A NaN feature follows the
node's ``missing_left``.

The JAX package computes this with XLA gathers, not a Pallas kernel; so
does this module, with torch ops. Index arrays are int32 and flat
indices are formed in int32 (``index_select`` takes them), so an
ensemble needs ``T · max_nodes`` and ``B · n_features`` below 2**31.
The trees' values are summed in one reduction, as the JAX package's
``leaf_values.sum(axis=1)``; the two reductions may add in different
orders, so predictions agree within float32 rounding, while the leaf
cursors are bitwise.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
from typing import Dict, Tuple

import numpy as np
import torch

from routest_tpu_torch.core.config import resolve_device

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GBDT:
    """Static shape and comparison mode of a tensorized tree ensemble."""

    n_trees: int
    max_nodes: int
    max_depth: int
    strict: bool = False

    def leaf_cursors(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """(B, F) float32 features → (B, T) int32 leaf index per tree."""
        b, n_features = x.shape
        dev = x.device
        tree_base = (torch.arange(self.n_trees, dtype=torch.int32,
                                  device=dev) * self.max_nodes)[None, :]
        row_base = (torch.arange(b, dtype=torch.int32, device=dev)
                    * n_features)[:, None]
        x_flat = x.reshape(-1)
        feature = params["feature"].reshape(-1)
        threshold = params["threshold"].reshape(-1)
        left = params["left"].reshape(-1)
        right = params["right"].reshape(-1)
        missing_left = params["missing_left"].reshape(-1)
        cursor = torch.zeros((b, self.n_trees), dtype=torch.int32,
                             device=dev)
        for _ in range(self.max_depth):
            node = (tree_base + cursor).reshape(-1)
            f = feature.index_select(0, node).view(b, self.n_trees)
            thr = threshold.index_select(0, node).view(b, self.n_trees)
            xv = x_flat.index_select(0, (row_base + f).reshape(-1)).view(
                b, self.n_trees)
            cmp = (xv < thr) if self.strict else (xv <= thr)
            go_left = torch.where(
                torch.isnan(xv),
                missing_left.index_select(0, node).view(b, self.n_trees),
                cmp)
            cursor = torch.where(
                go_left, left.index_select(0, node).view(b, self.n_trees),
                right.index_select(0, node).view(b, self.n_trees))
        return cursor

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """(B, F) float32 features → (B,) predictions."""
        cursor = self.leaf_cursors(params, x)
        b = x.shape[0]
        tree_base = (torch.arange(self.n_trees, dtype=torch.int32,
                                  device=x.device) * self.max_nodes)[None, :]
        leaf = params["value"].reshape(-1).index_select(
            0, (tree_base + cursor).reshape(-1)).view(b, self.n_trees)
        return params["baseline"] + leaf.sum(dim=1)


def _to_params(arrays: Dict[str, np.ndarray], baseline: float,
               device) -> Params:
    dev = resolve_device(device, "gbdt")
    params = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for k, v in arrays.items()}
    params["baseline"] = torch.tensor(baseline, dtype=torch.float32,
                                      device=dev)
    return params


def _empty_arrays(n_trees: int, max_nodes: int) -> Dict[str, np.ndarray]:
    return {
        "feature": np.zeros((n_trees, max_nodes), np.int32),
        "threshold": np.full((n_trees, max_nodes), np.inf, np.float32),
        "left": np.zeros((n_trees, max_nodes), np.int32),
        "right": np.zeros((n_trees, max_nodes), np.int32),
        "value": np.zeros((n_trees, max_nodes), np.float32),
        "missing_left": np.zeros((n_trees, max_nodes), bool),
    }


def from_sklearn(model, device=None) -> Tuple[GBDT, Params]:
    """Export a fitted sklearn ``HistGradientBoostingRegressor``
    (``x <= thr`` goes left)."""
    predictors = [p[0] for p in model._predictors]
    n_trees = len(predictors)
    max_nodes = max(len(p.nodes) for p in predictors)
    max_depth = int(max(p.nodes["depth"].max() for p in predictors)) + 1
    arr = _empty_arrays(n_trees, max_nodes)
    for t, p in enumerate(predictors):
        nodes = p.nodes
        n = len(nodes)
        is_leaf = nodes["is_leaf"].astype(bool)
        idx = np.arange(n, dtype=np.int32)
        arr["feature"][t, :n] = np.where(is_leaf, 0, nodes["feature_idx"])
        arr["threshold"][t, :n] = np.where(is_leaf, np.inf,
                                           nodes["num_threshold"])
        # leaves self-loop so extra descent rounds are no-ops
        arr["left"][t, :n] = np.where(is_leaf, idx, nodes["left"])
        arr["right"][t, :n] = np.where(is_leaf, idx, nodes["right"])
        arr["value"][t, :n] = np.where(is_leaf, nodes["value"], 0.0)
        arr["missing_left"][t, :n] = nodes["missing_go_to_left"].astype(bool)
    baseline = float(np.ravel(model._baseline_prediction)[0])
    return (GBDT(n_trees=n_trees, max_nodes=max_nodes, max_depth=max_depth,
                 strict=False),
            _to_params(arr, baseline, device))


# ── XGBoost importer ──────────────────────────────────────────────────────
#
# XGBoost's own JSON model format (``booster.save_model("m.json")``) is
# the portable form of the reference's pickled regressor. Semantics kept
# exactly: ``x < split_condition`` goes left (``strict=True``); NaN
# follows ``default_left``; leaf values sit in ``split_conditions`` at
# leaf nodes; prediction = base_score + Σ leaf values, an identity link,
# so only ``reg:*`` objectives are accepted.


def from_xgboost_json(path: str, device=None) -> Tuple[GBDT, Params]:
    """XGBoost JSON model file (optionally ``.gz``) → (GBDT, params)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    try:
        learner = data["learner"]
        objective = learner["objective"]["name"]
        trees = learner["gradient_booster"]["model"]["trees"]
        base_score = float(learner["learner_model_param"]["base_score"])
    except (KeyError, TypeError) as e:
        raise ValueError(f"{path}: not an XGBoost JSON model ({e})") from None
    if not objective.startswith("reg:"):
        raise ValueError(
            f"{path}: objective {objective!r} needs a non-identity link; "
            f"only reg:* objectives are supported")
    if not trees:
        raise ValueError(f"{path}: model has no trees")

    n_trees = len(trees)
    max_nodes = max(len(t["left_children"]) for t in trees)
    arr = _empty_arrays(n_trees, max_nodes)
    max_depth = 1
    for t, tree in enumerate(trees):
        lc = np.asarray(tree["left_children"], np.int32)
        rc = np.asarray(tree["right_children"], np.int32)
        cond = np.asarray(tree["split_conditions"], np.float32)
        split_idx = np.asarray(tree["split_indices"], np.int32)
        default = np.asarray(tree["default_left"], bool)
        n = len(lc)
        is_leaf = lc == -1
        idx = np.arange(n, dtype=np.int32)
        arr["feature"][t, :n] = np.where(is_leaf, 0, split_idx)
        arr["threshold"][t, :n] = np.where(is_leaf, np.inf, cond)
        arr["left"][t, :n] = np.where(is_leaf, idx, lc)
        arr["right"][t, :n] = np.where(is_leaf, idx, rc)
        arr["value"][t, :n] = np.where(is_leaf, cond, 0.0)  # leaf value slot
        arr["missing_left"][t, :n] = np.where(is_leaf, False, default)
        max_depth = max(max_depth, _tree_depth(lc, rc))
    return (GBDT(n_trees=n_trees, max_nodes=max_nodes, max_depth=max_depth,
                 strict=True),
            _to_params(arr, base_score, device))


def _tree_depth(lc: np.ndarray, rc: np.ndarray) -> int:
    """Descent rounds a tree needs: the edge-count depth of its deepest
    leaf plus the root round, found iteratively (no recursion limit on
    degenerate chain trees)."""
    depth = np.zeros(len(lc), np.int32)
    best = 0
    stack = [0]
    while stack:
        node = stack.pop()
        for child in (lc[node], rc[node]):
            if child >= 0:
                depth[child] = depth[node] + 1
                best = max(best, int(depth[child]))
                stack.append(int(child))
    return best + 1


@dataclasses.dataclass(frozen=True)
class XGBoostEta:
    """``EtaService``'s view of a tree ensemble: the reference's
    12-feature ABI in, minutes out — a stand-in for ``Flaskr/ml.py``'s
    pickled booster, as tensor ops on the serving device."""

    gbdt: GBDT
    n_features: int = 12
    quantiles: Tuple[float, ...] = ()

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self.gbdt.apply(params, x.to(torch.float32))


def load_xgboost_eta(path: str, device=None) -> Tuple[XGBoostEta, Params]:
    gbdt, params = from_xgboost_json(path, device=device)
    return XGBoostEta(gbdt=gbdt), params
