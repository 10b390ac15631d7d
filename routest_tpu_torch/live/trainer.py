"""Continuous GNN refresh: recent observation window → verified swap.

The counterpart of ``routest_tpu/live/trainer.py``. Periodically re-fits
the road GNN on the estimator's recent observation window, on the
router's device, and writes the artifact atomically (``save_gnn``:
temp file, then rename). The serving router picks the new mtime up on
its next request and lands it through its verified swap
(``RoadRouter._maybe_reload_models`` → ``_verify_gnn_swap``: finiteness
and divergence gates). The trainer never writes the router's params:
it trains its own module, and the artifact file is the interface, so a
serving thread only ever sees a whole model.

Training shape: every graph edge carries messages (the aggregation the
model serves under), but the loss reads only window-observed edges,
each labeled with its window-mean seconds at its last observed hour.
Warm start: parameters continue from the previous cycle, or from the
current artifact when its fingerprint is this graph's, so a few dozen
AdamW steps (learning rate 1e-3, weight decay 1e-4) per cycle track a
drifting world. Unlike the JAX trainer, it refuses to save over an
artifact the JAX package ships (``artifacts/road_gnn*.msgpack``, the
default router's): a server that arms it (``RTPU_LIVE_RETRAIN_S > 0``)
points ``ROAD_GNN_PATH`` at a copy. Like the JAX trainer it has no
chaos points and no trace spans: it reports through the obs registry
(``rtpu_live_retrain_*``) and its logger.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from routest_tpu_torch.live.state import CongestionState
from routest_tpu_torch.utils.logging import get_logger

_metrics = None


def _trainer_metrics():
    global _metrics
    if _metrics is None:
        from routest_tpu_torch.obs import get_registry

        reg = get_registry()
        _metrics = {
            "runs": reg.counter(
                "rtpu_live_retrain_total",
                "Continuous-retrain cycles, by result "
                "(saved / skipped / rejected / failed).", ("result",)),
            "dur": reg.histogram(
                "rtpu_live_retrain_seconds",
                "One retrain cycle: window build + steps + save."),
        }
    return _metrics


class ContinuousTrainer:
    """Periodic re-fit of the road GNN on the observation window, on
    ``device`` (default: the router's)."""

    def __init__(self, router, state: CongestionState,
                 artifact_path: Optional[str] = None, *,
                 steps: int = 40, lr: float = 1e-3,
                 min_obs: int = 256, hidden: int = 64,
                 seed: int = 0, device=None) -> None:
        from routest_tpu_torch.core.config import resolve_device
        from routest_tpu_torch.train.checkpoint import default_gnn_path
        from routest_tpu_torch.train.report import is_jax_artifact

        self._router = router
        self._state = state
        self._path = (artifact_path or getattr(router, "_gnn_path", None)
                      or default_gnn_path())
        if is_jax_artifact(self._path):
            raise ValueError(
                f"{self._path}: the live retrainer never saves over an "
                f"artifact the JAX package ships; point the router at a "
                f"copy (ROAD_GNN_PATH)")
        self.device = resolve_device(
            device if device is not None else router.device,
            "ContinuousTrainer")
        self.steps = int(steps)
        self.lr = float(lr)
        self.min_obs = int(min_obs)
        self.hidden = int(hidden)
        self.seed = int(seed)
        self._graph = router.graph_dict()
        self._model = None
        self._opt = None
        self.cycles = 0
        self.last_result: Dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _ensure_model(self) -> None:
        if self._model is not None:
            return
        from routest_tpu_torch.core import prng
        from routest_tpu_torch.core.dtypes import F32_POLICY
        from routest_tpu_torch.models.gnn import RoadGNN
        from routest_tpu_torch.train.checkpoint import load_gnn
        from routest_tpu_torch.train.loop import AdamW

        # Warm start from the live artifact when it belongs to THIS
        # graph: continuity is what makes few-step cycles converge.
        try:
            model, _params, fp = load_gnn(self._path)
            if fp == self._router._fingerprint:
                model.policy = F32_POLICY
                self._model = model
        except Exception:  # rtpulint: disable=broad-except-unlogged -- warm-start is best-effort: any load failure falls back to fresh init
            self._model = None  # fresh init below; reason irrelevant
        if self._model is None:
            self._model = RoadGNN(n_nodes=len(self._graph["node_coords"]),
                                  hidden=self.hidden, n_rounds=2,
                                  policy=F32_POLICY).init(
                                      prng.prng_key(self.seed))
        self._model.to(self.device)
        self._opt = AdamW(list(self._model.parameters()), self.lr, 1e-4)

    def run_once(self) -> Dict:
        """One retrain cycle; returns a result dict, never raises."""
        from routest_tpu_torch.models.gnn import (GraphBatch,
                                                  edge_feature_array)

        m = _trainer_metrics()
        t0 = time.perf_counter()
        log = get_logger("routest_tpu_torch.live")
        try:
            win = self._state.window()
            n_obs = len(win["edge"])
            if n_obs < self.min_obs:
                m["runs"].labels(result="skipped").inc()
                self.last_result = {
                    "trained": False,
                    "reason": f"window {n_obs} < min_obs {self.min_obs}"}
                return self.last_result
            g = self._graph
            n_edges = len(g["senders"])
            # Per-edge window aggregation: mean observed seconds, last
            # observed hour (the window is oldest-first, so a plain index
            # write leaves the LAST occurrence standing).
            sums = np.zeros(n_edges, np.float64)
            counts = np.zeros(n_edges, np.float64)
            np.add.at(sums, win["edge"], win["time_s"])
            np.add.at(counts, win["edge"], 1.0)
            observed = counts > 0
            targets = np.zeros(n_edges, np.float32)
            targets[observed] = (sums[observed]
                                 / counts[observed]).astype(np.float32)
            hours = np.full(n_edges, time.localtime().tm_hour, np.int32)
            hours[win["edge"]] = win["hour"]
            self._ensure_model()
            dev = self.device

            def on_dev(a, dtype):
                return torch.from_numpy(np.asarray(a, dtype)).to(dev)

            batch = GraphBatch(
                senders=on_dev(g["senders"], np.int64),
                receivers=on_dev(g["receivers"], np.int64),
                edge_feats=on_dev(edge_feature_array(
                    g["length_m"], g["speed_limit"], g["road_class"],
                    hours), np.float32),
                length_m=on_dev(g["length_m"], np.float32),
                speed_limit=on_dev(g["speed_limit"], np.float32),
                targets=on_dev(targets, np.float32),
                weights=torch.ones(n_edges, dtype=torch.float32, device=dev))
            loss_w = on_dev(observed, np.float32)
            coords = on_dev(g["node_coords"], np.float32)
            model, opt = self._model, self._opt
            # The cycle trains on copies: a rejected cycle leaves the
            # carried-forward params and optimizer state as they were.
            saved = ([p.detach().clone() for p in opt.params],
                     opt.state_dict())
            loss = torch.tensor(float("nan"))
            for _ in range(self.steps):
                loss = model.loss(coords, batch, loss_weights=loss_w)
                opt.step(torch.autograd.grad(loss, opt.params))
            loss = float(loss.detach())
            with torch.no_grad():
                pred = model.predict(
                    coords, batch.senders, batch.receivers,
                    batch.edge_feats, batch.length_m, batch.speed_limit,
                    weights=batch.weights).float().cpu().numpy()
            reason = (f"non-finite loss {loss}" if not np.isfinite(loss)
                      else None if np.isfinite(pred).all()
                      else "non-finite predictions after fit")
            if reason is not None:
                with torch.no_grad():
                    for p, old in zip(opt.params, saved[0]):
                        p.copy_(old)
                opt.load_state_dict(saved[1])
                m["runs"].labels(result="rejected").inc()
                self.last_result = {"trained": False, "reason": reason}
                return self.last_result
            # Accept the cycle: land the artifact atomically (the router
            # verifies again, independently, before ITS generation flips).
            from routest_tpu_torch.train.checkpoint import save_gnn

            save_gnn(self._path, model, g)
            dur = time.perf_counter() - t0
            self.cycles += 1
            m["runs"].labels(result="saved").inc()
            m["dur"].observe(dur)
            obs_rmse = float(np.sqrt(np.mean(
                (pred[observed] - targets[observed]) ** 2)))
            self.last_result = {
                "trained": True, "observations": n_obs,
                "edges_labeled": int(observed.sum()),
                "loss": round(loss, 3),
                "window_rmse_s": round(obs_rmse, 3),
                "train_s": round(dur, 3), "path": self._path}
            log.info("live_retrain_saved", **self.last_result)
            return self.last_result
        except Exception as e:
            m["runs"].labels(result="failed").inc()
            log.error("live_retrain_failed",
                      error=f"{type(e).__name__}: {e}")
            self.last_result = {"trained": False,
                                "reason": f"{type(e).__name__}: {e}"}
            return self.last_result

    def start(self, interval_s: float = 30.0) -> None:
        def run() -> None:
            while not self._stop.wait(interval_s):
                self.run_once()

        self._thread = threading.Thread(target=run, name="live-trainer",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
