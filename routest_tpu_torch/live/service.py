"""Serving-side live-traffic wiring (``RTPU_LIVE=1``).

The counterpart of ``routest_tpu/live/service.py``. One per server
process: owns the congestion state, the probe-channel ingester and the
metric customizer, bootstrapped on a background thread (building the
road router on a metro extract takes seconds — the server answers at
once and arms live traffic when ready). The router is the process-wide
``default_router`` on the serving device, the one ``road_graph: true``
requests route through, so a metric flip moves their routes and ETAs.
``RTPU_LIVE_RETRAIN_S`` > 0 also runs the continuous GNN trainer
(``live/trainer.py``) on that router's device; it is off by default, as
training competes with serving for the card.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from routest_tpu_torch.core.config import LiveConfig, load_live_config
from routest_tpu_torch.utils.logging import get_logger


class LiveTrafficService:
    """Owns state + ingester + customizer (+ optional trainer) on
    ``device``'s router."""

    def __init__(self, bus, cfg: Optional[LiveConfig] = None,
                 device=None) -> None:
        self.cfg = cfg or load_live_config()
        self._bus = bus
        self._device = device
        self.state = None
        self.ingester = None
        self.customizer = None
        self.router = None
        self.trainer = None
        self.ready = False
        self.error: Optional[str] = None
        self.started_unix: Optional[float] = None
        self._boot: Optional[threading.Thread] = None

    def start(self) -> None:
        """Arm live traffic asynchronously (never blocks serving boot)."""
        self.started_unix = time.time()
        self._boot = threading.Thread(target=self._bootstrap,
                                      name="live-bootstrap", daemon=True)
        self._boot.start()

    def _bootstrap(self) -> None:
        from routest_tpu_torch.live.customize import MetricCustomizer
        from routest_tpu_torch.live.ingest import ProbeIngester
        from routest_tpu_torch.live.state import CongestionState
        from routest_tpu_torch.optimize.road_router import default_router

        log = get_logger("routest_tpu_torch.live")
        try:
            cfg = self.cfg
            router = default_router(self._device)
            self.router = router
            self.state = CongestionState(
                router.freeflow_time_s,
                half_life_s=cfg.half_life_s, stale_s=cfg.stale_s,
                conf_obs=cfg.conf_obs, window=cfg.window)
            self.ingester = ProbeIngester(self._bus, self.state,
                                          router.length_m,
                                          channel=cfg.channel)
            self.ingester.start()
            self.customizer = MetricCustomizer(
                router, self.state, interval_s=cfg.customize_s,
                min_obs_edges=cfg.min_obs_edges,
                route_metric=cfg.route_metric)
            self.customizer.start()
            if cfg.retrain_s > 0:
                from routest_tpu_torch.live.trainer import ContinuousTrainer

                self.trainer = ContinuousTrainer(
                    router, self.state, steps=cfg.retrain_steps,
                    min_obs=cfg.retrain_min_obs)
                self.trainer.start(cfg.retrain_s)
            self.ready = True
            log.info("live_traffic_armed", channel=cfg.channel,
                     customize_s=cfg.customize_s,
                     route_metric=cfg.route_metric,
                     device=str(router.device),
                     boot_s=round(time.time() - self.started_unix, 1))
        except Exception as e:
            self.error = f"{type(e).__name__}: {e}"
            log.error("live_traffic_boot_failed", error=self.error)

    def stop(self) -> None:
        for part in (self.ingester, self.customizer, self.trainer):
            if part is not None:
                part.stop()

    def snapshot(self) -> Dict:
        """The ``/api/live`` payload."""
        out: Dict = {"enabled": True, "ready": self.ready,
                     "channel": self.cfg.channel}
        if self.error:
            out["error"] = self.error
        if self.state is not None:
            out["ingest"] = self.state.stats()
            if self.ingester is not None:
                out["ingest"]["batches"] = self.ingester.batches
        if self.customizer is not None:
            out["customize"] = self.customizer.snapshot()
        if self.router is not None:
            out["metric"] = self.router.live_info
            out["epoch"] = self.router.live_epoch
        if self.trainer is not None:
            out["retrain"] = {"cycles": self.trainer.cycles,
                              "last": dict(self.trainer.last_result)}
        return out
