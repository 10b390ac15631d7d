"""Live traffic: the loop from city-wide probes to served routes.

The counterpart of ``routest_tpu/live``:

- ``probes``    — the seeded probe fleet (drivers random-walking the
  road graph, publishing per-edge speed observations over the bus) and
  the scenario that jams a corridor at a named time;
- ``state``     — the per-edge decayed-EWMA congestion estimator with
  staleness windows and observation-count confidence;
- ``ingest``    — the bus subscriber folding observation batches into
  the state;
- ``customize`` — the metric customizer re-pricing the partition
  overlay against the live metric and flipping the router;
- ``trainer``   — the continuous GNN re-fit on the observation window,
  landed through the router's verified GNN swap;
- ``service``   — the serving-side wiring (``RTPU_LIVE=1``).

The cross-region bridge is not ported. This
module stays import-light: the metric-epoch global lives here so the
serving fast lane can key its prediction cache on ``(model generation,
metric epoch)`` without importing the rest.
"""

from __future__ import annotations

_METRIC_EPOCH = 0


def metric_epoch() -> int:
    """The live-metric generation currently serving in this process
    (0 = frozen world). Part of the fast-lane cache key, so no cached
    result outlives a metric flip."""
    return _METRIC_EPOCH


def set_metric_epoch(epoch: int) -> None:
    """Called by ``RoadRouter.install_live_metric`` at flip time."""
    global _METRIC_EPOCH
    _METRIC_EPOCH = int(epoch)
