"""Open-loop, trace-driven load generation (docs/LOADGEN.md).

The measurement half of the "millions of users" claim: seeded arrival
schedules (constant / Poisson / diurnal / flash-crowd), Zipf-skewed
workload models over the Manila extract, a fire-at-scheduled-time
client that records latency from *intended* send time (coordinated-
omission-correct, per MLPerf LoadGen's open-loop server scenario), and
structured reports with server-side registry deltas. Deterministic by
contract: the same seed reproduces the same schedule and the same
request sequence, so two benches can offer literally identical load.

Host Python and numpy only: the generator has no device code. Its
schedules, request sequences (RTW1 frames included) and reports are
bitwise those of the JAX package's ``loadgen`` for the same inputs.

Consumers: ``scripts/load_test_cuda.py --open-loop``,
``scripts/bench_autoscale_cuda.py``, ``scripts/bench_dispatch_cuda.py``
and ``chip_smoke.py``'s loadgen phase, each driving the port's servers.
"""

from routest_tpu_torch.loadgen.arrivals import (RateCurve, paced_schedule,
                                                poisson_schedule, with_burst)
from routest_tpu_torch.loadgen.engine import (KeepAliveClient, RequestRecord,
                                              SseClients, run_closed_loop,
                                              run_open_loop)
from routest_tpu_torch.loadgen.report import (cache_delta, fetch_metrics,
                                              registry_totals, summarize,
                                              timeline)
from routest_tpu_torch.loadgen.workload import (DEFAULT_MIX, MixedWorkload,
                                                PlannedRequest,
                                                ZipfODWorkload)

__all__ = [
    "RateCurve", "poisson_schedule", "paced_schedule", "with_burst",
    "PlannedRequest", "ZipfODWorkload", "MixedWorkload", "DEFAULT_MIX",
    "KeepAliveClient", "RequestRecord", "SseClients", "run_open_loop",
    "run_closed_loop",
    "summarize", "timeline", "fetch_metrics", "registry_totals",
    "cache_delta",
]
