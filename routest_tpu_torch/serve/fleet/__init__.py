"""Multi-replica serving fleet: supervisor + gateway.

The counterpart of ``routest_tpu/serve/fleet``. The single-process
server (``python -m routest_tpu_torch.serve``) tops out at one batcher
on one device. Production inference stacks put a
scheduling tier in front of per-replica batchers (Orca-style continuous
batching schedulers; tail-tolerant routing per "The Tail at Scale").
This package is that tier, process-level and stdlib-only:

- ``supervisor.ReplicaSupervisor`` — spawns N shared-nothing worker
  processes (each the full ``serve/wsgi.py`` stack on its own port),
  health-probes them, restarts crashes with capped exponential backoff,
  and drains gracefully on SIGTERM;
- ``gateway.Gateway`` — least-outstanding-requests routing, a
  consecutive-failure circuit breaker with half-open probing, one
  idempotent retry across replicas, optional p95-delay hedging, and a
  bounded admission queue that degrades overload into fast 429s;
- ``autoscaler.Autoscaler`` — the SLO-driven control loop over both:
  reads admission-queue depth, per-replica outstanding, and burn-rate
  signals, and scales the fleet within bounds with hysteresis and
  per-direction cooldowns (``RTPU_AUTOSCALE_*`` env knobs; new
  replicas join via the gateway's half-open probe path, removed ones
  drain first);
- ``rollout.RolloutController`` — safe change delivery over both: a
  canary → bake → promote state machine with verified replica
  replacement (drain, boot crash-loop watch, ``/api/health`` model
  gate, half-open join), SLO-engine canary-vs-baseline comparison over
  version-labeled request families, and automatic rollback that writes
  a flight-recorder bundle naming the offending version
  (``RTPU_ROLLOUT_*`` env knobs; ``GET/POST /api/rollout``);
- ``placement`` — device inventory → replica slices, each pinned by
  its env overlay (``CUDA_VISIBLE_DEVICES`` on a card);
- ``python -m routest_tpu_torch.serve.fleet`` — wires everything up from
  ``core.config.FleetConfig`` (``RTPU_FLEET_*`` env knobs;
  ``RTPU_AUTOSCALE=1`` arms the autoscaler).

Replicas share nothing in-process; cross-replica state (SSE fanout,
history) rides the broker/store backends the workers speak
(``REDIS_URL=tcp://…`` for ``serve/netbus.py``, ``SUPABASE_URL``).
"""

from routest_tpu_torch.serve.fleet.autoscaler import Autoscaler
from routest_tpu_torch.serve.fleet.gateway import Gateway
from routest_tpu_torch.serve.fleet.rollout import (RolloutController,
                                             rolling_restart)
from routest_tpu_torch.serve.fleet.supervisor import ReplicaSupervisor

__all__ = ["Autoscaler", "Gateway", "ReplicaSupervisor",
           "RolloutController", "rolling_restart"]
