"""Fleet entry point: ``python -m routest_tpu_torch.serve.fleet``.

The counterpart of ``python -m routest_tpu.serve.fleet``. Plans the
placement (``serve/fleet/placement.py``: on one card, ``auto`` plans
one replica; more come from growth onto the same card), then boots one
worker process per slice (each the full ``python -m
routest_tpu_torch.serve`` stack on ``base_port + i``, pinned by the
slice's overlay) under the supervisor, and serves the gateway on
``RTPU_GATEWAY_PORT``. With more than one replica, or live traffic on,
and no ``REDIS_URL`` configured, a TCP broker (``serve/netbus.py``) is
started so SSE events cross replicas. A fleet booted with one replica
and grown later has no broker unless ``REDIS_URL`` names one, as in the
reference. The rollout controller is always attached;
``RTPU_AUTOSCALE=1`` arms the autoscaler. SIGTERM/SIGINT drain
gracefully: the gateway stops admitting and finishes inflight requests,
then the workers get SIGTERM; SIGUSR2 writes a postmortem bundle.
Lifecycle status is structured ``JsonLogger`` events (one JSON object
per line on stderr). The fleet process itself creates no CUDA context:
planning only counts the devices.
"""

from __future__ import annotations

import os
import signal
import sys
import threading

from routest_tpu_torch.core.config import load_config
from routest_tpu_torch.serve.fleet.gateway import Gateway
from routest_tpu_torch.serve.fleet.supervisor import ReplicaSupervisor
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.fleet.boot")


def main() -> None:
    config = load_config()
    fleet = config.fleet
    env = dict(os.environ)

    # Topology-aware placement: enumerate the host's devices and carve
    # them into replica slices BEFORE anything spawns — each slice's
    # env overlay pins its devices, and its capacity units feed the
    # gateway's weighted router + the autoscaler's pressure signals.
    # On the CPU (ROUTEST_DEVICE=cpu) "auto" gives RTPU_FLEET_REPLICAS
    # plain 1-chip replicas; RTPU_FLEET_PLACEMENT forces a layout.
    from routest_tpu_torch.serve.fleet.placement import plan_from_env

    plan = plan_from_env(env, replicas=max(1, fleet.replicas))
    n = len(plan.slices)
    ports = [fleet.base_port + i for i in range(n)]
    from routest_tpu_torch.obs.ledger import get_change_ledger, record_change

    record_change("placement.apply",
                  detail={"platform": plan.platform,
                          "chips": plan.total_chips,
                          "layout": plan.layout, "source": plan.source,
                          "slices": [s.label for s in plan.slices]})
    _log.info("placement_plan", platform=plan.platform,
              chips=plan.total_chips, layout=plan.layout,
              source=plan.source,
              capacity_units=round(plan.capacity_units, 2),
              slices=[s.label for s in plan.slices])
    broker = None
    # A broker is needed whenever events must cross process boundaries:
    # SSE across >1 replica, and — live traffic — the probe stream,
    # which external probe sources publish INTO the fleet even when a
    # single replica serves it.
    if (n > 1 or config.live.enabled) and not env.get("REDIS_URL"):
        from routest_tpu_torch.serve.netbus import start_broker

        broker, _ = start_broker()
        env["REDIS_URL"] = f"tcp://127.0.0.1:{broker.port}"
        _log.info("sse_broker_started", url=env["REDIS_URL"],
                  live_traffic=config.live.enabled)

    # Version label for the boot fleet (rollouts replace it per-replica;
    # RTPU_VERSION names what THIS deploy is serving).
    version = env.get("RTPU_VERSION") or None
    # Arm the fleet process's change ledger: version context for the
    # rollout/autoscale events recorded in THIS process, plus bus
    # publication so gateway-tier changes travel beside the replicas'.
    ledger = get_change_ledger()
    if ledger.enabled:
        ledger.set_context(version=version)
        if env.get("REDIS_URL"):
            from routest_tpu_torch.serve.bus import make_bus

            ledger.attach_bus(make_bus(env["REDIS_URL"]))
    supervisor = ReplicaSupervisor(
        ports, env=env,
        probe_interval_s=fleet.probe_interval_s,
        unhealthy_after=fleet.unhealthy_after,
        backoff_base_s=fleet.backoff_base_s,
        backoff_cap_s=fleet.backoff_cap_s,
        quiet=False, version=version, placement=plan)
    supervisor.start()
    _log.info("supervising", replicas=n, ports=ports,
              layout=plan.layout)
    if not supervisor.ready(timeout=300):
        _log.error("replicas_never_ready", ports=ports)
        supervisor.drain(timeout=10)
        sys.exit(2)

    gateway = Gateway([("127.0.0.1", p) for p in ports], fleet,
                      supervisor=supervisor, version=version)
    # Stamp each boot replica's slice on its upstream entry: weighted
    # routing and the capacity gauge reflect the plan from request one.
    for i, s in enumerate(plan.slices):
        gateway.set_topology(f"r{i}", chips=s.chips, capacity=s.capacity)
    gateway.serve(fleet.gateway_host, fleet.gateway_port)
    _log.info("gateway_up",
              url=f"http://{fleet.gateway_host}:{fleet.gateway_port}",
              replicas=[f"127.0.0.1:{p}" for p in ports])

    # Change-delivery surface: always attached (idle until a rollout is
    # started via POST /api/rollout or an embedding harness).
    from routest_tpu_torch.serve.fleet.rollout import RolloutController

    rollout = RolloutController(supervisor, gateway, config.rollout)
    _log.info("rollout_controller_attached",
              canary_fraction=config.rollout.canary_fraction,
              bake_s=config.rollout.bake_s)

    autoscaler = None
    if config.autoscale.enabled:
        from routest_tpu_torch.serve.fleet.autoscaler import Autoscaler

        autoscaler = Autoscaler(supervisor, gateway, config.autoscale)
        autoscaler.start()
        _log.info("autoscaler_started",
                  min=config.autoscale.min_replicas,
                  max=config.autoscale.max_replicas,
                  tick_s=config.autoscale.tick_s)

    stop = threading.Event()

    def _term(*_):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    from routest_tpu_torch.obs.recorder import install_sigusr2_trigger

    install_sigusr2_trigger()  # SIGUSR2 → gateway postmortem bundle
    stop.wait()
    _log.info("draining")
    if rollout.active():
        rollout.abort("fleet_shutdown")
        rollout.wait(timeout=60)
    if autoscaler is not None:
        autoscaler.stop()
    gateway.drain(timeout=30)
    supervisor.drain(timeout=30)
    if broker is not None:
        broker.shutdown()
    _log.info("fleet_stopped")


if __name__ == "__main__":
    main()
