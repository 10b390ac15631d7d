"""Server entry point: ``python -m routest_tpu_torch.serve``.

Serves the ETA, route-optimization, history, locations, live-tracking
(``/api/confirm_route``, ``/api/update_tracker``, SSE
``/api/realtime_feed``) and live-traffic (``/api/probe``, ``/api/live``)
endpoints on ``RTPU_HOST``:``PORT`` (default 127.0.0.1:5000), scoring
on the card through the fused kernel from the artifact at
``ETA_MODEL_PATH`` (default ``artifacts/eta_mlp.msgpack``) and solving
routes on the card. ``ROUTEST_DEVICE=cpu`` serves on the CPU (the
kernel's plain version). ``RTPU_LIVE=1`` arms live traffic on the road
router (``RTPU_LIVE_*`` knobs). ``RTPU_WIRE=1`` accepts RTW1 frames on
``/api/predict_eta_batch`` and ``/api/matrix`` and also serves them on a
multiplexed TCP channel (``serve/wirechannel.py``) at ``RTPU_WIRE_PORT``,
or ``PORT + RTPU_WIRE_PORT_OFFSET`` (a port already taken leaves the
HTTP path serving). ``ROUTEST_RELOAD_SEC`` > 0 hot-swaps a changed
artifact after the golden-batch gate. A missing artifact is trained
first, on the serving device, as the JAX entry point does: 200,000
synthetic rows, seed 0, 15 epochs, the default ``EtaMLP``
(``model_bootstrap_started`` / ``model_bootstrap_finished`` with the
eval RMSE), saved to that path and then served. SIGTERM/SIGINT
drain in-flight requests (open SSE streams are not waited for) before
exit. ``serve_listening`` and ``serve_stopped`` log the fused kernel's
launch count in this process (``fused_launches``): their difference is
the launches over the requests served.

The replica's observability spine is armed as in the JAX server: every
request is traced (``RTPU_OBS_*``: a caller's ``traceparent`` is
adopted, ``RTPU_OBS_DEVICE_TRACE_DIR`` attaches a ``torch.profiler``
Chrome trace to up to ``RTPU_OBS_DEVICE_TRACE_MAX`` sampled flushes),
the flight recorder writes bundles under ``RTPU_RECORDER_DIR`` (and on
SIGUSR2), the SLO engine, the timeline and the goodput watchdog tick on
their own threads, and ``RTPU_CHAOS_SPEC`` arms fault injection. An
artifact written by ``python -m routest_tpu_torch.train.export`` serves
its own program (kernel ``torch_export``).
"""

from __future__ import annotations

import os

from routest_tpu_torch.core.config import load_config
from routest_tpu_torch.ops.fused_mlp import fused_eta_forward
from routest_tpu_torch.serve.app import create_app
from routest_tpu_torch.serve.ml_service import EtaService
from routest_tpu_torch.serve.wsgi import run_with_graceful_shutdown
from routest_tpu_torch.train.checkpoint import default_model_path
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.serve.boot")


def ensure_model(path: str, device=None) -> None:
    """Train and save the bootstrap model when ``path`` holds nothing."""
    if os.path.exists(path):
        return
    _log.info("model_bootstrap_started", path=path,
              reason="no artifact; training a quick synthetic model")
    from routest_tpu_torch.core.config import TrainConfig
    from routest_tpu_torch.data import synthetic
    from routest_tpu_torch.models.eta_mlp import EtaMLP
    from routest_tpu_torch.train.checkpoint import save_model
    from routest_tpu_torch.train.loop import fit

    train, ev = synthetic.train_eval_split(
        synthetic.generate_dataset(200_000, seed=0))
    model = EtaMLP()
    result = fit(model, train, ev, TrainConfig(epochs=15), device=device)
    save_model(path, model)
    _log.info("model_bootstrap_finished", path=path,
              eval_rmse_min=round(result.eval_rmse, 2))


def main() -> None:
    config = load_config()
    path = default_model_path(config.model)
    ensure_model(path, device=config.serve.device)
    eta = EtaService(config.serve, model_path=path)
    _log.info("model_loaded", path=path, available=eta.available,
              scoring=eta.scoring_info(), error=eta.load_error)
    if config.serve.reload_sec > 0:
        # EtaService started the watcher itself (it owns the lifecycle).
        _log.info("hot_reload_watcher", interval_s=config.serve.reload_sec)
    app = create_app(config, eta_service=eta)
    wire_cfg = app.wire_config
    wire_server = None
    if wire_cfg.enabled and wire_cfg.channel and app.wire_handlers:
        from routest_tpu_torch.serve.wirechannel import WireChannelServer

        wire_port = wire_cfg.port or (config.serve.port
                                      + wire_cfg.port_offset)
        wire_server = WireChannelServer(
            app.wire_handlers, config.serve.host, wire_port,
            max_frame_bytes=int(wire_cfg.max_frame_mb * 1024 * 1024))
        try:
            wire_server.start()   # logs wire_channel_listening itself
        except OSError as e:
            # A port collision must not kill the server: the HTTP
            # negotiation path still serves wire frames.
            _log.warning("wire_channel_bind_failed", port=wire_port,
                         error=str(e))
            wire_server = None
    _log.info("serve_listening", host=config.serve.host,
              port=config.serve.port,
              fused_launches=fused_eta_forward.launches)
    run_with_graceful_shutdown(app, config.serve.host, config.serve.port)
    app.close()
    if wire_server is not None:
        wire_server.stop()
    _log.info("serve_stopped", fused_launches=fused_eta_forward.launches)


if __name__ == "__main__":
    main()
