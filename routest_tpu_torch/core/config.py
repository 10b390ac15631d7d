"""Typed, env-layered configuration for the serving path.

The fields the port reads, carried over from
``routest_tpu/core/config.py`` with the same environment variable names
and defaults (``ETA_MODEL_PATH``, ``PORT``, ``RTPU_*``, ``RTPU_LIVE_*``,
``RTPU_DISPATCH_*``, ``RTPU_WIRE*``, ``ROUTEST_RELOAD_SEC``,
``RTPU_SWAP_*``, ``SUPABASE_*``, ``REDIS_URL``, and the training knobs
``RTPU_TRAIN_BATCH``, ``RTPU_LR``, ``RTPU_EPOCHS``, ``RTPU_SEED``,
``RTPU_CKPT_DIR``), plus the port's own ``ROUTEST_DEVICE``.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Mapping, Optional, Tuple


def _env(env: Mapping[str, str], *names: str,
         default: Optional[str] = None) -> Optional[str]:
    for name in names:
        value = env.get(name)
        if value:
            return value
    return default


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # Path to the serving artifact. Honors the reference's
    # ETA_MODEL_PATH override (``Flaskr/ml.py:7``).
    model_path: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8192
    learning_rate: float = 3e-3
    weight_decay: float = 1e-4
    epochs: int = 30
    seed: int = 0
    # Periodic training checkpoints: set a directory to enable. ``fit``
    # resumes from the latest complete checkpoint found there.
    checkpoint_dir: Optional[str] = None
    checkpoint_every_epochs: int = 5
    # Preemptible runs: train at most this many epochs PER INVOCATION
    # while ``epochs`` still defines the full schedule (the learning-rate
    # decay spans ``epochs``, so a job trained in slices follows the
    # uninterrupted trajectory). None = train to ``epochs``.
    stop_after_epochs: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    host: str = "127.0.0.1"
    port: int = 5000
    # Scoring device: "cuda" (the default — the hand kernel serves) or
    # "cpu" (the kernel's plain PyTorch version; tests and CPU hosts).
    device: str = "cuda"
    # Dynamic batcher: requests coalesce until ``max_batch`` rows or
    # ``max_wait_ms`` elapse, whichever first.
    max_batch: int = 4096
    max_wait_ms: float = 2.0
    # Bucketed pad sizes (``RTPU_BATCH_BUCKETS``, comma-separated): every
    # device batch is padded up to one of these, and each is warmed at
    # startup.
    batch_buckets: Tuple[int, ...] = (8, 64, 512, 1024, 2048, 4096)
    # Serving fast lane: a content-addressed prediction cache +
    # singleflight in front of the batcher, and an adaptive flush window
    # inside it. Entries are keyed by (row bytes, model generation), so
    # the cache is semantically invisible and defaults ON.
    fastlane_cache: bool = True
    fastlane_cache_size: int = 8192
    fastlane_cache_ttl_s: float = 300.0
    fastlane_singleflight: bool = True
    fastlane_max_rows: int = 1024
    adaptive_wait: bool = True
    min_wait_ms: float = 0.0
    # Hot reload: poll the serving artifact's mtime every ``reload_sec``
    # seconds (0 = off) and swap a changed file in without a restart.
    reload_sec: float = 0.0
    # Verified hot-swap: a replacement scores the golden batch before the
    # serving generation flips; non-finite outputs, or a median absolute
    # divergence from the live model beyond ``swap_max_divergence`` ETA
    # minutes (0 = no bound; finiteness always holds), reject it.
    swap_verify: bool = True
    swap_max_divergence: float = 240.0
    # Health version stamp (RENDER_GIT_COMMIT / GIT_COMMIT_SHA).
    version: Optional[str] = None
    # History backend (SUPABASE_URL / SUPABASE_SERVICE_ROLE_KEY); unset
    # = the in-memory store.
    supabase_url: Optional[str] = None
    supabase_service_key: Optional[str] = None
    # SSE bus backend (REDIS_URL); unset = the in-memory bus, the only
    # one the port has.
    redis_url: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class LiveConfig:
    """Live traffic (``routest_tpu_torch/live``): probe-stream ingest,
    incremental congestion state, periodic metric refresh of the road
    router. All knobs are ``RTPU_LIVE_*`` env vars, with the JAX
    package's names and defaults; disabled by default.

    ``customize_s`` bounds served-route staleness from above: a probe
    observation is reflected in routes/ETAs within one ingest hop plus
    one customize interval. ``half_life_s``/``stale_s``/``conf_obs``
    shape the estimator (EWMA decay, staleness window, observations to
    full confidence). ``route_metric=False`` prices legs live but keeps
    route CHOICE on the distance metric. ``retrain_s > 0`` runs the
    continuous GNN trainer (``live/trainer.py``) inside the server
    every ``retrain_s`` seconds: ``retrain_steps`` AdamW steps per cycle
    once the observation window holds ``retrain_min_obs`` probes."""

    enabled: bool = False
    channel: str = "rtpu.probes"
    customize_s: float = 10.0
    half_life_s: float = 60.0
    stale_s: float = 300.0
    conf_obs: float = 3.0
    min_obs_edges: int = 1
    window: int = 65536
    route_metric: bool = True
    retrain_s: float = 0.0
    retrain_steps: int = 40
    retrain_min_obs: int = 256


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """Dispatch (``routest_tpu_torch/dispatch``): batched VRP serving
    over ``POST /api/dispatch`` with live re-optimization. All knobs are
    ``RTPU_DISPATCH_*`` env vars, with the JAX package's names and
    defaults; enabled by default.

    ``max_rows`` bounds one merged batcher drain; ``window_s`` adds a
    fixed pre-drain wait (0 = natural batching only); ``max_stops``
    bounds stops per problem. ``reopt``/``reopt_poll_s``/
    ``degrade_ratio`` drive the re-optimization loop: every
    ``reopt_poll_s`` it reads the live metric epoch, and on a flip
    re-solves exactly the active dispatches whose corridor cost degraded
    past ``degrade_ratio`` × baseline (``reopt_poll_s`` 0: no thread,
    ticks by hand). ``max_active`` bounds the registry (oldest evicted
    first); ``speed_mps > 0`` overrides the vehicle-profile speed when
    pricing geographic corridors into travel seconds."""

    enabled: bool = True
    max_rows: int = 64
    window_s: float = 0.0
    max_stops: int = 32
    reopt: bool = True
    reopt_poll_s: float = 1.0
    degrade_ratio: float = 1.2
    max_active: int = 256
    speed_mps: float = 0.0


@dataclasses.dataclass(frozen=True)
class WireConfig:
    """Binary wire serving path (``serve/wirecodec.py`` +
    ``serve/wirechannel.py``): the length-prefixed columnar format
    negotiated by content-type on ``/api/predict_eta_batch`` and
    ``/api/matrix``, and the persistent multiplexed channel that carries
    it without a per-request HTTP exchange. All knobs are ``RTPU_WIRE*``
    env vars, with the JAX package's names and defaults; **off by
    default** — when disabled the app answers the wire content-type with
    415 and no channel socket exists.

    The channel listens on ``port`` when set, else on ``PORT +
    port_offset``. ``max_frame_mb`` bounds a single frame in both
    directions, checked before any per-row work."""

    enabled: bool = False
    channel: bool = True           # persistent mux channel (vs HTTP only)
    port: int = 0                  # explicit channel port (0 = derive)
    port_offset: int = 1000        # derived channel port = PORT + offset
    max_frame_mb: float = 64.0


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    serve: ServeConfig = ServeConfig()
    live: LiveConfig = LiveConfig()
    dispatch: DispatchConfig = DispatchConfig()


def resolve_device(device=None, who: str = "routest_tpu_torch"):
    """``device`` (None → ``load_config().serve.device``, ``cuda`` by
    default) as a ``torch.device``. Asking for the card where there is
    none raises: nothing moves to the CPU unless the caller says so."""
    import torch

    dev = torch.device(device if device is not None
                       else load_config().serve.device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{who}: unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: CUDA is not available and no CPU was asked for "
            f"(pass device='cpu' or set ROUTEST_DEVICE=cpu)")
    return dev


def load_config(env: Optional[Mapping[str, str]] = None) -> Config:
    """Build a Config from environment variables (same names and
    defaults as the JAX package's ``load_config`` serve, model and train
    parts)."""
    env = dict(env if env is not None else os.environ)

    def _int(name: str, default: int) -> int:
        raw = env.get(name)
        return int(raw) if raw else default

    def _float(name: str, default: float) -> float:
        raw = env.get(name)
        return float(raw) if raw else default

    def _float_tolerant(name: str, default: float) -> float:
        # Ops knob: a malformed value must not abort server boot — fall
        # back to the default (= feature off for reload_sec) instead.
        raw = env.get(name)
        if not raw:
            return default
        try:
            return float(raw)
        except ValueError:
            warnings.warn(f"{name}={raw!r} is not a number; using {default}")
            return default

    def _buckets(name: str, default: Tuple[int, ...]) -> Tuple[int, ...]:
        # Ops knob: malformed entries keep the default (boot must not
        # abort on a typo).
        raw = env.get(name)
        if not raw:
            return default
        try:
            vals = tuple(sorted({int(v) for v in raw.split(",") if v.strip()}))
            return vals if vals and all(v > 0 for v in vals) else default
        except ValueError:
            warnings.warn(f"{name}={raw!r} is not a bucket list; "
                          f"using {default}")
            return default

    model = ModelConfig(
        model_path=_env(env, "ETA_MODEL_PATH", "RTPU_MODEL_PATH"),
    )
    train = TrainConfig(
        batch_size=_int("RTPU_TRAIN_BATCH", 8192),
        learning_rate=_float("RTPU_LR", 3e-3),
        epochs=_int("RTPU_EPOCHS", 30),
        seed=_int("RTPU_SEED", 0),
        checkpoint_dir=env.get("RTPU_CKPT_DIR"),
    )
    serve = ServeConfig(
        host=env.get("RTPU_HOST", "127.0.0.1"),
        port=_int("PORT", _int("RTPU_PORT", 5000)),
        device=env.get("ROUTEST_DEVICE") or "cuda",
        max_batch=_int("RTPU_MAX_BATCH", 4096),
        max_wait_ms=_float("RTPU_MAX_WAIT_MS", 2.0),
        batch_buckets=_buckets("RTPU_BATCH_BUCKETS",
                               ServeConfig.batch_buckets),
        fastlane_cache=env.get("RTPU_FASTLANE_CACHE", "1") != "0",
        fastlane_cache_size=_int("RTPU_FASTLANE_CACHE_SIZE", 8192),
        fastlane_cache_ttl_s=_float("RTPU_FASTLANE_CACHE_TTL_S", 300.0),
        fastlane_singleflight=env.get(
            "RTPU_FASTLANE_SINGLEFLIGHT", "1") != "0",
        fastlane_max_rows=_int("RTPU_FASTLANE_MAX_ROWS", 1024),
        adaptive_wait=env.get("RTPU_FASTLANE_ADAPTIVE", "1") != "0",
        min_wait_ms=_float("RTPU_FASTLANE_MIN_WAIT_MS", 0.0),
        reload_sec=_float_tolerant("ROUTEST_RELOAD_SEC", 0.0),
        swap_verify=env.get("RTPU_SWAP_VERIFY", "1") != "0",
        swap_max_divergence=_float_tolerant("RTPU_SWAP_MAX_DIV", 240.0),
        version=_env(env, "RENDER_GIT_COMMIT", "GIT_COMMIT_SHA"),
        supabase_url=env.get("SUPABASE_URL"),
        supabase_service_key=env.get("SUPABASE_SERVICE_ROLE_KEY"),
        redis_url=env.get("REDIS_URL"),
    )
    return Config(model=model, train=train, serve=serve,
                  live=load_live_config(env),
                  dispatch=load_dispatch_config(env))


def _env_num(env: Mapping[str, str], name: str, default, cast):
    """Ops-knob number parse: a malformed value keeps the default (a
    typo in an env var must never abort server boot)."""
    raw = env.get(name)
    if not raw:
        return default
    try:
        return cast(raw)
    except ValueError:
        return default


def load_live_config(env: Optional[Mapping[str, str]] = None) -> LiveConfig:
    """Just the live-traffic knobs (``RTPU_LIVE=1`` turns it on)."""
    env = dict(env if env is not None else os.environ)
    return LiveConfig(
        enabled=env.get("RTPU_LIVE", "0") == "1",
        channel=env.get("RTPU_LIVE_CHANNEL") or "rtpu.probes",
        customize_s=_env_num(env, "RTPU_LIVE_CUSTOMIZE_S", 10.0, float),
        half_life_s=_env_num(env, "RTPU_LIVE_HALF_LIFE_S", 60.0, float),
        stale_s=_env_num(env, "RTPU_LIVE_STALE_S", 300.0, float),
        conf_obs=_env_num(env, "RTPU_LIVE_CONF_OBS", 3.0, float),
        min_obs_edges=_env_num(env, "RTPU_LIVE_MIN_OBS_EDGES", 1, int),
        window=_env_num(env, "RTPU_LIVE_WINDOW", 65536, int),
        route_metric=env.get("RTPU_LIVE_ROUTE_METRIC", "1") != "0",
        retrain_s=_env_num(env, "RTPU_LIVE_RETRAIN_S", 0.0, float),
        retrain_steps=_env_num(env, "RTPU_LIVE_RETRAIN_STEPS", 40, int),
        retrain_min_obs=_env_num(env, "RTPU_LIVE_RETRAIN_MIN_OBS",
                                 256, int),
    )


def load_wire_config(env: Optional[Mapping[str, str]] = None) -> WireConfig:
    """Just the binary-wire knobs (``RTPU_WIRE=1`` turns the path on)."""
    env = dict(env if env is not None else os.environ)
    return WireConfig(
        enabled=env.get("RTPU_WIRE", "0") == "1",
        channel=env.get("RTPU_WIRE_CHANNEL", "1") != "0",
        port=_env_num(env, "RTPU_WIRE_PORT", 0, int),
        port_offset=_env_num(env, "RTPU_WIRE_PORT_OFFSET", 1000, int),
        max_frame_mb=_env_num(env, "RTPU_WIRE_MAX_FRAME_MB", 64.0, float),
    )


def load_dispatch_config(
        env: Optional[Mapping[str, str]] = None) -> DispatchConfig:
    """Just the dispatch knobs (``RTPU_DISPATCH=0`` turns it off)."""
    env = dict(env if env is not None else os.environ)
    return DispatchConfig(
        enabled=env.get("RTPU_DISPATCH", "1") != "0",
        max_rows=_env_num(env, "RTPU_DISPATCH_MAX_ROWS", 64, int),
        window_s=_env_num(env, "RTPU_DISPATCH_WINDOW_S", 0.0, float),
        max_stops=_env_num(env, "RTPU_DISPATCH_MAX_STOPS", 32, int),
        reopt=env.get("RTPU_DISPATCH_REOPT", "1") != "0",
        reopt_poll_s=_env_num(env, "RTPU_DISPATCH_REOPT_POLL_S",
                              1.0, float),
        degrade_ratio=_env_num(env, "RTPU_DISPATCH_DEGRADE_RATIO",
                               1.2, float),
        max_active=_env_num(env, "RTPU_DISPATCH_MAX_ACTIVE", 256, int),
        speed_mps=_env_num(env, "RTPU_DISPATCH_SPEED_MPS", 0.0, float),
    )
