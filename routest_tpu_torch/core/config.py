"""Typed, env-layered configuration for the serving path.

The fields the port reads, carried over from
``routest_tpu/core/config.py`` with the same environment variable names
and defaults (``ETA_MODEL_PATH``, ``PORT``, ``RTPU_*``, ``RTPU_LIVE_*``,
``RTPU_DISPATCH_*``, ``RTPU_WIRE*``, ``ROUTEST_RELOAD_SEC``,
``RTPU_SWAP_*``, ``SUPABASE_*``, ``REDIS_URL``, and the training knobs
``RTPU_TRAIN_BATCH``, ``RTPU_LR``, ``RTPU_EPOCHS``, ``RTPU_SEED``,
``RTPU_CKPT_DIR``, and the observability knobs ``RTPU_OBS_*``,
``RTPU_TAIL_SAMPLE*``, ``RTPU_TIMELINE*``, ``RTPU_PROFILE*``,
``RTPU_PROBER_*``, ``RTPU_EFF*``, ``RTPU_LEDGER*``, ``RTPU_SLO*``,
``RTPU_RECORDER*``, ``RTPU_CHAOS*``), plus the port's own
``ROUTEST_DEVICE``. One default differs: ``RTPU_EFF_KERNEL_ARTIFACT``
falls back to the port's ``artifacts/serving_kernel_cuda.json``.
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
class ObsConfig:
    """Observability spine (``routest_tpu_torch/obs``): request tracing +
    unified metrics registry. All knobs are ``RTPU_OBS_*`` env vars.

    ``sample_rate`` is the head-based trace sampling probability decided
    at the first hop (gateway or replica edge) and propagated via the
    W3C ``traceparent`` flags, so a trace records everywhere or nowhere.
    ``trace_export_path`` appends every finished sampled span as one
    JSON line (the bounded in-memory buffer behind ``/api/trace`` is a
    flight recorder, not storage). ``device_trace_dir`` attaches a
    ``torch.profiler`` CUDA capture (a Chrome trace) to at most
    ``device_trace_max`` sampled batcher flushes per process."""

    enabled: bool = True
    sample_rate: float = 1.0
    buffer_spans: int = 2048
    trace_export_path: Optional[str] = None
    device_trace_dir: Optional[str] = None
    device_trace_max: int = 1
    # Tail-based retention (``RTPU_TAIL_SAMPLE_*``): buffer every
    # request's spans briefly and decide KEEP at root completion —
    # slow (over the route's SLO latency threshold, or ``tail_slow_ms``
    # when set), errored, or reservoir-sampled. Off by default: head
    # sampling (above) stays the measured-baseline posture.
    tail: bool = False
    # 0 = derive per-route thresholds from the SLO objective spec
    # (``RTPU_SLO_OBJECTIVES`` / built-in defaults); > 0 = one flat
    # slow threshold for every route.
    tail_slow_ms: float = 0.0
    # Probability a normal (fast, ok) trace is kept anyway — the
    # baseline sample that keeps /api/trace representative, not only
    # pathological.
    tail_reservoir: float = 0.02
    tail_max_pending: int = 256
    tail_ttl_s: float = 60.0


@dataclasses.dataclass(frozen=True)
class TimelineConfig:
    """In-process metric timeline (``routest_tpu_torch/obs/timeline.py``):
    the registry ticked into bounded multi-resolution rings — counters
    as per-window deltas, gauges as last value, histograms as
    per-window bucket deltas (→ windowed percentile estimates) — behind
    ``GET /api/timeline`` on both tiers, with the gateway additionally
    scraping each replica's timeline into per-replica / per-version /
    fleet-rollup views. All knobs are ``RTPU_TIMELINE_*`` env vars.

    ``resolutions`` is a ``"<step_s>x<slots>,…"`` spec, finest first —
    the default keeps 1 h at 10 s and 6 h at 60 s. The anomaly
    ``watch``er compares each fresh finest-resolution window against
    the trailing baseline (latency shift, error-rate step, throughput
    collapse, cache-hit-rate collapse) and fires a flight-recorder
    bundle — which embeds the timeline slice, so a postmortem answers
    *when did it start*."""

    enabled: bool = True
    resolutions: Tuple[Tuple[float, int], ...] = ((10.0, 360), (60.0, 360))
    watch: bool = True
    # The watcher needs this many trailing finest frames of baseline
    # before it judges anything (a cold process must not page on its
    # first window), and re-fires per (kind, family) at most every
    # ``watch_cooldown_s``.
    watch_baseline_frames: int = 3
    watch_cooldown_s: float = 120.0
    # Latency shift: newest-window p95 ≥ factor × baseline p95 AND the
    # shift exceeds the floor (a 2 ms → 5 ms move is not an incident).
    watch_latency_factor: float = 2.0
    watch_latency_floor_ms: float = 50.0
    # Error-rate step: newest-window error fraction ≥ baseline + step.
    watch_error_step: float = 0.05
    # Throughput collapse: newest rate ≤ frac × baseline rate while the
    # baseline was actually serving (≥ min_rate events/s).
    watch_throughput_frac: float = 0.3
    watch_min_rate: float = 1.0
    # Minimum events in the newest window before any verdict (tiny
    # windows are all noise).
    watch_min_count: int = 5
    # The slice every postmortem bundle embeds (finest resolution).
    bundle_window_s: float = 900.0


@dataclasses.dataclass(frozen=True)
class ProfileConfig:
    """Triggered on-path profiling (``routest_tpu_torch/obs/profiler.py``):
    a bounded Python stack-sample capture (plus an optional
    ``torch.profiler`` CUDA trace) armed by the SLO warn/page edge or
    ``POST /api/debug/profile``, written as a flight-recorder bundle.
    All knobs are ``RTPU_PROFILE_*`` env vars. The per-process budget
    (``max_captures``) and ``min_interval_s`` spacing bound the cost:
    profiling is evidence collection, never a steady-state tax."""

    enabled: bool = True
    duration_s: float = 2.0
    interval_ms: float = 10.0
    max_captures: int = 4
    min_interval_s: float = 60.0
    # Also capture a torch.profiler CUDA trace for the window (written
    # into the bundle as a Chrome trace; device captures are
    # heavyweight, so this is opt-in even when armed).
    device_trace: bool = False


@dataclasses.dataclass(frozen=True)
class ProberConfig:
    """In-fleet blackbox prober (``routest_tpu_torch/obs/prober.py``): low-rate
    synthetic requests through the real gateway→replica path — the
    golden ETA batch against pinned expected bands, pinned route/matrix
    probes against a scipy oracle re-derived per metric epoch, and a
    fan-out consistency probe comparing every replica's answer, model
    identity, and metric epoch directly. All knobs are ``RTPU_PROBER_*``
    env vars; disabled by default (armed with ``RTPU_PROBER=1`` on the
    gateway tier).

    ``eta_tolerance`` is the golden-probe divergence bound in output
    minutes; 0 derives it from the swap gate's own margin
    (``RTPU_SWAP_MAX_DIV``), so a model the verified-swap gate would
    accept never trips the prober, and one past the gate's tolerance
    always does. ``skew_after`` consecutive fan-out mismatches are
    required before a skew verdict — a metric flip or verified swap
    propagating across replicas is a transient, not an incident —
    and ``epoch_gap`` is the stale-epoch distance (fleet max − replica)
    that counts as a mismatch at all (staggered customize timers sit
    at gap ≤ 1 forever in a healthy fleet)."""

    enabled: bool = False
    interval_s: float = 5.0
    timeout_s: float = 10.0
    eta_tolerance: float = 0.0     # minutes; 0 = the swap-gate margin
    route_tolerance_rel: float = 2e-3
    routes: str = ""               # "lat,lon|lat,lon;…" pinned OD pairs
    skew_after: int = 3
    epoch_gap: int = 2
    # Fan-out reachability as a skew dimension (``RTPU_PROBER_REACH``):
    # a target that answers nothing becomes a named offender, debounced
    # like epoch/model skew. Off by default at replica scope (a dead
    # replica is the supervisor's incident, not a correctness page);
    # the cross-region prober arms it so a DEAD REGION is paged by
    # name.
    fanout_reach: bool = False
    backoff_cap_s: float = 60.0
    failures_kept: int = 16
    subgraph_max_edges: int = 100_000
    # The correctness SLO over probe verdicts: target fraction of
    # passing probes, evaluated by a dedicated burn-rate engine with
    # probe-scale windows (probes run at ~0.2/s, not ~100/s).
    slo_target: float = 0.99
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0


@dataclasses.dataclass(frozen=True)
class EfficiencyConfig:
    """Device goodput ledger + throughput-regression watchdog
    (``routest_tpu_torch/obs/efficiency.py``). All knobs are ``RTPU_EFF_*``
    env vars. The ledger (``enabled``) is always-on accounting — every
    device-program call site records real vs padded rows and the
    queue/compute wall split. The watchdog pins the measured per-bucket
    throughput curve from the port's kernel record (``kernel_artifact``,
    backend-matched; ``chips_artifact`` is the fleet placement curve,
    read once placement is ported) and pages when
    live goodput falls under ``min_ratio`` × pinned, or when windowed
    padding waste exceeds ``max_waste`` — each debounced over ``after``
    consecutive bad ticks, the prober's skew-verdict convention.

    ``min_rows`` is the evidence floor: a (program, bucket) window with
    fewer rows than this is not judged at all, so an idle replica can
    never page on noise. ``slo_target``/``fast_window_s``/
    ``slow_window_s`` shape the dedicated ``efficiency`` burn-rate
    engine over watchdog verdicts (watchdog-scale windows, mirroring
    the prober's)."""

    enabled: bool = True
    watchdog: bool = True
    min_ratio: float = 0.25
    max_waste: float = 0.7
    after: int = 3
    tick_s: float = 5.0
    window_s: float = 60.0
    min_rows: int = 256
    # The port reads its own ``_cuda`` records (the JAX package's
    # default is ``artifacts/serving_kernel.json``).
    kernel_artifact: str = "artifacts/serving_kernel_cuda.json"
    chips_artifact: str = "artifacts/fleet_chips.json"
    slo_target: float = 0.99
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0


@dataclasses.dataclass(frozen=True)
class LedgerConfig:
    """Change ledger + incident correlation
    (``routest_tpu_torch/obs/ledger.py``). All knobs are ``RTPU_LEDGER_*``
    env vars. The ledger (``enabled``) is an always-on bounded ring of
    state-change events (model swaps, metric flips, rollout phases,
    autoscale actions, chaos, region transitions); ``capacity`` bounds
    it. ``window_s`` is the incident window the suspect ranker scores
    over when a page fires and ``max_suspects`` caps the ranking
    written into each bundle's ``suspects.json``. ``publish`` fans
    locally-recorded events out on ``channel`` when a bus is attached
    (the cross-process / cross-region "one timeline" path);
    ``incidents_kept`` bounds the recorder's rolling incident list
    behind ``/api/incidents``. ``region`` is stamped onto local
    events (defaults to this process's ``RTPU_REGION``)."""

    enabled: bool = True
    capacity: int = 512
    window_s: float = 900.0
    max_suspects: int = 5
    publish: bool = True
    channel: str = "rtpu.changes"
    incidents_kept: int = 64
    region: str = ""


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """SLO engine (``routest_tpu_torch/obs/slo.py``): per-route objectives
    evaluated over rolling multi-window burn rates (Google SRE workbook
    §5, "multiwindow, multi-burn-rate alerts"). All knobs are
    ``RTPU_SLO_*`` env vars.

    ``objectives`` is a spec string; empty means the built-in defaults
    (``/api/optimize_route``, ``/api/predict_eta``, and — on the replica
    — the store dependency). Grammar::

        spec ::= obj (";" obj)*
        obj  ::= route [":" key "=" val ("," key "=" val)*]
        keys: availability (target fraction, default 0.999),
              latency_ms (threshold; omitted = no latency objective),
              latency_target (fraction under threshold, default 0.99)

    ``page_burn``/``warn_burn`` are the burn-rate thresholds that must
    hold on BOTH windows for the alert edge (14.4 ≈ exhausting a 30-day
    budget in 2 days, the workbook's fast-page default)."""

    enabled: bool = True
    tick_s: float = 1.0
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    page_burn: float = 14.4
    warn_burn: float = 6.0
    objectives: str = ""


@dataclasses.dataclass(frozen=True)
class RecorderConfig:
    """Flight recorder (``routest_tpu_torch/obs/recorder.py``): an always-on
    bounded ring of completed-request records + correlated log lines
    that dumps a self-contained postmortem bundle on trigger. All knobs
    are ``RTPU_RECORDER_*`` env vars; disk usage is bounded by
    ``max_bundles``/``max_total_mb`` (oldest bundles pruned) and
    ``min_interval_s`` rate-limits automatic triggers so a crash loop
    cannot fill the disk."""

    enabled: bool = True
    capacity: int = 512
    log_capacity: int = 512
    dir: str = "artifacts/postmortems"
    max_bundles: int = 16
    max_total_mb: float = 64.0
    min_interval_s: float = 30.0
    # Automatic trigger thresholds: a 5xx burst (``burst_5xx`` server
    # errors inside ``burst_window_s``) or a deadline-expiry spike
    # (``deadline_spike`` 504s inside the same window).
    burst_5xx: int = 5
    burst_window_s: float = 10.0
    deadline_spike: int = 20
    # An SLO page edge fires at the FIRST evidence of an incident —
    # often while the offending requests are still in flight. The
    # follow-up bundle, this many seconds later, captures what the
    # incident's opening seconds actually served. 0 disables.
    followup_s: float = 5.0


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Fault injection (``routest_tpu_torch/chaos``): a seeded, deterministic
    chaos layer wrapping every IO boundary. Disabled unless
    ``RTPU_CHAOS_SPEC`` names at least one fault point (and not
    force-disabled with ``RTPU_CHAOS=0``). ``seed`` makes the failure
    sequence replayable — same (spec, seed) → same faults, in order."""

    enabled: bool = False
    seed: int = 0
    spec: str = ""


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    serve: ServeConfig = ServeConfig()
    live: LiveConfig = LiveConfig()
    dispatch: DispatchConfig = DispatchConfig()
    obs: ObsConfig = ObsConfig()
    chaos: ChaosConfig = ChaosConfig()
    slo: SloConfig = SloConfig()
    recorder: RecorderConfig = RecorderConfig()
    timeline: TimelineConfig = TimelineConfig()
    profile: ProfileConfig = ProfileConfig()


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
                  dispatch=load_dispatch_config(env),
                  obs=load_obs_config(env),
                  chaos=load_chaos_config(env),
                  slo=load_slo_config(env),
                  recorder=load_recorder_config(env),
                  timeline=load_timeline_config(env),
                  profile=load_profile_config(env))


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


def load_chaos_config(env: Optional[Mapping[str, str]] = None) -> ChaosConfig:
    """Just the chaos knobs (read lazily by ``routest_tpu_torch.chaos`` at
    first ``inject`` without paying for a full Config build). A
    malformed seed disables injection rather than aborting boot — chaos
    must never be the thing that takes the server down at startup."""
    env = dict(env if env is not None else os.environ)
    spec = env.get("RTPU_CHAOS_SPEC", "")
    try:
        seed = int(env.get("RTPU_CHAOS_SEED") or 0)
    except ValueError:
        return ChaosConfig(enabled=False, seed=0, spec=spec)
    enabled = bool(spec.strip()) and env.get("RTPU_CHAOS", "1") != "0"
    return ChaosConfig(enabled=enabled, seed=seed, spec=spec)


def load_slo_config(env: Optional[Mapping[str, str]] = None) -> SloConfig:
    """Just the SLO knobs (read lazily by ``routest_tpu_torch/obs/slo.py``
    without paying for a full Config build)."""
    env = dict(env if env is not None else os.environ)
    return SloConfig(
        enabled=env.get("RTPU_SLO", "1") != "0",
        tick_s=_env_num(env, "RTPU_SLO_TICK_S", 1.0, float),
        fast_window_s=_env_num(env, "RTPU_SLO_FAST_S", 300.0, float),
        slow_window_s=_env_num(env, "RTPU_SLO_SLOW_S", 3600.0, float),
        page_burn=_env_num(env, "RTPU_SLO_PAGE_BURN", 14.4, float),
        warn_burn=_env_num(env, "RTPU_SLO_WARN_BURN", 6.0, float),
        objectives=env.get("RTPU_SLO_OBJECTIVES", ""),
    )


def load_prober_config(
        env: Optional[Mapping[str, str]] = None) -> ProberConfig:
    """Just the blackbox-prober knobs (read lazily by the gateway's
    serve() and ``routest_tpu_torch/obs/prober.py``)."""
    env = dict(env if env is not None else os.environ)
    return ProberConfig(
        enabled=env.get("RTPU_PROBER", "0") == "1",
        interval_s=_env_num(env, "RTPU_PROBER_INTERVAL_S", 5.0, float),
        timeout_s=_env_num(env, "RTPU_PROBER_TIMEOUT_S", 10.0, float),
        eta_tolerance=_env_num(env, "RTPU_PROBER_ETA_TOL_MIN", 0.0, float),
        route_tolerance_rel=_env_num(env, "RTPU_PROBER_ROUTE_TOL_REL",
                                     2e-3, float),
        routes=env.get("RTPU_PROBER_ROUTES", ""),
        skew_after=_env_num(env, "RTPU_PROBER_SKEW_AFTER", 3, int),
        epoch_gap=_env_num(env, "RTPU_PROBER_EPOCH_GAP", 2, int),
        fanout_reach=env.get("RTPU_PROBER_REACH", "0") == "1",
        backoff_cap_s=_env_num(env, "RTPU_PROBER_BACKOFF_CAP_S",
                               60.0, float),
        failures_kept=_env_num(env, "RTPU_PROBER_FAILURES_KEPT", 16, int),
        subgraph_max_edges=_env_num(env, "RTPU_PROBER_SUBGRAPH_MAX_EDGES",
                                    100_000, int),
        slo_target=_env_num(env, "RTPU_PROBER_SLO_TARGET", 0.99, float),
        fast_window_s=_env_num(env, "RTPU_PROBER_FAST_S", 60.0, float),
        slow_window_s=_env_num(env, "RTPU_PROBER_SLOW_S", 600.0, float),
    )


def load_efficiency_config(
        env: Optional[Mapping[str, str]] = None) -> EfficiencyConfig:
    """Just the goodput-ledger/watchdog knobs (read lazily by
    ``routest_tpu_torch/obs/efficiency.py`` at first ``get_ledger()`` and by
    serving bring-up)."""
    env = dict(env if env is not None else os.environ)
    return EfficiencyConfig(
        enabled=env.get("RTPU_EFF", "1") != "0",
        watchdog=env.get("RTPU_EFF_WATCHDOG", "1") != "0",
        min_ratio=_env_num(env, "RTPU_EFF_MIN_RATIO", 0.25, float),
        max_waste=_env_num(env, "RTPU_EFF_MAX_WASTE", 0.7, float),
        after=_env_num(env, "RTPU_EFF_AFTER", 3, int),
        tick_s=_env_num(env, "RTPU_EFF_TICK_S", 5.0, float),
        window_s=_env_num(env, "RTPU_EFF_WINDOW_S", 60.0, float),
        min_rows=_env_num(env, "RTPU_EFF_MIN_ROWS", 256, int),
        kernel_artifact=env.get("RTPU_EFF_KERNEL_ARTIFACT")
        or EfficiencyConfig.kernel_artifact,
        chips_artifact=env.get("RTPU_EFF_CHIPS_ARTIFACT")
        or "artifacts/fleet_chips.json",
        slo_target=_env_num(env, "RTPU_EFF_SLO_TARGET", 0.99, float),
        fast_window_s=_env_num(env, "RTPU_EFF_FAST_S", 60.0, float),
        slow_window_s=_env_num(env, "RTPU_EFF_SLOW_S", 600.0, float),
    )


def load_ledger_config(
        env: Optional[Mapping[str, str]] = None) -> LedgerConfig:
    """Just the change-ledger knobs (read lazily by
    ``routest_tpu_torch/obs/ledger.py`` at first ``get_change_ledger()``)."""
    env = dict(env if env is not None else os.environ)
    return LedgerConfig(
        enabled=env.get("RTPU_LEDGER", "1") != "0",
        capacity=_env_num(env, "RTPU_LEDGER_CAPACITY", 512, int),
        window_s=_env_num(env, "RTPU_LEDGER_WINDOW_S", 900.0, float),
        max_suspects=_env_num(env, "RTPU_LEDGER_MAX_SUSPECTS", 5, int),
        publish=env.get("RTPU_LEDGER_PUBLISH", "1") != "0",
        channel=env.get("RTPU_LEDGER_CHANNEL") or "rtpu.changes",
        incidents_kept=_env_num(env, "RTPU_LEDGER_INCIDENTS_KEPT",
                                64, int),
        region=env.get("RTPU_REGION", ""),
    )


def load_recorder_config(
        env: Optional[Mapping[str, str]] = None) -> RecorderConfig:
    """Just the flight-recorder knobs (read lazily by
    ``routest_tpu_torch/obs/recorder.py`` at first ``get_recorder()``)."""
    env = dict(env if env is not None else os.environ)
    return RecorderConfig(
        enabled=env.get("RTPU_RECORDER", "1") != "0",
        capacity=_env_num(env, "RTPU_RECORDER_CAPACITY", 512, int),
        log_capacity=_env_num(env, "RTPU_RECORDER_LOG_CAPACITY", 512, int),
        dir=env.get("RTPU_RECORDER_DIR") or "artifacts/postmortems",
        max_bundles=_env_num(env, "RTPU_RECORDER_MAX_BUNDLES", 16, int),
        max_total_mb=_env_num(env, "RTPU_RECORDER_MAX_MB", 64.0, float),
        min_interval_s=_env_num(env, "RTPU_RECORDER_MIN_INTERVAL_S",
                                30.0, float),
        burst_5xx=_env_num(env, "RTPU_RECORDER_BURST_5XX", 5, int),
        burst_window_s=_env_num(env, "RTPU_RECORDER_BURST_WINDOW_S",
                                10.0, float),
        deadline_spike=_env_num(env, "RTPU_RECORDER_DEADLINE_SPIKE",
                                20, int),
        followup_s=_env_num(env, "RTPU_RECORDER_FOLLOWUP_S", 5.0, float),
    )


def load_obs_config(env: Optional[Mapping[str, str]] = None) -> ObsConfig:
    """Just the observability knobs (the obs package reads these lazily
    at first-tracer-use without paying for a full Config build)."""
    env = dict(env if env is not None else os.environ)

    def _num(name: str, default, cast):
        raw = env.get(name)
        if not raw:
            return default
        try:
            return cast(raw)
        except ValueError:
            return default  # ops knob: malformed value must not abort boot

    return ObsConfig(
        enabled=env.get("RTPU_OBS_TRACE", "1") != "0",
        sample_rate=_num("RTPU_OBS_SAMPLE", 1.0, float),
        buffer_spans=_num("RTPU_OBS_BUFFER", 2048, int),
        trace_export_path=env.get("RTPU_OBS_EXPORT_PATH"),
        device_trace_dir=env.get("RTPU_OBS_DEVICE_TRACE_DIR"),
        device_trace_max=_num("RTPU_OBS_DEVICE_TRACE_MAX", 1, int),
        tail=env.get("RTPU_TAIL_SAMPLE", "0") == "1",
        tail_slow_ms=_num("RTPU_TAIL_SAMPLE_SLOW_MS", 0.0, float),
        tail_reservoir=_num("RTPU_TAIL_SAMPLE_RESERVOIR", 0.02, float),
        tail_max_pending=_num("RTPU_TAIL_SAMPLE_MAX_PENDING", 256, int),
        tail_ttl_s=_num("RTPU_TAIL_SAMPLE_TTL_S", 60.0, float),
    )


def _parse_resolutions(raw: Optional[str]) -> Tuple[Tuple[float, int], ...]:
    """``"10x360,60x360"`` → ((10.0, 360), (60.0, 360)), finest first.
    Malformed specs keep the default (ops knob: a typo must not abort
    boot)."""
    default = TimelineConfig.resolutions
    if not raw:
        return default
    out = []
    try:
        for tok in raw.split(","):
            tok = tok.strip()
            if not tok:
                continue
            step, _, slots = tok.partition("x")
            step_s, n = float(step), int(slots)
            if step_s <= 0 or n <= 0:
                return default
            out.append((step_s, n))
    except ValueError:
        return default
    if not out:
        return default
    return tuple(sorted(out))


def load_timeline_config(
        env: Optional[Mapping[str, str]] = None) -> TimelineConfig:
    """Just the timeline knobs (read by ``routest_tpu_torch/obs/timeline.py``
    and serving bring-up without paying for a full Config build)."""
    env = dict(env if env is not None else os.environ)
    return TimelineConfig(
        enabled=env.get("RTPU_TIMELINE", "1") != "0",
        resolutions=_parse_resolutions(env.get("RTPU_TIMELINE_RES")),
        watch=env.get("RTPU_TIMELINE_WATCH", "1") != "0",
        watch_baseline_frames=_env_num(
            env, "RTPU_TIMELINE_WATCH_BASELINE", 3, int),
        watch_cooldown_s=_env_num(
            env, "RTPU_TIMELINE_WATCH_COOLDOWN_S", 120.0, float),
        watch_latency_factor=_env_num(
            env, "RTPU_TIMELINE_WATCH_LATENCY_FACTOR", 2.0, float),
        watch_latency_floor_ms=_env_num(
            env, "RTPU_TIMELINE_WATCH_LATENCY_FLOOR_MS", 50.0, float),
        watch_error_step=_env_num(
            env, "RTPU_TIMELINE_WATCH_ERROR_STEP", 0.05, float),
        watch_throughput_frac=_env_num(
            env, "RTPU_TIMELINE_WATCH_THROUGHPUT_FRAC", 0.3, float),
        watch_min_rate=_env_num(
            env, "RTPU_TIMELINE_WATCH_MIN_RATE", 1.0, float),
        watch_min_count=_env_num(
            env, "RTPU_TIMELINE_WATCH_MIN_COUNT", 5, int),
        bundle_window_s=_env_num(
            env, "RTPU_TIMELINE_BUNDLE_WINDOW_S", 900.0, float),
    )


def load_profile_config(
        env: Optional[Mapping[str, str]] = None) -> ProfileConfig:
    """Just the triggered-profiling knobs (read by
    ``routest_tpu_torch/obs/profiler.py`` and serving bring-up)."""
    env = dict(env if env is not None else os.environ)
    return ProfileConfig(
        enabled=env.get("RTPU_PROFILE", "1") != "0",
        duration_s=_env_num(env, "RTPU_PROFILE_DURATION_S", 2.0, float),
        interval_ms=_env_num(env, "RTPU_PROFILE_INTERVAL_MS", 10.0, float),
        max_captures=_env_num(env, "RTPU_PROFILE_MAX", 4, int),
        min_interval_s=_env_num(env, "RTPU_PROFILE_MIN_INTERVAL_S",
                                60.0, float),
        device_trace=env.get("RTPU_PROFILE_DEVICE", "0") == "1",
    )
