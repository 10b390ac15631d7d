"""Observability spine of one serving replica: request tracing, the
process-wide metrics registry, and the evidence built on them.

Copied from ``routest_tpu/obs`` (Dapper §2, W3C Trace Context, SRE
workbook ch. 5):

- ``trace``   — a sampling :class:`Tracer` producing :class:`Span`s with
  contextvar-carried parentage and ``traceparent`` inject/extract, so one
  trace id survives client → replica → batcher → device; tail-based
  retention (``RTPU_TAIL_SAMPLE=1``) moves the keep decision to trace
  completion;
- ``registry`` — process-wide counters/gauges/histograms (fixed log-scale
  buckets, per-bucket trace exemplars), exported as JSON and
  Prometheus/OpenMetrics text;
- ``export``  — bounded in-memory span buffer + the tail sampler, JSONL
  and Chrome ``trace_event`` dumps, and the per-span ``torch.profiler``
  device-trace hook;
- ``timeline`` — the registry ticked into bounded multi-resolution rings
  behind ``/api/timeline``, watched for anomalies;
- ``slo``     — per-route objectives over rolling multi-window burn
  rates (``ok → warn → page``);
- ``recorder`` — the flight recorder: bounded request/log rings dumped
  as postmortem bundles on trigger;
- ``profiler`` — triggered stack-sample captures (plus an optional
  ``torch.profiler`` device trace);
- ``ledger``  — the change ledger and suspect ranking;
- ``efficiency`` — the device goodput ledger and its watchdog.

The blackbox prober's runner (``obs/prober.py``) is not ported yet:
the fleet gateway refuses ``RTPU_PROBER=1``. ``slo``, ``timeline``,
``profiler``, ``recorder``, ``ledger`` and ``efficiency`` import lazily
— they pull ``core.config``, which the spine itself must not.
"""

from routest_tpu_torch.obs.export import (SpanBuffer,  # noqa: F401
                                          to_chrome_trace, to_jsonl)
from routest_tpu_torch.obs.registry import (DEFAULT_TIME_BUCKETS,  # noqa: F401
                                            MetricsRegistry, build_info,
                                            get_registry,
                                            register_build_info)
from routest_tpu_torch.obs.trace import (CURRENT, REQUEST_ID_RE,  # noqa: F401
                                         Span, SpanContext, Tracer,
                                         configure_tracer, current_context,
                                         format_traceparent, get_tracer,
                                         mint_request_id, parse_traceparent,
                                         trace_span)
