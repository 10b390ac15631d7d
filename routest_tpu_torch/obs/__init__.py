"""Observability: the process-wide metrics registry and the build-identity
gauges.

Tracing, the timeline, SLOs and the flight recorder of
``routest_tpu/obs`` arrive with the observability slice.
"""

from routest_tpu_torch.obs.registry import (MetricsRegistry,  # noqa: F401
                                            build_info, get_registry,
                                            register_build_info)
