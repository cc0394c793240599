"""Process-wide telemetry of the port (twin of
``pybitmessage_tpu.observability``): metrics registry, span tracer,
exporters, object lifecycle tracing, flight recorder, runtime health
probes, the device telemetry plane, the sampling profiler
(``profiling.py``: ``costStatus``, ``profileDump``, ``GET
/debug/profile``), the wire trace's ``TraceContext`` /
``SkewEstimator`` and metrics federation (``federation.py``).
"""

from .devicetelemetry import (DEVICE_TELEMETRY, DeviceTelemetry,
                              DeviceTrace, capture_device_trace,
                              device_cost_block, device_status,
                              env_fingerprint,
                              record_launch, register_program)
from .federation import (FEDERATION_VERSION, Aggregator,
                         FederationPublisher, delta_snapshot,
                         http_transport, mergeable_snapshot)
from .export import (escape_help, escape_label_value, log_snapshot_task,
                     render_prometheus, snapshot)
from .flightrec import FLIGHT_RECORDER, FlightRecorder
from .health import HealthMonitor, LoopLagProbe
from .lifecycle import LIFECYCLE, LifecycleTracer
from .metrics import (DEFAULT_LATENCY_BUCKETS, DEFAULT_SIZE_BUCKETS,
                      REGISTRY, Counter, Gauge, Histogram, Registry,
                      peer_bucket, peer_bucket_label, set_peer_buckets)
from .profiling import (PROFILER, SamplingProfiler, cost_status,
                        cpu_shares, crypto_rung_costs, farm_tenant_costs,
                        ingest_stage_costs, note_slow_callback,
                        speedscope_doc)
from .tracing import (TRACE_CTX_LEN, TRACER, SkewEstimator, Span,
                      TraceContext, Tracer, current_span,
                      enable_profiler_annotations, new_span_id,
                      new_trace_id, profiler_annotations_enabled, trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "DEFAULT_LATENCY_BUCKETS", "DEFAULT_SIZE_BUCKETS",
    "peer_bucket", "peer_bucket_label", "set_peer_buckets",
    "Span", "Tracer", "TRACER", "trace", "current_span",
    "enable_profiler_annotations", "profiler_annotations_enabled",
    "new_trace_id", "new_span_id", "TraceContext", "SkewEstimator",
    "TRACE_CTX_LEN",
    "render_prometheus", "snapshot", "log_snapshot_task",
    "escape_help", "escape_label_value",
    "LifecycleTracer", "LIFECYCLE",
    "FEDERATION_VERSION", "Aggregator", "FederationPublisher",
    "mergeable_snapshot", "delta_snapshot", "http_transport",
    "FlightRecorder", "FLIGHT_RECORDER",
    "HealthMonitor", "LoopLagProbe",
    "DeviceTelemetry", "DEVICE_TELEMETRY", "DeviceTrace",
    "register_program", "record_launch", "device_status",
    "capture_device_trace", "env_fingerprint", "device_cost_block",
    "SamplingProfiler", "PROFILER", "cost_status", "cpu_shares",
    "ingest_stage_costs", "farm_tenant_costs", "crypto_rung_costs",
    "note_slow_callback", "speedscope_doc",
]
