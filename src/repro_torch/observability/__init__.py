"""Observability plane of the port: flight recorder (post-hoc) + live
telemetry (copies of the JAX package's ``repro.observability`` modules of
those names). Every request of a recorded serving plane carries a
``TraceContext`` of spans; a ``Recorder`` daemon persists one JSONL record
per finished request to a queryable ``RecordStore``; ``replay`` re-serves a
recorded trace. The *live* half — ``MetricsRegistry`` typed time series
with Prometheus exposition, an ``SLOEngine`` whose error-budget burn rate
drives the autoscaler/arbiter, and the ``TelemetryServer`` HTTP surface
(/metrics, /healthz, /vres) — answers "is VRE Y healthy right now".
"""
from repro_torch.observability.tracing import (NULL_TRACE, Span,
                                               TraceContext, null_trace)
from repro_torch.observability.recorder import (Recorder, RecordStore,
                                                format_span_tree)
from repro_torch.observability.replay import load_replay, replay_records
from repro_torch.observability.metrics import (MetricSample,
                                               MetricsRegistry,
                                               render_exposition,
                                               validate_exposition)
from repro_torch.observability.slo import (SLOEngine, SLOTarget,
                                           targets_from_config)
from repro_torch.observability.telemetry import (TelemetryServer,
                                                 fleet_telemetry,
                                                 replicaset_telemetry,
                                                 vre_telemetry)

__all__ = [
    "NULL_TRACE", "Span", "TraceContext", "null_trace",
    "Recorder", "RecordStore", "format_span_tree",
    "load_replay", "replay_records",
    "MetricSample", "MetricsRegistry", "render_exposition",
    "validate_exposition",
    "SLOEngine", "SLOTarget", "targets_from_config",
    "TelemetryServer", "fleet_telemetry", "replicaset_telemetry",
    "vre_telemetry",
]
