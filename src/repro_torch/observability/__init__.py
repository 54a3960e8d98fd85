"""Observability plane of the port: per-request traces, the flight recorder
and trace replay (copies of the JAX package's ``repro.observability``
modules of those names). Every request of a recorded serving plane carries
a ``TraceContext`` of spans; a ``Recorder`` daemon persists one JSONL record
per finished request to a queryable ``RecordStore``; ``replay`` re-serves a
recorded trace. The live half (metrics, SLOs, the telemetry server) is not
ported yet.
"""
from repro_torch.observability.tracing import (NULL_TRACE, Span,
                                               TraceContext, null_trace)
from repro_torch.observability.recorder import (Recorder, RecordStore,
                                                format_span_tree)
from repro_torch.observability.replay import load_replay, replay_records

__all__ = [
    "NULL_TRACE", "Span", "TraceContext", "null_trace",
    "Recorder", "RecordStore", "format_span_tree",
    "load_replay", "replay_records",
]
