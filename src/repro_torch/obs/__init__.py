"""Observability layer: simulated-clock tracing + telemetry (stdlib only)."""
from repro_torch.obs.trace import (Counters, NULL_TRACER, NullTracer,
                             REQUIRED_EVENT_KEYS, Tracer, load_trace,
                             validate_events)

__all__ = ["Counters", "NULL_TRACER", "NullTracer", "REQUIRED_EVENT_KEYS",
           "Tracer", "load_trace", "validate_events"]
