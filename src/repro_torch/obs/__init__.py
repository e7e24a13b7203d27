"""Observability: the telemetry registry (metrics + traces + events)."""
from repro_torch.obs.telemetry import (Counter, Histogram, Span,  # noqa: F401
                                       Telemetry, Trace, get_telemetry,
                                       new_request_id, set_telemetry,
                                       span_names, walk_spans)
