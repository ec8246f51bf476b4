"""Observability for the port: the sim-time span tracer, decision
provenance, the metrics registry and the trace exporters (JSONL and
Chrome ``trace_event``), each a port of its ``repro.obs`` module."""
from repro_torch.obs.export import (chrome_trace, read_jsonl, write_chrome,
                                    write_jsonl)
from repro_torch.obs.provenance import (REASONS, Explain, explain_admission,
                                        reason_counts)
from repro_torch.obs.registry import NULL_REGISTRY, MetricsRegistry
from repro_torch.obs.trace import CATS, NULL_TRACER, Span, Tracer

__all__ = [
    "CATS", "Explain", "MetricsRegistry", "NULL_REGISTRY", "NULL_TRACER",
    "REASONS", "Span", "Tracer", "chrome_trace", "explain_admission",
    "read_jsonl", "reason_counts", "write_chrome", "write_jsonl",
]
