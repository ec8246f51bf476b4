"""Observability for the port: the sim-time span tracer and decision
provenance that the controller and policies import.  (The reference's
metrics registry and exporters are not ported yet.)"""
from repro_torch.obs.provenance import (REASONS, Explain, explain_admission,
                                        reason_counts)
from repro_torch.obs.trace import CATS, NULL_TRACER, Span, Tracer

__all__ = ["CATS", "Explain", "NULL_TRACER", "REASONS", "Span", "Tracer",
           "explain_admission", "reason_counts"]
