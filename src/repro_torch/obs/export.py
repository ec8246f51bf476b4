"""Trace exporters: JSONL (the repo schema) and Chrome ``trace_event``
(port of ``repro.obs.export``; the same header and schema, so a trace
written by either package reads in the other).

JSONL layout (validated by ``tools/check_trace.py``): a header line
``{"kind": "repro-trace", "version": 1, ...meta}`` followed by one span
dict per line (see :meth:`repro_torch.obs.trace.Span.to_dict`).

The Chrome exporter writes the ``trace_event`` JSON object format —
complete ("X") events with microsecond timestamps, one tid per tenant
with ``thread_name`` metadata — so an episode or a fleet window opens
directly in Perfetto / chrome://tracing as a timeline.
"""
from __future__ import annotations

import json

TRACE_KIND = "repro-trace"
TRACE_VERSION = 1


def write_jsonl(spans, path: str, meta: dict | None = None) -> None:
    """Header line + one span per line."""
    header = {"kind": TRACE_KIND, "version": TRACE_VERSION}
    if meta:
        header.update(meta)
    with open(path, "w") as f:
        f.write(json.dumps(header) + "\n")
        for s in spans:
            f.write(json.dumps(s.to_dict()) + "\n")


def read_jsonl(path: str) -> tuple[dict, list[dict]]:
    """(header, span dicts) — raises ValueError on a non-trace file."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty trace")
    header = json.loads(lines[0])
    if header.get("kind") != TRACE_KIND:
        raise ValueError(f"{path}: not a {TRACE_KIND} file")
    return header, [json.loads(ln) for ln in lines[1:]]


def chrome_trace(spans, meta: dict | None = None) -> dict:
    """Spans -> Chrome ``trace_event`` object format.  Sim seconds map to
    trace microseconds; zero-length phase marks get a 1 us floor so they
    stay visible in Perfetto."""
    tenants = sorted({s.tenant for s in spans})
    tid = {t: i + 1 for i, t in enumerate(tenants)}
    events = [{"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
               "args": {"name": "repro control loop"}}]
    for t in tenants:
        events.append({"ph": "M", "pid": 1, "tid": tid[t],
                       "name": "thread_name",
                       "args": {"name": t or "episode"}})
    for s in spans:
        args = dict(s.args)
        if s.window is not None:
            args["window"] = s.window
        events.append({
            "ph": "X", "pid": 1, "tid": tid[s.tenant],
            "name": s.name, "cat": s.cat,
            "ts": s.t0 * 1e6,
            "dur": max((s.t1 - s.t0) * 1e6, 1.0),
            "args": args,
        })
    out = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"kind": TRACE_KIND, "version": TRACE_VERSION}}
    if meta:
        out["otherData"].update(meta)
    return out


def write_chrome(spans, path: str, meta: dict | None = None) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(spans, meta), f, indent=1)
