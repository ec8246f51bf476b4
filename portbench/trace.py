"""Spans and the device trace.

The benchmark's own files put a ``record_function`` span around each call
into a layer of the program (``SPANS``).  With ``--trace 1`` a
``torch.profiler`` session (CPU and CUDA activity) covers the traced part
of the window, and ``summarise`` reduces it to what the per-layer
readers and the result's ``breakdown`` take: every device operation
(kernels, copies, fills) with its interval, the span whose host call
launched it (through the launch's correlation id and the host call
stack), the busy time (the union of the device intervals), and the idle
gaps, each named by the innermost span the host was in at the gap."""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

SPANS = ("prefill", "decode_step", "loss_and_grad", "adamw", "draw_inputs",
         "reference")
WINDOW = "traced_window"


def span(name: str):
    """A named range the trace attributes device work to."""
    return torch.profiler.record_function(name)


@dataclass
class Trace:
    """The reduced trace of one traced window (times in seconds from the
    window's start)."""
    window_s: float
    ops: list = field(default_factory=list)      # (name, start, end, span)
    spans: list = field(default_factory=list)    # (name, start, end) host

    def busy_s(self) -> float:
        total, end = 0.0, float("-inf")
        for _, s, e, _ in sorted(self.ops, key=lambda o: o[1]):
            if e > end:
                total += e - max(s, end)
                end = e
        return total

    def kernel_s(self, marks: tuple) -> tuple[int, float]:
        """(count, summed seconds) of the device operations whose name
        holds any of ``marks``."""
        hit = [e - s for n, s, e, _ in self.ops if any(m in n for m in marks)]
        return len(hit), sum(hit)

    def span_ops(self, name: str, kernels_only: bool = False
                 ) -> tuple[int, float]:
        """(count, summed seconds) of the device operations launched
        inside span ``name``."""
        hit = [e - s for n, s, e, sp in self.ops if sp == name
               and not (kernels_only and _is_copy(n))]
        return len(hit), sum(hit)

    def top_ops(self, n: int = 10) -> list:
        sums: dict = {}
        for name, s, e, _ in self.ops:
            sums[name] = sums.get(name, 0.0) + (e - s)
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], sec] for name, sec in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest stretches with no device operation, each
        named by the innermost host span at its midpoint."""
        gaps, end = [], 0.0
        for _, s, e, _ in sorted(self.ops, key=lambda o: o[1]):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.window_s > end:
            gaps.append((end, self.window_s))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) / 2
            inside = [sp for sp in self.spans if sp[1] <= mid <= sp[2]]
            name = max(inside, key=lambda sp: sp[1])[0] if inside else "host"
            out.append([name, e - s])
        return out


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


class Tracer:
    """Profiles the traced window, a prefix of the measured one, when
    ``on``: ``start`` before its first unit of work, ``stop`` after the
    last, which synchronises and reduces the trace.  Off, both do
    nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.trace: Trace | None = None
        self._prof = None
        self._span = None
        self._t0 = 0.0

    def start(self) -> None:
        if not self.on or self.trace is not None or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._span = span(WINDOW)
        self._span.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._prof is None:
            return
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.trace = summarise(self._prof.events(), wall)
        self._prof = self._span = None


def summarise(events, wall_s: float) -> Trace:
    """Reduce ``profile.events()`` to a ``Trace`` of the window span."""
    from torch.autograd import DeviceType
    win = next((e for e in events if e.name == WINDOW
                and e.device_type == DeviceType.CPU), None)
    t0 = win.time_range.start if win else min(
        e.time_range.start for e in events)
    launch = {}
    spans = []
    dev = []
    for e in events:
        if e.device_type == DeviceType.CPU:
            if getattr(e, "is_user_annotation", False) and e.name in SPANS:
                spans.append((e.name, (e.time_range.start - t0) / 1e6,
                              (e.time_range.end - t0) / 1e6))
            elif e.name.startswith("cu"):
                launch[e.id] = e
        elif not getattr(e, "is_user_annotation", False):
            dev.append(e)
    ops = []
    for e in dev:
        owner = None
        p = launch.get(e.id)
        while p is not None:
            if p.name in SPANS:
                owner = p.name
                break
            p = p.cpu_parent
        ops.append((e.name, (e.time_range.start - t0) / 1e6,
                    (e.time_range.end - t0) / 1e6, owner))
    return Trace(window_s=wall_s, ops=ops, spans=spans)
