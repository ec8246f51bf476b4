"""Declarative target-rate profiles r(t), in events/s over sim-seconds
(the :class:`~repro_torch.streaming.engine.StreamEngine` clock, i.e.
``engine.now``).  Port of ``repro.scenarios.profiles``: pure Python float
arithmetic, the reference's expressions in the reference's order.

Every profile is a frozen dataclass callable ``profile(t) -> float``; the
controller samples it at each decision-window boundary.  Profiles compose
the workload shapes the dynamic-autoscaling literature evaluates against:
constant load, linear ramps, transient spikes, diurnal (day/night) cycles
and sinusoids, plus arbitrary piecewise-constant steps.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Profile:
    """Base: subclasses implement ``rate(t)``; negative rates are clamped."""

    def rate(self, t: float) -> float:
        raise NotImplementedError

    def __call__(self, t: float) -> float:
        return max(0.0, float(self.rate(t)))


@dataclass(frozen=True)
class Constant(Profile):
    """The paper's fixed-target protocol."""
    value: float

    def rate(self, t: float) -> float:
        return self.value


@dataclass(frozen=True)
class Ramp(Profile):
    """Linear ramp from ``start`` to ``end`` over [t0, t0 + duration_s],
    flat on both sides."""
    start: float
    end: float
    duration_s: float
    t0: float = 0.0

    def rate(self, t: float) -> float:
        if t <= self.t0:
            return self.start
        if t >= self.t0 + self.duration_s:
            return self.end
        frac = (t - self.t0) / self.duration_s
        return self.start + frac * (self.end - self.start)


@dataclass(frozen=True)
class Spike(Profile):
    """``base`` load with a flat transient burst of ``peak`` during
    [t0, t0 + duration_s] — the flash-crowd case."""
    base: float
    peak: float
    t0: float
    duration_s: float

    def rate(self, t: float) -> float:
        return self.peak if self.t0 <= t < self.t0 + self.duration_s \
            else self.base


@dataclass(frozen=True)
class Diurnal(Profile):
    """Raised-cosine day/night cycle between ``low`` (at t=0, "midnight")
    and ``high`` (half a period later) with period ``period_s``."""
    low: float
    high: float
    period_s: float
    phase_s: float = 0.0

    def rate(self, t: float) -> float:
        c = math.cos(2 * math.pi * (t + self.phase_s) / self.period_s)
        return self.low + (self.high - self.low) * (1.0 - c) / 2.0


@dataclass(frozen=True)
class Sinusoid(Profile):
    """``mean`` ± ``amplitude`` sinusoid with period ``period_s``."""
    mean: float
    amplitude: float
    period_s: float
    phase_s: float = 0.0

    def rate(self, t: float) -> float:
        return self.mean + self.amplitude * math.sin(
            2 * math.pi * (t + self.phase_s) / self.period_s)


@dataclass(frozen=True)
class Step(Profile):
    """Piecewise-constant: ``rates[i]`` applies from ``times[i]`` until
    ``times[i+1]`` (``rates[0]`` before ``times[0]`` is never consulted —
    supply ``times[0] == 0``).  ``times`` must be ascending."""
    times: tuple = field(default=(0.0,))
    rates: tuple = field(default=(0.0,))

    def __post_init__(self):
        if len(self.times) != len(self.rates) or not self.times:
            raise ValueError("times and rates must be equal-length, nonempty")
        if list(self.times) != sorted(self.times):
            raise ValueError("times must be ascending")

    def rate(self, t: float) -> float:
        idx = 0
        for i, t0 in enumerate(self.times):
            if t >= t0:
                idx = i
        return self.rates[idx]


def make_profile(name: str, target: float, horizon_s: float) -> Profile:
    """Named profile scaled to a query's target rate — the shapes the
    CLI/benchmarks expose.  ``horizon_s`` is the scenario length used to
    place ramps/spikes/cycles."""
    if name == "constant":
        return Constant(target)
    if name == "ramp":
        return Ramp(start=0.4 * target, end=target,
                    duration_s=0.6 * horizon_s)
    if name == "spike":
        return Spike(base=0.5 * target, peak=target,
                     t0=0.3 * horizon_s, duration_s=0.4 * horizon_s)
    if name == "diurnal":
        return Diurnal(low=0.3 * target, high=target, period_s=horizon_s)
    if name == "sinusoid":
        return Sinusoid(mean=0.7 * target, amplitude=0.3 * target,
                        period_s=0.5 * horizon_s)
    if name == "step":
        return Step(times=(0.0, 0.4 * horizon_s, 0.8 * horizon_s),
                    rates=(0.5 * target, target, 0.7 * target))
    raise ValueError(f"unknown profile {name!r} "
                     f"(have: constant ramp spike diurnal sinusoid step)")
