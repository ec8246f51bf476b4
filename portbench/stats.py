"""Order statistics of the end-to-end metrics."""
from __future__ import annotations


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values`` by linear interpolation
    between the closest ranks (numpy's default): rank (n - 1) q / 100."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def window_rate(amount: float, seconds: float) -> float:
    """Work of the whole window over the whole window's time."""
    return amount / seconds
