"""Resource-accounting comparisons with one epsilon (port of
``repro.core.units``).

Memory footprints are *accumulated* floats, and two mathematically equal
footprints can differ by a few ULPs depending on summation order.  Every
budget comparison on MB quantities goes through ONE tolerance, defined
here:

* :func:`mem_fits` — "does ``used`` fit in ``budget``?" (``<=`` + eps);
* :func:`mem_exceeds` — "is ``a`` strictly more than ``b``?" (``>`` + eps,
  the admission-gating growth test);
* :func:`mem_close` — drift-tolerant equality.
"""
from __future__ import annotations

# One tolerance for every budget comparison.  1e-9 MB is ~1 byte — far
# below any real grant and far above accumulated float drift at fleet
# scale (thousands of ~1e3-MB terms drift by <1e-9 relative).
MB_EPS = 1e-9


def mem_fits(used_mb: float, budget_mb: float, *,
             eps: float = MB_EPS) -> bool:
    """Does a summed footprint fit a budget, tolerating summation drift?"""
    return used_mb <= budget_mb + eps


def mem_exceeds(a_mb: float, b_mb: float, *, eps: float = MB_EPS) -> bool:
    """Is ``a_mb`` strictly larger than ``b_mb`` beyond float drift?  The
    admission-gating test: a footprint only *grows* when it grows by more
    than an epsilon, so a drifted re-quote of an identical placement is
    never treated as a scale-up."""
    return a_mb > b_mb + eps


def mem_close(a_mb: float, b_mb: float, *, eps: float = MB_EPS) -> bool:
    """Drift-tolerant equality between two MB quantities (audit
    reconciliation between incremental counters and full sums)."""
    return abs(a_mb - b_mb) <= eps
