"""Roofline share of the decode step (%): the untraced steps' least times
(each the larger of its FLOPs over the bf16 peak and its bytes, every
weight once and the keys and values attended, over the HBM rate),
summed, over the time those steps took.  The traced steps are left out:
the profiler slows this host-paced step."""


def read(info: dict):
    bound, sec = info.get("untraced_bound_s"), info.get("untraced_s")
    if not bound or not sec:
        return None
    return 100 * bound / sec
