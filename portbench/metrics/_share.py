"""Shared arithmetic of the per-layer readers: each reader is one call
into these with its own keys.  A reader returns None where its cell's
trace or counts have nothing for it."""
from __future__ import annotations

from portbench.counts import BF16_FLOP_PER_S


def mfu(info: dict, flops_key: str):
    """Model FLOPs of the traced units over the traced window at the bf16
    peak, in %."""
    flops = info.get(flops_key)
    if not flops or not info.get("window_s"):
        return None
    return 100 * flops / (info["window_s"] * BF16_FLOP_PER_S)


def roofline(info: dict, prefix: str, marks: tuple):
    """The summed bound of a kernel's launches over their summed device
    time, in %, where the program's launch counter agrees with the
    launches the traffic made."""
    if info.get(f"{prefix}_launches") != info.get(f"{prefix}_calls"):
        return None
    n, sec = info["trace"].kernel_s(marks)
    if not n or not sec:
        return None
    return 100 * info[f"{prefix}_bound_s"] / sec


def idle(info: dict):
    """The share of the traced window with no device operation, in %."""
    tr = info["trace"]
    if not tr.ops:
        return None
    return 100 * (1 - tr.busy_s() / tr.window_s)
