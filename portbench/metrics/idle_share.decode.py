"""Device idle share of a decode step (%): 1 - the device's busy time a
traced step (the union of its operations' intervals) over the time an
untraced step of the same window takes.  The profiler slows the host,
which paces this step, so the traced window's own idle share reads high;
the device's busy time is the same either way."""


def read(info: dict):
    steps, n = info.get("steps"), info.get("untraced_steps")
    tr = info["trace"]
    if not steps or not n or not tr.ops:
        return None
    return 100 * (1 - (tr.busy_s() / steps) / (info["untraced_s"] / n))
