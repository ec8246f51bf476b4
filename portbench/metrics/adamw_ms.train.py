"""Device milliseconds a step launched under the benchmark's ``adamw``
span (the port's ``optimizer.adamw_update``)."""


def read(info: dict):
    steps = info.get("steps")
    n, sec = info["trace"].span_ops("adamw")
    if not steps or not n:
        return None
    return 1e3 * sec / steps
