"""CUDA kernel launches a decode step: kernels launched under the
benchmark's ``decode_step`` span (copies and fills not counted) over the
traced steps."""


def read(info: dict):
    steps = info.get("steps")
    n, _ = info["trace"].span_ops("decode_step", kernels_only=True)
    if not steps or not n:
        return None
    return n / steps
