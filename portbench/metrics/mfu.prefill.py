"""Model FLOP utilisation of prefill (%): the forward FLOPs of the traced
waves over their time and the bf16 peak."""
from portbench.metrics._share import mfu


def read(info: dict):
    return mfu(info, "prefill_flops")
