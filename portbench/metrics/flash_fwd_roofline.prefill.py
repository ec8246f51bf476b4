"""The flash forward's share of its roofline (%) in prefill: the summed
bound of its launches over the summed device time of its kernel
(``csrc/flash_attn.cu``)."""
from portbench.metrics._share import roofline


def read(info: dict):
    return roofline(info, "flash_fwd", ("flash_fwd",))
