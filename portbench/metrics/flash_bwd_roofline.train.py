"""The flash backward's share of its roofline (%): the summed bound of its
launches (five products over the attended pairs, or its bytes) over the
summed device time of its kernels (``csrc/flash_attn_bwd.cu``)."""
from portbench.metrics._share import roofline


def read(info: dict):
    return roofline(info, "flash_bwd", ("flash_bwd",))
