"""The decode attention's share of its roofline (%): the summed byte
bound of its launches over the summed device time of its kernels
(``csrc/decode_attn.cu``)."""
from portbench.metrics._share import roofline


def read(info: dict):
    return roofline(info, "decode_attn", ("decode_tc", "decode_kernel"))
