"""Model FLOP utilisation of training (%): 6 FLOPs per parameter a token
plus attention at 3 times its forward over the attended keys, over the
traced steps' time and the bf16 peak."""
from portbench.metrics._share import mfu


def read(info: dict):
    return mfu(info, "train_flops")
