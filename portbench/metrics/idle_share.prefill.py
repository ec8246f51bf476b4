"""Device idle share of the traced window (%): 1 - the union of device
operation intervals over the window."""
from portbench.metrics._share import idle


def read(info: dict):
    return idle(info)
