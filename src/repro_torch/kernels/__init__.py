"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``sorted_probe`` (the LSM read probe) and ``window_agg`` (the
LSM weight segment sum).  Sources live in ``repro_torch/csrc``; see
``_build`` for how they are compiled and loaded."""
