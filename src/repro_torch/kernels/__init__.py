"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``sorted_probe`` (the LSM read probe), ``window_agg`` (the LSM
weight segment sum), ``flash_attn`` (prefill attention) and
``decode_attn`` (decode attention against a KV cache).  Sources live in
``repro_torch/csrc``; see ``_build`` for how they are compiled and
loaded."""
