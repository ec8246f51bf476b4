"""whisper-medium [audio]: enc-dec, conv frontend stubbed as precomputed frames.

24L (24 enc + 24 dec) d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.
[arXiv:2212.04356]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    enc_layers=24,
    enc_seq=1500,                 # post-conv mel frames (stub supplies these)
)
