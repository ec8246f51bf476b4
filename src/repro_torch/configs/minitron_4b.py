"""minitron-4b [dense]: pruned nemotron, huge vocab.

32L d_model=3072 24H (kv=8) d_ff=9216 vocab=256000.  [arXiv:2407.14679]
Pure full attention => long_500k skipped (DESIGN.md §5).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
)
