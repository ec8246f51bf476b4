"""internlm2-20b [dense]: GQA.

48L d_model=6144 48H (kv=8) d_ff=16384 vocab=92544.  [arXiv:2403.17297]
Pure full attention => long_500k skipped (DESIGN.md §5).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
)
