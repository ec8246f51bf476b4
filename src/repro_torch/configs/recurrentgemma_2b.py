"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1:2 ratio.

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000.  [arXiv:2402.19427]
Block pattern (rec, rec, attn); bounded state => long_500k applicable.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    window=2048,
    tie_embeddings=True,
)
