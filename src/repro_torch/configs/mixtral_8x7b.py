"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (kv=8) d_ff=14336 vocab=32000.  [arXiv:2401.04088]
8 experts < 16-way model axis => experts replicated, expert FFN dim TP-sharded
("ffn" MoE sharding).  SWA => long_500k applicable.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    top_k=2,
    moe_shard="ffn",
    window=4096,
)
