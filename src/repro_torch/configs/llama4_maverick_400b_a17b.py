"""llama4-maverick-400b-a17b [moe]: interleaved MoE + shared expert.

48L d_model=5120 40H (kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
MoE on every 2nd layer + shared expert -> ~400B total / ~17B active.
Chunked local attention (iRoPE-style, 8192) => long_500k applicable.
bf16 params + bf16 optimizer states (the JAX package's sizing for its
TPU dry-run).  [hf:meta-llama/Llama-4 family]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    top_k=1,
    moe_period=2,
    shared_expert=True,
    moe_shard="expert",
    chunk_attn=8192,
    param_dtype="bfloat16",
    opt_dtype="bfloat16",
)
