"""llama3.2-3b [dense]: small llama3, tied embeddings.

28L d_model=3072 24H (kv=8) d_ff=8192 vocab=128256.  [hf:meta-llama/Llama-3.2]
Pure full attention => long_500k skipped.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    tie_embeddings=True,
    rope_theta=500_000.0,
)
