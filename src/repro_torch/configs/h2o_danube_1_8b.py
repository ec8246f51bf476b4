"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (kv=8) d_ff=6912 vocab=32000.  [arXiv:2401.16818]
SWA => long_500k applicable.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    window=4096,
    tie_embeddings=True,
)
