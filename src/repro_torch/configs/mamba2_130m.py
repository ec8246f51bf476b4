"""mamba2-130m [ssm]: SSD (state-space duality), attention-free.

24L d_model=768 vocab=50280, ssm_state=128.  [arXiv:2405.21060]
Constant-size decode state => long_500k applicable.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    tie_embeddings=True,
)
