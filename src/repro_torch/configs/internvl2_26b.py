"""internvl2-26b [vlm]: InternViT frontend (stubbed) + InternLM2 backbone.

48L d_model=6144 48H (kv=8) d_ff=16384 vocab=92553.  [arXiv:2404.16821]
input_specs() supplies precomputed patch embeddings (256 image tokens).
Pure full attention => long_500k skipped (DESIGN.md §5).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    img_tokens=256,
)
