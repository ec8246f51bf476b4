"""Architecture + input-shape configuration (the port's own copy).

Every architecture is an ``ArchConfig``; the four input shapes are
``ShapeConfig``s.  ``reduced()`` derives a tiny same-family config for
CPU tests.  Field for field the same dataclasses as the JAX package's
``models/config.py``, so a configuration means the same in both (and
``repr`` gives the same string, which the checkpoints' config hash
reads).  Training reads ``remat`` (any value but "none" recomputes each
layer in the backward pass, ``torch.utils.checkpoint``), ``loss_chunk``
and ``opt_dtype``; the execution knobs that only steer XLA (scan,
sharding, the attention chunk sizes) are kept for that reason and are
not read by the port.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # --- attention ---
    window: int | None = None        # sliding-window attention width (tokens)
    chunk_attn: int | None = None    # llama4 iRoPE-style chunked-local width
    rope_theta: float = 10_000.0

    # --- mixture of experts ---
    num_experts: int = 0
    top_k: int = 0
    moe_period: int = 1              # every k-th layer is MoE (1 = all layers)
    shared_expert: bool = False
    capacity_factor: float = 1.25
    moe_shard: str = "expert"        # "expert" (EP over model axis) | "ffn" (TP)

    # --- state-space (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    conv_width: int = 4
    ssd_chunk: int = 256

    # --- hybrid (recurrentgemma / griffin) ---
    block_pattern: tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0

    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 0                 # frontend-stub sequence length (frames)

    # --- vision-language (internvl) ---
    img_tokens: int = 0              # frontend-stub patch-embedding count

    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_dtype: str = "float32"
    tie_embeddings: bool = False

    # --- execution knobs (hillclimb surface) ---
    remat: str = "full"              # full | dots | none
    loss_chunk: int = 2048           # tokens per chunked-xent slice
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    scan_layers: bool = True
    attention_impl: str = "chunked"  # chunked (pure-jnp) | pallas (TPU target)
    # Perf-iteration knobs (see EXPERIMENTS.md §Perf)
    pad_heads_to: int = 0            # explicit head padding (0 = GSPMD implicit)
    seq_shard_decode: bool = False   # shard long-context cache over data axis
    attn_shard: str = "auto"         # auto | heads | seq — activation-sharding
                                     # constraint inside attention (§Perf):
                                     # "heads" pins H over model (uneven ok,
                                     # stops GSPMD head_dim-factorized partial
                                     # sums); "seq" shards q positions over
                                     # model with replicated KV (context-
                                     # parallel, no head-count waste)
    attn_f32_scores: bool = True     # f32 online-softmax statistics; False
                                     # keeps score tiles in bf16 (hillclimb)
    fsdp: bool = True                # False: TP-only weights (serving layout
                                     # — no per-layer weight gathers / no
                                     # activation reduces over the data axis)

    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a 128 multiple so embedding tables shard evenly
        over the 16-way model axis (Megatron-style vocab padding)."""
        return -(-self.vocab_size // 128) * 128

    @property
    def padded_heads(self) -> int:
        """Q-head count used for layout (>= num_heads).  Padding is pure
        compute-layout waste with zero semantic change: pad-head outputs are
        sliced off before the output projection and their wq slices stay
        zero (§Perf: stops GSPMD factorizing the sharding across head_dim
        when num_heads doesn't divide the model axis)."""
        return self.pad_heads_to if self.pad_heads_to else self.num_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_swa(self) -> bool:
        return self.window is not None or self.chunk_attn is not None

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode-state archs run long_500k (see DESIGN.md §5)."""
        return self.family in ("ssm", "hybrid") or self.is_swa

    @property
    def has_decoder(self) -> bool:
        return True   # no assigned arch is encoder-only

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 4) if not self.block_pattern
            else len(self.block_pattern) + 1,
            d_model=64,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16 if self.num_heads else self.head_dim,
            loss_chunk=64,
            attn_q_chunk=32,
            attn_kv_chunk=32,
            ssd_chunk=16,
            remat="none",
        )
        if self.window is not None:
            kw["window"] = 32
        if self.chunk_attn is not None:
            kw["chunk_attn"] = 32
        if self.num_experts:
            kw["num_experts"] = 4
            kw["top_k"] = min(self.top_k, 2)
        if self.family == "ssm":
            kw["ssm_state"] = 16
            kw["ssm_headdim"] = 16
        if self.family == "hybrid":
            kw["lru_width"] = 64
            kw["num_kv_heads"] = 1
        if self.enc_layers:
            kw["enc_layers"] = 2
            kw["enc_seq"] = 16
        if self.img_tokens:
            kw["img_tokens"] = 8
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int

    def reduced(self) -> "ShapeConfig":
        return ShapeConfig(self.name + "-reduced", self.kind,
                           seq_len=min(self.seq_len, 128),
                           global_batch=min(self.global_batch, 2))


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """The assigned shape cells that run for this arch (skips per DESIGN.md)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        names.append("long_500k")
    return names
