"""Analytic counts the per-layer metrics divide by: the card's peaks, the
attention kernels' operations and bytes, and the model's FLOPs and bytes
a step.  Frozen here so that a change to the program cannot move the
yardstick; the formulas are those of the port's kernel table (a prefill
row's bound is 4 B Hq D times the attended keys over the bf16 peak, a
decode row's the bytes of the slots it reads over the HBM rate)."""
from __future__ import annotations

BF16_FLOP_PER_S = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3


def attended_keys(sq: int, skv: int, window: int | None) -> int:
    """Keys a causal mask leaves, summed over query rows; row i sits at
    position p = i + skv - sq (suffix alignment) and attends keys
    (p - window, p]: min(p + 1, window) of them."""
    lo, hi = skv - sq + 1, skv                  # p + 1 over the rows
    w = hi if window is None else window
    below = max(lo - 1, min(hi, w))             # last p + 1 under the window
    return (lo + below) * (below - lo + 1) // 2 + (hi - below) * w


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two."""
    return max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def flash_fwd(b: int, hq: int, hk: int, sq: int, skv: int, d: int,
              window: int | None) -> tuple[int, int]:
    """(operations, bytes) of one bf16 forward launch: QK^T and PV over
    the attended pairs; q, k, v read and the output written once."""
    flops = 4 * b * hq * d * attended_keys(sq, skv, window)
    nbytes = 2 * (2 * b * hq * sq * d + 2 * b * hk * skv * d)
    return flops, nbytes


def flash_bwd(b: int, hq: int, hk: int, s: int, d: int,
              window: int | None) -> tuple[int, int]:
    """(operations, bytes) of one bf16 backward launch: five products over
    the attended pairs; q, k, v, o, dO and the log-sum-exp read, dq, dk
    and dv written."""
    flops = 10 * b * hq * d * attended_keys(s, s, window)
    q = b * hq * s * d
    kv = b * hk * s * d
    nbytes = 2 * (2 * q + 2 * kv + 2 * kv + q + q) + 4 * b * hq * s
    return flops, nbytes


def decode_attn(b: int, hq: int, hk: int, span: int, d: int
                ) -> tuple[int, int]:
    """(operations, bytes) of one bf16 decode launch over ``span`` slots a
    row: k and v of the span read once, q read and the output written,
    and the int32 bounds of each row."""
    flops = 4 * hq * d * b * span
    nbytes = 2 * b * span * hk * d * 2 + 2 * 2 * b * hq * d + 2 * b * 4
    return flops, nbytes


def layer_matrix_params(a: dict) -> int:
    """Parameters of one layer's matrices that every token multiplies:
    the attention projections and the FFN (for MoE: ``top_k`` experts,
    plus the router)."""
    d, hd = a["d_model"], a["head_dim"]
    attn = d * (a["num_heads"] * hd) * 2 + d * (a["num_kv_heads"] * hd) * 2
    ffn = 3 * d * a["d_ff"]
    if a.get("num_experts"):
        return attn + a["top_k"] * ffn + d * a["num_experts"]
    return attn + ffn


def weight_bytes(a: dict) -> int:
    """Bytes of the served tree read once: matrices in the compute dtype
    (bf16), the router, the norm scales and the output embedding in
    float32 (as the port holds them)."""
    d, hd, L = a["d_model"], a["head_dim"], a["num_layers"]
    attn = d * (a["num_heads"] * hd) * 2 + d * (a["num_kv_heads"] * hd) * 2
    e = a.get("num_experts") or 1
    ffn = 3 * d * a["d_ff"] * e
    router = d * a["num_experts"] * 4 if a.get("num_experts") else 0
    unembed = a["vocab_size"] * d * 4
    return L * ((attn + ffn) * 2 + router + 2 * d * 4) + unembed + d * 4


def train_step_flops(a: dict, rows: int, seq: int) -> int:
    """Model FLOPs of one optimizer step: 6 per parameter a token (the
    layer matrices and the output embedding) plus attention at 3 times
    its forward, counted over the attended keys.  Recomputation is not
    counted."""
    n = a["num_layers"] * layer_matrix_params(a) + a["vocab_size"] * a[
        "d_model"]
    attn = 12 * a["num_layers"] * a["num_heads"] * a["head_dim"] * rows \
        * attended_keys(seq, seq, a.get("window"))
    return 6 * n * rows * seq + attn


def prefill_flops(a: dict, rows: int, seq: int) -> int:
    """Forward FLOPs of a prefill of ``rows`` prompts of ``seq`` tokens:
    the layers over every token, attention over the attended keys, and
    the logits of the last token only (what the port computes)."""
    layers = 2 * a["num_layers"] * layer_matrix_params(a) * rows * seq
    attn = 4 * a["num_layers"] * a["num_heads"] * a["head_dim"] * rows \
        * attended_keys(seq, seq, a.get("window"))
    return layers + attn + 2 * a["vocab_size"] * a["d_model"] * rows


def decode_step(a: dict, rows: int, span: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one decode step of ``rows`` sequences whose
    attention reads ``span`` slots: every weight read once, the k and v
    of the span read in every layer."""
    L, hk, hd = a["num_layers"], a["num_kv_heads"], a["head_dim"]
    flops = 2 * (L * layer_matrix_params(a) + a["vocab_size"]
                 * a["d_model"]) * rows \
        + 4 * L * a["num_heads"] * hd * rows * span
    nbytes = weight_bytes(a) + L * 2 * rows * hk * span * hd * 2
    return flops, nbytes
