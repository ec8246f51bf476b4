"""Decoder-only dense transformer: prefill and KV-cache decode.

The parameter tree is the JAX package's (``models/transformer.py``), key
for key and shape for shape: layers stacked on a leading axis under
``params["layers"]["dense0"]`` (``wq`` is ``[L, d_model, H*Dh]``), so one
tree carries across by a tree map.  The stack runs as a Python loop over
that axis (PyTorch runs eagerly; the reference's ``lax.scan``).  One GPU
needs no mesh, so the reference's sharding constraints have no
counterpart here.

Weights may be held in the config's ``param_dtype`` (float32) and are cast
to the compute dtype per use, as the reference does; ``cast_params``
makes those casts once, which gives the same bf16 values.

Caches are ``{"dense0": {"k", "v"}}`` of ``[L, B, Hk, S, Dh]``.  Prefill
fills them; decode writes slot ``t`` in place (the reference returns a
new cache; the port updates the one it is given and returns it).

Only full causal self-attention is ported: a config with ``window`` or
``chunk_attn`` (ring-buffer caches) raises, see ROADMAP queue 1.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (chunked_attention, decode_attention,
                                       rms_norm, rotary, swiglu)

MATRICES = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def kv_cache_len(cfg: ArchConfig, seq_len: int) -> int:
    """Slots the decode KV cache needs for a context of ``seq_len``: all
    of them under full attention, the only kind ported (a window or chunk
    would cap it, with the ring cache of ROADMAP queue 1)."""
    return seq_len


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP queue 1 lists it); the port runs dense decoders")
    if cfg.window is not None or cfg.chunk_attn is not None:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window / chunked attention with a ring "
            f"cache is not ported yet (ROADMAP queue 1)")
    if cfg.padded_heads != cfg.num_heads:
        raise NotImplementedError(
            f"{cfg.name}: head padding is an XLA layout knob the port does "
            f"not take")


# ---------------------------------------------------------------------------
# Attention block (pre-norm residual)
# ---------------------------------------------------------------------------

def _qkv(p, h: torch.Tensor, cfg: ArchConfig):
    b, s, _ = h.shape
    dt = h.dtype
    q = (h @ p["wq"].to(dt)).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = (h @ p["wk"].to(dt)).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (h @ p["wv"].to(dt)).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def attn_block(p, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
               positions: torch.Tensor, cache: dict, t: int | None = None,
               valid_len: torch.Tensor | None = None):
    """Returns (x + attn_out, cache).  ``cache`` {"k", "v"} [B, Hk, S, Dh]
    is written in place: prefill fills its first Sq slots, decode writes
    slot ``t % S`` and attends to ``valid_len`` (default ``min(t+1, S)``)
    slots.  ``mode`` is "prefill" or "decode"."""
    _check_supported(cfg)
    h = rms_norm(x, p["ln1"])
    b, s, _ = x.shape
    q, k, v = _qkv(p, h, cfg)
    q = rotary(q, positions, cfg.rope_theta)
    k = rotary(k, positions, cfg.rope_theta)
    if mode == "decode":
        n_slots = cache["k"].shape[2]
        slot = t % n_slots
        cache["k"][:, :, slot] = k[:, 0]
        cache["v"][:, :, slot] = v[:, 0]
        if valid_len is None:
            valid_len = min(t + 1, n_slots)
        o = decode_attention(q.transpose(1, 2), cache["k"], cache["v"],
                             valid_len)
    elif mode == "prefill":
        cache["k"][:, :, :s] = k.transpose(1, 2)
        cache["v"][:, :, :s] = v.transpose(1, 2)
        # q stays a [B, S, H, Dh] buffer seen as [B, H, S, Dh]; the output
        # has the same layout, so the transpose back below is free
        o = chunked_attention(q.transpose(1, 2), cache["k"][:, :, :s],
                              cache["v"][:, :, :s], causal=True)
    else:
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    o = o.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.head_dim)
    return x + o @ p["wo"].to(x.dtype), cache


def dense_ffn_block(p, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln2"])
    return x + swiglu(h, p["wg"], p["wu"], p["wd"])


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def decoder_param_shapes(cfg: ArchConfig) -> dict:
    _check_supported(cfg)
    d, hd, f, n = cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.num_layers
    layer = {
        "ln1": (n, d),
        "wq": (n, d, cfg.num_heads * hd),
        "wk": (n, d, cfg.num_kv_heads * hd),
        "wv": (n, d, cfg.num_kv_heads * hd),
        "wo": (n, cfg.num_heads * hd, d),
        "ln2": (n, d), "wg": (n, d, f), "wu": (n, d, f), "wd": (n, f, d),
    }
    shapes: dict = {"embed": (cfg.padded_vocab, d), "ln_f": (d,),
                    "layers": {"dense0": layer}}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (d, cfg.padded_vocab)
    return shapes


def _leaves(tree: dict, prefix: tuple = ()):
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _set(tree: dict, path: tuple, val) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = val


def init_decoder_params(cfg: ArchConfig, generator: torch.Generator,
                        device=None) -> dict:
    """The reference's initialisation: every leaf of two or more
    dimensions N(0, 0.02) in float32 then cast to ``param_dtype``, every
    1-D leaf ones.  (By that rule the stacked per-layer norm scales
    ``ln1``/``ln2`` [L, d] are drawn, as in the reference.)  Leaves are
    drawn in sorted-path order from ``generator``, on ``device`` (the
    generator's device by default)."""
    device = generator.device if device is None else device
    dtype = getattr(torch, cfg.param_dtype)
    params: dict = {}
    for path, shape in _leaves(decoder_param_shapes(cfg)):
        if len(shape) >= 2:
            leaf = torch.randn(shape, generator=generator,
                               dtype=torch.float32, device=device)
            leaf = leaf.mul_(0.02).to(dtype)
        else:
            leaf = torch.ones(shape, dtype=dtype, device=device)
        _set(params, path, leaf)
    return params


def cast_params(params: dict, cfg: ArchConfig) -> dict:
    """A tree whose layer matrices are in the compute dtype, cast once
    (bit-identical to the reference's cast per use).  Norm scales and the
    embedding stay as they are: the norms scale in float32 and the logits
    are taken against the float32 embedding."""
    dt = getattr(torch, cfg.compute_dtype)
    out: dict = {}
    for path, leaf in _leaves(params):
        _set(out, path, leaf.to(dt) if path[-1] in MATRICES else leaf)
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def decoder_cache_shapes(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """KV-cache tree shapes matching the stacked layer layout."""
    _check_supported(cfg)
    kv = (cfg.num_layers, batch, cfg.num_kv_heads,
          kv_cache_len(cfg, seq_len), cfg.head_dim)
    return {"dense0": {"k": kv, "v": kv}}


def _embed_tokens(params, tokens: torch.Tensor, cfg: ArchConfig):
    return params["embed"][tokens].to(getattr(torch, cfg.compute_dtype))


def _logits(params, x_last: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """float32 logits [B, V] of the final hidden states [B, d]."""
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x_last.float() @ unembed.float()


def _run_stack(params, x, cfg: ArchConfig, mode: str, positions, caches,
               t=None, valid_len=None):
    lp = params["layers"]["dense0"]
    lc = caches["dense0"]
    for i in range(cfg.num_layers):
        p = {name: w[i] for name, w in lp.items()}
        x, _ = attn_block(p, x, cfg, mode=mode, positions=positions,
                          cache={"k": lc["k"][i], "v": lc["v"][i]}, t=t,
                          valid_len=valid_len)
        x = dense_ffn_block(p, x)
    return x


def decoder_prefill(params, batch: dict, cfg: ArchConfig):
    """batch["tokens"]: [B, S] ids.  Returns (last-token logits [B, V]
    float32, caches with exactly S slots)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed_tokens(params, tokens, cfg)
    shapes = decoder_cache_shapes(cfg, b, s)
    caches = {name: {kv: torch.empty(shp, dtype=x.dtype, device=x.device)
                     for kv, shp in group.items()}
              for name, group in shapes.items()}
    positions = torch.arange(s, device=x.device)
    x = _run_stack(params, x, cfg, "prefill", positions, caches)
    x = rms_norm(x[:, -1], params["ln_f"])
    return _logits(params, x, cfg), caches


def decoder_decode_step(params, caches, tokens: torch.Tensor, t: int,
                        cfg: ArchConfig):
    """tokens: [B, 1] new token ids at absolute position ``t``.  Writes the
    new keys and values into ``caches`` in place.  Returns (logits [B, V]
    float32, caches)."""
    x = _embed_tokens(params, tokens, cfg)
    b = x.shape[0]
    n_slots = caches["dense0"]["k"].shape[3]
    positions = torch.arange(t, t + 1, device=x.device)
    valid_len = torch.full((b,), min(t + 1, n_slots), dtype=torch.int32,
                           device=x.device)
    x = _run_stack(params, x, cfg, "decode", positions, caches, t=t,
                   valid_len=valid_len)
    x = rms_norm(x[:, -1], params["ln_f"])
    return _logits(params, x, cfg), caches
