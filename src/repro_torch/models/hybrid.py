"""RecurrentGemma / Griffin-style hybrid: RG-LRU recurrent blocks
interleaved with local (sliding-window, MQA) attention in the configured
block pattern (2 recurrent : 1 attention).

The counterpart of the JAX package's ``models/hybrid.py``.  The RG-LRU
recurrence ``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)`` runs
as a log-depth parallel prefix over the sequence for prefill (Hillis-
Steele: ceil(log2 S) steps of ``(a_l a_r, b_l a_r + b_r)``, the
reference's ``lax.associative_scan``) and as one step for decode.  The
attention layers are the decoder's ``attn_block`` under ``cfg.window``:
prefill through the flash kernel, decode through the decode kernel (head
dim 256 and a group of 10 q-heads per KV head at recurrentgemma's
widths).

The parameter tree is the reference's: ``groups/{i}_{kind}`` stacked over
the ``num_layers // len(block_pattern)`` full groups, and one
``tail{j}_{kind}`` (leading axis 1) for each leftover layer of the
pattern's start, so ``models/convert.py`` carries the reference's weights
over unchanged.  Caches mirror it: a recurrent layer's ``{"conv": [.., B,
W-1, R], "h": [.., B, R]}`` in the compute dtype (the raw ``xb`` of the
last W-1 positions, and the state rounded to the compute dtype, as the
reference stores them), an attention layer's ``{"k", "v"}`` [.., B, Hk,
S, Dh] with every prompt position's slot (the reference's prefill returns
them all, whatever the window).  Decode writes every layer's new state
and its key and value into the caches in place and returns them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import causal_conv1d, conv1d_step, rms_norm
from repro_torch.models.sharding import MeshCtx, P
from repro_torch.models.ssm import _conv_state

_LRU_C = 8.0


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _lru_coeffs(p, xc: torch.Tensor):
    """Gates shared by scan and step.  xc: [..., R] (after the conv).
    Returns the float32 decay a and input b."""
    r = torch.sigmoid((xc @ p["wa"].to(xc.dtype)).float())
    i = torch.sigmoid((xc @ p["wi"].to(xc.dtype)).float())
    log_a = -_LRU_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xc.float())
    return a, b


def rg_lru_scan(p, xc: torch.Tensor) -> torch.Tensor:
    """xc: [B, S, R] -> h: [B, S, R] (float32 math, returns xc.dtype): an
    inclusive scan of ``(a_l, b_l) . (a_r, b_r) = (a_l a_r, b_l a_r +
    b_r)`` over S in ceil(log2 S) steps."""
    a, b = _lru_coeffs(p, xc)
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b.to(xc.dtype)


def rg_lru_step(p, xc_t: torch.Tensor, h_prev: torch.Tensor) -> torch.Tensor:
    """xc_t: [B, R]; h_prev: [B, R].  Returns h [B, R] in xc_t's dtype."""
    a, b = _lru_coeffs(p, xc_t)
    return (a * h_prev.float() + b).to(xc_t.dtype)


def rec_block(p, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
              cache: dict | None = None):
    """Griffin recurrent mixer, gated output, then the SwiGLU FFN.
    ``mode`` "prefill" returns the layer's cache {"conv", "h"}; "decode"
    (S = 1) takes it and returns the new one."""
    u = rms_norm(x, p["ln1"])
    gate = F.gelu(u @ p["wy"].to(u.dtype), approximate="tanh")
    xb = u @ p["wx"].to(u.dtype)
    new_cache = cache
    if mode == "decode":
        xc_t, conv_state = conv1d_step(xb[:, 0], cache["conv"], p["conv_w"],
                                       p["conv_b"])
        h = rg_lru_step(p, xc_t, cache["h"])
        new_cache = {"conv": conv_state, "h": h}
        hs = h[:, None]
    else:
        hs = rg_lru_scan(p, causal_conv1d(xb, p["conv_w"], p["conv_b"]))
        if mode == "prefill":
            new_cache = {"conv": _conv_state(xb, p["conv_w"].shape[-1]),
                         "h": hs[:, -1]}
    x = x + (hs * gate) @ p["wo"].to(x.dtype)
    return tfm.dense_ffn_block(p, x), new_cache


def _attn_layer(p, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
                positions, cache: dict, t: int | None):
    x, _ = tfm.attn_block(p, x, cfg, mode=mode, positions=positions,
                          cache=cache, t=t)
    return tfm.dense_ffn_block(p, x)


# ---------------------------------------------------------------------------
# Parameters and caches
# ---------------------------------------------------------------------------

def _rec_shapes(cfg: ArchConfig, n: int) -> dict:
    d, r = cfg.d_model, cfg.lru_width
    return ({"ln1": (n, d), "wx": (n, d, r), "wy": (n, d, r),
             "conv_w": (n, r, cfg.conv_width), "conv_b": (n, r),
             "lam": (n, r), "wa": (n, r, r), "wi": (n, r, r),
             "wo": (n, r, d)}
            | tfm._dense_ffn_shapes(cfg, n))


def _rec_specs(dp) -> dict:
    return ({"ln1": P(None, None), "wx": P(None, dp, "model"),
             "wy": P(None, dp, "model"),
             "conv_w": P(None, "model", None), "conv_b": P(None, "model"),
             "lam": P(None, "model"), "wa": P(None, "model", None),
             "wi": P(None, "model", None), "wo": P(None, "model", dp)}
            | tfm._dense_ffn_specs(dp))


def _pattern_counts(cfg: ArchConfig) -> tuple[int, int]:
    """(full groups, leftover leading-pattern layers)."""
    plen = len(cfg.block_pattern)
    return cfg.num_layers // plen, cfg.num_layers % plen


def hybrid_param_shapes(cfg: ArchConfig) -> dict:
    g, tail = _pattern_counts(cfg)

    def shapes(kind: str, n: int) -> dict:
        return (_rec_shapes(cfg, n) if kind == "rec"
                else tfm._attn_shapes(cfg, n) | tfm._dense_ffn_shapes(cfg, n))

    out = {"embed": (cfg.padded_vocab, cfg.d_model), "ln_f": (cfg.d_model,),
           "groups": {f"{idx}_{kind}": shapes(kind, g)
                      for idx, kind in enumerate(cfg.block_pattern)}}
    for j in range(tail):
        kind = cfg.block_pattern[j]
        out[f"tail{j}_{kind}"] = shapes(kind, 1)
    return out


def hybrid_param_specs(cfg: ArchConfig, mctx: MeshCtx) -> dict:
    dp = mctx.dp if cfg.fsdp else None
    _, tail = _pattern_counts(cfg)

    def specs(kind: str) -> dict:
        return (_rec_specs(dp) if kind == "rec"
                else tfm._attn_specs(dp) | tfm._dense_ffn_specs(dp))

    out = {"embed": P("model", None), "ln_f": P(None),
           "groups": {f"{idx}_{kind}": specs(kind)
                      for idx, kind in enumerate(cfg.block_pattern)}}
    for j in range(tail):
        kind = cfg.block_pattern[j]
        out[f"tail{j}_{kind}"] = specs(kind)
    return out


def init_hybrid_params(cfg: ArchConfig, generator: torch.Generator,
                       device=None, dtype: torch.dtype | None = None
                       ) -> dict:
    """The hybrid tree, drawn as ``transformer._init_from_shapes`` draws."""
    return tfm._init_from_shapes(hybrid_param_shapes(cfg), cfg, generator,
                                 device, dtype)


def _cache_tree(cfg: ArchConfig, batch: int, n_slots: int) -> dict:
    g, tail = _pattern_counts(cfg)
    r = cfg.lru_width

    def shapes(kind: str, lead: tuple) -> dict:
        if kind == "rec":
            return {"conv": lead + (batch, cfg.conv_width - 1, r),
                    "h": lead + (batch, r)}
        kv = lead + (batch, cfg.num_kv_heads, n_slots, cfg.head_dim)
        return {"k": kv, "v": kv}

    caches = {"groups": {f"{idx}_{kind}": shapes(kind, (g,))
                         for idx, kind in enumerate(cfg.block_pattern)}}
    for j in range(tail):
        kind = cfg.block_pattern[j]
        caches[f"tail{j}_{kind}"] = shapes(kind, ())
    return caches


def hybrid_cache_shapes(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """The reference's decode cache tree: a ring of min(window, seq_len)
    slots per attention layer."""
    return _cache_tree(cfg, batch, min(cfg.window, seq_len))


def hybrid_cache_specs(cfg: ArchConfig, mctx: MeshCtx,
                       seq_len: int = 0) -> dict:
    dp = mctx.dp
    r_ax = "model" if cfg.lru_width % mctx.tp_size == 0 else None
    n_slots = min(cfg.window, seq_len) if seq_len else cfg.window
    _, tail = _pattern_counts(cfg)

    def specs(kind: str, lead_dims: int) -> dict:
        lead = (None,) * lead_dims
        if kind == "rec":
            return {"conv": P(*lead, dp, None, r_ax), "h": P(*lead, dp, r_ax)}
        kv = tfm.kv_spec(cfg, mctx, n_slots, lead_dims=lead_dims)
        return {"k": kv, "v": kv}

    out = {"groups": {f"{idx}_{kind}": specs(kind, 1)
                      for idx, kind in enumerate(cfg.block_pattern)}}
    for j in range(tail):
        kind = cfg.block_pattern[j]
        out[f"tail{j}_{kind}"] = specs(kind, 0)
    return out


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------

def _apply_block(kind: str, p, x: torch.Tensor, cfg: ArchConfig, mode: str,
                 positions, cache: dict | None, t: int | None
                 ) -> torch.Tensor:
    """One layer; its cache (views into the stacked caches) is updated in
    place ("train" has none)."""
    if kind == "rec":
        x, new = rec_block(p, x, cfg, mode=mode,
                           cache=cache if mode == "decode" else None)
        for k, c in (cache or {}).items():
            c.copy_(new[k])
        return x
    return _attn_layer(p, x, cfg, mode=mode, positions=positions,
                       cache=cache, t=t)


def _run_hybrid(params, x: torch.Tensor, cfg: ArchConfig, mode: str,
                positions, caches: dict | None, t: int | None = None
                ) -> torch.Tensor:
    """The full groups in turn, each group's layers in sorted key order,
    then the tail layers (the reference's ``_run_hybrid``).  "train" takes
    no caches and runs each group index under ``remat``, as the reference
    checkpoints its scanned group body (the tail layers are not)."""
    names = sorted(params["groups"])
    groups = {name: tfm._layers(params["groups"][name]) for name in names}

    def body(x, gp, gcache):
        for name in names:
            x = _apply_block(name.split("_")[1], gp[name], x, cfg, mode,
                             positions,
                             None if gcache is None else gcache[name], t)
        return x

    for i in range(len(groups[names[0]])):
        gp = {name: groups[name][i] for name in names}
        if caches is None:
            x = tfm.remat(cfg, body, x, gp, None)
        else:
            x = body(x, gp, {name: tfm._index(caches["groups"][name], i)
                             for name in names})
    for key in sorted(k for k in params if k.startswith("tail")):
        x = _apply_block(key.split("_")[1], tfm._index(params[key], 0), x,
                         cfg, mode, positions,
                         None if caches is None else caches[key], t)
    return x


def _logits(params, x_last: torch.Tensor) -> torch.Tensor:
    """float32 logits [B, V] against the tied embedding."""
    return x_last.float() @ params["embed"].T.float()


def hybrid_loss(params, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """The training loss (float32 scalar) of ``batch["tokens"]`` [B, S]:
    the stack in "train" mode, then the next-token cross-entropy against
    the tied embedding."""
    tokens = batch["tokens"]
    x = tfm._embed_tokens(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)
    x = _run_hybrid(params, x, cfg, "train", positions, None)
    x = rms_norm(x, params["ln_f"])
    return tfm.next_token_loss(x, tokens, params["embed"].T, cfg)


def hybrid_prefill(params, batch: dict, cfg: ArchConfig):
    """batch["tokens"]: [B, S] ids.  Returns (last-token logits [B, V]
    float32, caches with S slots per attention layer)."""
    tokens = batch["tokens"]
    x = tfm._embed_tokens(params, tokens, cfg)
    b, s, _ = x.shape
    caches = tfm._alloc(_cache_tree(cfg, b, s), x)
    positions = torch.arange(s, device=x.device)
    x = _run_hybrid(params, x, cfg, "prefill", positions, caches)
    return _logits(params, rms_norm(x[:, -1], params["ln_f"])), caches


def hybrid_decode_step(params, caches: dict, tokens: torch.Tensor, t: int,
                       cfg: ArchConfig):
    """tokens: [B, 1] new token ids at absolute position ``t`` (an int).
    Writes the new states, keys and values into ``caches`` in place.
    Returns (logits [B, V] float32, caches)."""
    x = tfm._embed_tokens(params, tokens, cfg)
    positions = torch.arange(t, t + 1, device=x.device)
    x = _run_hybrid(params, x, cfg, "decode", positions, caches, t=t)
    return _logits(params, rms_norm(x[:, -1], params["ln_f"])), caches
