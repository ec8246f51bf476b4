"""Decoder-only transformer (dense, MoE and VLM) and the Whisper-style
encoder-decoder: the training loss, prefill and KV-cache decode.

The parameter tree is the JAX package's (``models/transformer.py``), key
for key and shape for shape: layers stacked on a leading axis in layer
groups under ``params["layers"]`` — ``"dense0"`` for a dense model, one
group ``"moe"`` for an all-MoE model (mixtral), and ``"dense0"`` ..
``"dense{p-2}"`` plus ``"moe"`` when every ``moe_period``-th layer is MoE
(llama4) — so one tree carries across by a tree map.  The stack runs as
a Python loop over the groups' leading axis, the group's layers in
sorted key order (the reference's ``lax.scan`` over ``_group_body``).

Across ranks (a ``MeshCtx`` over the ranks of a process group, or a
``CountingMesh``), the decoder's loss, prefill and decode run as the
reference's GSPMD program runs on its mesh, rank by rank: each rank holds
its blocks of the parameters (``decoder_param_specs``: every layer matrix
over ``model`` and FSDP over the data axes, the embedding's vocab rows
over ``model``), of the caches (``kv_spec``) and of the batch (split over
the data axes where they divide it, whole on every rank otherwise), and
issues the collectives GSPMD inserts: per layer the FSDP all-gathers of
the layer's matrices over the data axes (``sharding.relayout``; dropped
after the layer), a vocab-parallel embedding (one psum over ``model``),
column-parallel ``wq``/``wk``/``wv``/``wg``/``wu`` (this rank's q heads)
and row-parallel ``wo``/``wd`` (a psum over ``model`` each), and this
rank's block of the logits ``P(dp, "model")`` (the loss: a vocab-parallel
cross-entropy, its sums psummed over ``model`` and over the data axes).
Under autograd the collectives run their transposes backward
(``models/sharding.py``); the normed input of every column-parallel
product enters through ``pvary``.  Where the reference pins GSPMD's
layout of q, k and v (``_attn_constraints``), the port lays its blocks
out itself, by ``cfg.attn_shard`` (``_Ranks``): "auto" as above; "heads"
whole q heads on each rank, the ceiling of their count over ``model``
(the reference's GSPMD padding of an uneven count), ``wo`` gathered
whole; "seq" (prefill and training; decode runs as "auto")
context-parallel attention: ``wq``/``wk``/``wv``/``wo`` gathered whole,
each rank the queries of its block of positions over ``model`` with
every head, keys and values from position 0 to its block's end, its rows
of ``o @ wo`` gathered over ``model`` along the sequence
(``Mesh.all_gather_invariant``).  The enc-dec's loss, prefill and decode
run across ranks the same way (``_encdec_loss_ranked``,
``_encdec_ranked``: the encoder on this rank's rows and heads, the cross
caches laid out by ``kv_spec`` over ``enc_seq``), and so do the SSM's
and the hybrid's (``ssm.py``, ``hybrid.py``), on the same ``_Ranks``
layout, which takes each family's stored spec tree.

Weights may be held in the config's ``param_dtype`` (float32) and are cast
to the compute dtype per use, as the reference does; ``cast_params``
makes those casts once, which gives the same bf16 values, and
``init_decoder_params(..., dtype=)`` draws the layer matrices straight
into the compute dtype, slice by slice, for models whose float32 tree
would not fit the card.

Caches are ``{group: {"k", "v"}}`` of ``[L_group, B, Hk, S, Dh]``.
Prefill fills S slots (as the reference returns them, whatever the
window or chunk); decode writes slot ``t % S`` in place (the reference
returns a new cache; the port updates the one it is given and returns
it) and masks by each slot's absolute position under the sliding window
and llama4's local chunk (``layers.decode_attention``).

A VLM (internvl2) is the decoder with ``img_proj`` [1024, d]: the image
embeddings ``batch["img_emb"]`` [B, img_tokens, 1024] are projected and
put before the token embeddings, and positions run over the whole
sequence, so the prefill fills ``img_tokens + S`` slots.

The encoder-decoder (whisper) has its own tree (``encdec_param_shapes``:
``enc_layers``, ``dec_layers`` with the cross-attention weights under
``x_*``, ``frame_proj``, ``ln_enc``): the encoder projects
``batch["frames"]`` [B, enc_seq, 1024], adds sinusoid positions and runs
non-causal self-attention without rotary and a SwiGLU FFN per layer;
each decoder layer runs causal self-attention with rotary, then
cross-attention over the encoder output (no rotary, not causal), then a
SwiGLU FFN.  Caches are ``{"self": {"k", "v"}, "cross_k", "cross_v"}``,
the cross caches ``[L, B, Hk, enc_seq, Dh]`` filled by the prefill and
attended whole at every decode step.  The SSM and hybrid families have
their own modules (``ssm.py``, ``hybrid.py``), built from this one's
blocks, initialisation and helpers.

Head padding (``cfg.pad_heads_to``): ``wq`` has ``padded_heads`` heads,
group-major (each KV group's pad heads last, so the GQA mapping of q to
KV heads is unchanged), attention runs over all of them, and the pad
heads' outputs are dropped before ``wo`` (``_real_heads``), as in the
reference; across ranks each rank takes whole padded heads.

Training (``decoder_loss``, ``encdec_loss``): the reference's losses,
next-token cross-entropy over the text positions through
``layers.chunked_softmax_xent``.  The float32 parameters stay the leaves
autograd differentiates; every matrix is cast to the compute dtype where
it is used, inside the layer, so under ``cfg.remat`` (each layer run
under ``torch.utils.checkpoint``, the reference's ``jax.checkpoint``) the
bf16 copies are recomputed in the backward pass, not kept; under
``remat="dots"`` the decoder stack keeps the outputs of the products
without a batch dimension (``aten.mm``: the projections, the FFN, the
router and ``o @ wo``) and recomputes the rest (the attention, the
expert products), the reference's ``dots_with_no_batch_dims_saveable``;
the other families' stacks recompute everything under "dots", as the
reference's do.  A stacked
leaf is split into its layers once per forward (``_layers``:
``torch.unbind``), so its gradient is stacked once, not summed into a
zero tensor of the whole leaf at every layer.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (chunked_attention,
                                       chunked_softmax_xent, decode_attention,
                                       rms_norm, rotary, sinusoid_positions,
                                       swiglu)
from repro_torch.models.moe import (moe_ffn, moe_in_specs, moe_param_shapes,
                                    moe_param_specs)
from repro_torch.models.sharding import MeshCtx, P, relayout

VIT_STUB_DIM = 1024     # the VLM/audio frontend stubs emit this width

# leaves held in the compute dtype: the layer, cross-attention, expert and
# frontend-projection matrices, mamba2's projections and the RG-LRU's
# (norm scales, the router, the embedding, and the SSM's and RG-LRU's conv
# filters, decays and biases, which the reference uses in float32, stay in
# param_dtype)
MATRICES = ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "sh_wg", "sh_wu",
            "sh_wo", "x_wq", "x_wk", "x_wv", "x_wo", "img_proj", "frame_proj",
            "wz", "wxbc", "wdt", "out_proj", "wx", "wy", "wa", "wi")


def kv_cache_len(cfg: ArchConfig, seq_len: int) -> int:
    """Slots the decode KV cache needs for a context of ``seq_len``."""
    if cfg.chunk_attn is not None:
        return min(cfg.chunk_attn, seq_len)
    if cfg.window is not None:
        return min(cfg.window, seq_len)
    return seq_len


DECODER_FAMILIES = ("dense", "moe", "vlm")


def _check_supported(cfg: ArchConfig,
                     families: tuple = DECODER_FAMILIES) -> None:
    if cfg.family not in families:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} does not run on these entry "
            f"points (they take {', '.join(families)}; models.get_model "
            f"picks a family's own)")
    if cfg.padded_heads < cfg.num_heads or cfg.num_kv_heads and (
            cfg.padded_heads % cfg.num_kv_heads
            or cfg.num_heads % cfg.num_kv_heads):
        raise ValueError(
            f"{cfg.name}: {cfg.padded_heads} padded q heads for "
            f"{cfg.num_heads} q heads on {cfg.num_kv_heads} KV heads: the "
            f"padding is group-major")


# ---------------------------------------------------------------------------
# Attention block (pre-norm residual)
# ---------------------------------------------------------------------------

def _qkv(p, h: torch.Tensor, cfg: ArchConfig):
    b, s, _ = h.shape
    dt = h.dtype
    q = (h @ p["wq"].to(dt)).reshape(b, s, cfg.padded_heads, cfg.head_dim)
    k = (h @ p["wk"].to(dt)).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (h @ p["wv"].to(dt)).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _real_index(cfg: ArchConfig, j: int) -> int | None:
    """The head of ``num_heads`` that padded q head ``j`` is (None for a
    pad head): padding is group-major, ``padded_heads // Hk`` heads a KV
    group, the group's first ``num_heads // Hk`` real."""
    kvh = max(cfg.num_kv_heads, 1)
    gp, gr = cfg.padded_heads // kvh, cfg.num_heads // kvh
    return None if j % gp >= gr else j // gp * gr + j % gp


def _real_heads(o: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """o [B, padded_heads, S, Dh] without its pad heads: [B, num_heads, S,
    Dh] (itself without padding)."""
    if cfg.padded_heads == cfg.num_heads:
        return o
    kvh = max(cfg.num_kv_heads, 1)
    b, _, s, dh = o.shape
    return o.reshape(b, kvh, cfg.padded_heads // kvh, s, dh)[
        :, :, :cfg.num_heads // kvh].reshape(b, cfg.num_heads, s, dh)


def attn_block(p, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
               positions: torch.Tensor | None = None,
               cache: dict | None = None, t: int | None = None,
               use_rotary: bool = True, causal: bool = True,
               kv_override: tuple | None = None):
    """Returns (x + attn_out, cache).  ``mode`` is "prefill", "decode" or
    "train".  Self-attention: ``cache`` {"k", "v"} [B, Hk, S, Dh] is
    written in place: prefill fills its first Sq slots, decode writes slot
    ``t % S`` and attends to the slots the position mask leaves at ``t``
    under ``cfg.window`` and ``cfg.chunk_attn``; "train" keeps no cache
    (the training pass, and the encoder: ``causal=False``,
    ``use_rotary=False``).
    Cross-attention (``kv_override``, the encoder's keys and values
    [B, Hk, enc_seq, Dh]): q from ``h @ wq`` without rotary, not causal;
    decode attends every encoder slot, at ``t = enc_seq - 1`` as the
    reference does.  The probabilities enter the P V product in float32
    or, with ``cfg.attn_f32_scores`` False, in the compute dtype; the pad
    heads of ``cfg.pad_heads_to`` are dropped before ``wo``."""
    h = rms_norm(x, p["ln1"])
    b, s, _ = x.shape
    f32 = cfg.attn_f32_scores
    if kv_override is not None:
        q = (h @ p["wq"].to(h.dtype)).reshape(b, s, cfg.padded_heads,
                                             cfg.head_dim)
        k, v = kv_override
        if mode == "decode":
            o = decode_attention(q.transpose(1, 2), k, v, None,
                                 k.shape[2] - 1)
        else:
            o = chunked_attention(q.transpose(1, 2), k, v, causal=False,
                                  window=cfg.window,
                                  chunk_attn=cfg.chunk_attn, f32_stats=f32)
    else:
        q, k, v = _qkv(p, h, cfg)
        if use_rotary:
            q = rotary(q, positions, cfg.rope_theta)
            k = rotary(k, positions, cfg.rope_theta)
        if mode == "decode":
            slot = t % cache["k"].shape[2]
            cache["k"][:, :, slot] = k[:, 0]
            cache["v"][:, :, slot] = v[:, 0]
            o = decode_attention(q.transpose(1, 2), cache["k"], cache["v"],
                                 None, t, window=cfg.window,
                                 chunk_attn=cfg.chunk_attn)
        elif mode == "prefill":
            cache["k"][:, :, :s] = k.transpose(1, 2)
            cache["v"][:, :, :s] = v.transpose(1, 2)
            # q stays a [B, S, H, Dh] buffer seen as [B, H, S, Dh]; the
            # output has the same layout, so the transpose back is free
            o = chunked_attention(q.transpose(1, 2), cache["k"][:, :, :s],
                                  cache["v"][:, :, :s], causal=causal,
                                  window=cfg.window,
                                  chunk_attn=cfg.chunk_attn, f32_stats=f32)
        elif mode == "train":
            o = chunked_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=cfg.window,
                                  chunk_attn=cfg.chunk_attn, f32_stats=f32)
        else:
            raise ValueError(f"mode must be 'prefill', 'decode' or "
                             f"'train', got {mode!r}")
    o = _real_heads(o, cfg).transpose(1, 2).reshape(
        b, s, cfg.num_heads * cfg.head_dim)
    return x + o @ p["wo"].to(x.dtype), cache


def dense_ffn_block(p, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln2"])
    return x + swiglu(h, p["wg"], p["wu"], p["wd"])


def moe_ffn_block(p, x: torch.Tensor, cfg: ArchConfig,
                  mctx: MeshCtx | None = None, *,
                  global_batch: int | None = None) -> torch.Tensor:
    h = rms_norm(x, p["ln2"])
    return x + moe_ffn(p["moe"], h, cfg, mctx, global_batch=global_batch)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _attn_shapes(cfg: ArchConfig, n: int) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "ln1": (n, d),
        "wq": (n, d, cfg.padded_heads * hd),
        "wk": (n, d, cfg.num_kv_heads * hd),
        "wv": (n, d, cfg.num_kv_heads * hd),
        "wo": (n, cfg.num_heads * hd, d),
    }


def _dense_ffn_shapes(cfg: ArchConfig, n: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"ln2": (n, d), "wg": (n, d, f), "wu": (n, d, f), "wd": (n, f, d)}


def _moe_ffn_shapes(cfg: ArchConfig, n: int) -> dict:
    return {"ln2": (n, cfg.d_model), "moe": moe_param_shapes(cfg, n)}


def _layer_group_shapes(cfg: ArchConfig) -> dict:
    """Shape tree of the stacked layer groups (the reference's)."""
    if cfg.num_experts and cfg.moe_period > 1:
        n = cfg.num_layers // cfg.moe_period
        group: dict = {}
        for j in range(cfg.moe_period - 1):
            group[f"dense{j}"] = _attn_shapes(cfg, n) | _dense_ffn_shapes(cfg, n)
        group["moe"] = _attn_shapes(cfg, n) | _moe_ffn_shapes(cfg, n)
        return group
    n = cfg.num_layers
    if cfg.num_experts:
        return {"moe": _attn_shapes(cfg, n) | _moe_ffn_shapes(cfg, n)}
    return {"dense0": _attn_shapes(cfg, n) | _dense_ffn_shapes(cfg, n)}


def decoder_param_shapes(cfg: ArchConfig) -> dict:
    _check_supported(cfg)
    d = cfg.d_model
    shapes: dict = {"embed": (cfg.padded_vocab, d), "ln_f": (d,),
                    "layers": _layer_group_shapes(cfg)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (d, cfg.padded_vocab)
    if cfg.family == "vlm":
        shapes["img_proj"] = (VIT_STUB_DIM, d)
    return shapes


def _attn_specs(dp) -> dict:
    return {"ln1": P(None, None),
            "wq": P(None, dp, "model"), "wk": P(None, dp, "model"),
            "wv": P(None, dp, "model"), "wo": P(None, "model", dp)}


def _dense_ffn_specs(dp) -> dict:
    return {"ln2": P(None, None), "wg": P(None, dp, "model"),
            "wu": P(None, dp, "model"), "wd": P(None, "model", dp)}


def decoder_param_specs(cfg: ArchConfig, mctx: MeshCtx) -> dict:
    """The reference's layout of the decoder's tree: layer matrices over
    ``model`` and FSDP over the data axes (``cfg.fsdp``), the embedding's
    vocab rows over ``model``."""
    dp = mctx.dp if cfg.fsdp else None
    layers: dict = {}
    for name in _layer_group_shapes(cfg):
        if name.startswith("dense"):
            layers[name] = _attn_specs(dp) | _dense_ffn_specs(dp)
        else:
            layers[name] = _attn_specs(dp) | {
                "ln2": P(None, None), "moe": moe_param_specs(cfg, dp)}
    specs: dict = {"embed": P("model", None), "ln_f": P(None),
                   "layers": layers}
    if not cfg.tie_embeddings:
        specs["unembed"] = P(None, "model")
    if cfg.family == "vlm":
        specs["img_proj"] = P(None, None)
    return specs


def encdec_param_shapes(cfg: ArchConfig) -> dict:
    """The reference's enc-dec tree: stacked encoder layers (attention and
    SwiGLU FFN) and decoder layers (self-attention, cross-attention under
    ``x_*``, SwiGLU FFN)."""
    _check_supported(cfg, ("encdec",))
    d = cfg.d_model
    ne, nd = cfg.enc_layers, cfg.num_layers
    enc = _attn_shapes(cfg, ne) | _dense_ffn_shapes(cfg, ne)
    dec = (_attn_shapes(cfg, nd)
           | {f"x_{k}": v for k, v in _attn_shapes(cfg, nd).items()}
           | _dense_ffn_shapes(cfg, nd))
    return {"embed": (cfg.padded_vocab, d),
            "frame_proj": (VIT_STUB_DIM, d),
            "enc_layers": enc, "dec_layers": dec,
            "ln_enc": (d,), "ln_f": (d,),
            "unembed": (d, cfg.padded_vocab)}


def encdec_param_specs(cfg: ArchConfig, mctx: MeshCtx) -> dict:
    dp = mctx.dp if cfg.fsdp else None
    enc = _attn_specs(dp) | _dense_ffn_specs(dp)
    dec = (_attn_specs(dp)
           | {f"x_{k}": v for k, v in _attn_specs(dp).items()}
           | _dense_ffn_specs(dp))
    return {"embed": P("model", None), "frame_proj": P(None, None),
            "enc_layers": enc, "dec_layers": dec,
            "ln_enc": P(None), "ln_f": P(None),
            "unembed": P(None, "model")}


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
                        device=None, dtype: torch.dtype | None = None,
                        blocks: dict | None = None) -> dict:
    """The decoder's tree, drawn as ``_init_from_shapes`` draws."""
    return _init_from_shapes(decoder_param_shapes(cfg), cfg, generator,
                             device, dtype, blocks)


def init_encdec_params(cfg: ArchConfig, generator: torch.Generator,
                       device=None, dtype: torch.dtype | None = None,
                       blocks: dict | None = None) -> dict:
    """The enc-dec tree, drawn as ``_init_from_shapes`` draws."""
    return _init_from_shapes(encdec_param_shapes(cfg), cfg, generator,
                             device, dtype, blocks)


def leaf_dtype(name: str, cfg: ArchConfig,
               dtype: torch.dtype | None = None) -> torch.dtype:
    """The dtype the init holds leaf ``name`` in: ``dtype`` for the
    ``MATRICES`` leaves when it is given, else the config's
    ``param_dtype``."""
    if dtype is not None and name in MATRICES:
        return dtype
    return getattr(torch, cfg.param_dtype)


def _init_from_shapes(shapes: dict, cfg: ArchConfig,
                      generator: torch.Generator, device, dtype,
                      blocks: dict | None = None) -> dict:
    """The reference's initialisation: every leaf of two or more
    dimensions N(0, 0.02) drawn in float32, every 1-D leaf ones.  (By that
    rule the stacked per-layer norm scales ``ln1``/``ln2`` [L, d] are
    drawn, as in the reference.)  Leaves are drawn in sorted-path order
    from ``generator``, on ``device`` (the generator's device by default),
    a leaf of three or more dimensions one matrix at a time (a layer's, or
    a layer's expert's), so the float32 draw never exceeds one matrix.
    Leaves are held in ``param_dtype``; with ``dtype`` given, the
    ``MATRICES`` leaves are held in it instead, which gives the tree
    ``cast_params`` makes from the float32 one, bit for bit, at the peak
    memory of the cast tree.  ``blocks`` (a path's ``NamedSharding`` on a
    mesh over ranks, ``convert.moe_shardings``) keeps only this rank's
    block of those leaves: every matrix is still drawn, so the tree equals
    the global one's blocks, bit for bit."""
    device = generator.device if device is None else device
    params: dict = {}
    for path, shape in _leaves(shapes):
        ldt = leaf_dtype(path[-1], cfg, dtype)
        if len(shape) == 1:
            _set(params, path, torch.ones(shape, dtype=ldt, device=device))
            continue
        index = (blocks or {}).get(path)
        index = index.index(shape) if index else tuple(
            slice(0, n) for n in shape)
        leaf = torch.empty([i.stop - i.start for i in index], dtype=ldt,
                           device=device)
        for lead in np.ndindex(*shape[:-2]):
            mat = torch.randn(shape[-2:], generator=generator,
                              dtype=torch.float32, device=device).mul_(0.02)
            if all(i.start <= j < i.stop for i, j in zip(index, lead)):
                at = tuple(j - i.start for i, j in zip(index, lead))
                leaf[at].copy_(mat[index[-2], index[-1]])
        _set(params, path, leaf)
    return params


def cast_params(params: dict, cfg: ArchConfig) -> dict:
    """A tree whose layer matrices are in the compute dtype, cast once
    (bit-identical to the reference's cast per use).  Norm scales, the
    router and the embedding stay as they are: the norms scale in float32,
    the router runs in float32 and the logits are taken against the
    float32 embedding."""
    dt = getattr(torch, cfg.compute_dtype)
    out: dict = {}
    for path, leaf in _leaves(params):
        _set(out, path, leaf.to(dt) if path[-1] in MATRICES else leaf)
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def kv_shapes(cfg: ArchConfig, batch: int, n_slots: int) -> dict:
    """KV-cache tree shapes matching the stacked layer groups, ``n_slots``
    slots per layer."""
    return {name: {kv: (shapes["ln1"][0], batch, cfg.num_kv_heads, n_slots,
                        cfg.head_dim) for kv in ("k", "v")}
            for name, shapes in _layer_group_shapes(cfg).items()}


def decoder_cache_shapes(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """The decode cache: a ring of ``kv_cache_len`` slots per layer (the
    reference's)."""
    _check_supported(cfg)
    return kv_shapes(cfg, batch, kv_cache_len(cfg, seq_len))


def kv_spec(cfg: ArchConfig, mctx: MeshCtx, n_slots: int,
            lead_dims: int = 1) -> P:
    """Pick the model-axis placement for a KV cache [*, B, K, S, Dh]:
    shard heads when they divide the axis, else the slot (sequence) dim —
    split-KV decode, FlashDecoding-style."""
    lead = (None,) * lead_dims
    tp = mctx.tp_size
    if cfg.num_kv_heads % tp == 0:
        return P(*lead, mctx.dp, "model", None, None)
    if n_slots % tp == 0:
        return P(*lead, mctx.dp, None, "model", None)
    return P(*lead, mctx.dp, None, None, None)


def decoder_cache_specs(cfg: ArchConfig, mctx: MeshCtx,
                        seq_len: int = 0) -> dict:
    n_slots = kv_cache_len(cfg, seq_len) if seq_len else 0
    spec = kv_spec(cfg, mctx, n_slots)
    return {name: {"k": spec, "v": spec} for name in _layer_group_shapes(cfg)}


def _embed_tokens(params, tokens: torch.Tensor, cfg: ArchConfig):
    """The tokens' rows of the embedding in the compute dtype.  Under a
    gradient the table is cast first, as the reference casts it, so the
    rows' gradients are summed in the compute dtype as there; serving
    gathers first (the same values, without a cast of the whole table)."""
    dt = getattr(torch, cfg.compute_dtype)
    if torch.is_grad_enabled() and params["embed"].requires_grad:
        return params["embed"].to(dt)[tokens]
    return params["embed"][tokens].to(dt)


def _logits(params, x_last: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """float32 logits [B, V] of the final hidden states [B, d]."""
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x_last.float() @ unembed.float()


def _alloc(shapes: dict, like: torch.Tensor) -> dict:
    """A tree of empty tensors of ``shapes`` in ``like``'s dtype and on its
    device."""
    return {k: _alloc(v, like) if isinstance(v, dict)
            else torch.empty(v, dtype=like.dtype, device=like.device)
            for k, v in shapes.items()}


def _index(tree: dict, i: int) -> dict:
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _layers(tree) -> list:
    """A stacked tree [L, ...] (dicts and tuples of tensors) as L
    per-layer trees of views, each leaf split once (``torch.unbind``:
    under autograd one stacking backward per leaf, where indexing layer by
    layer would add each layer's gradient into a zero tensor of the whole
    leaf)."""
    if isinstance(tree, dict):
        flat = {k: _layers(v) for k, v in tree.items()}
        n = len(next(iter(flat.values())))
        return [{k: v[i] for k, v in flat.items()} for i in range(n)]
    if isinstance(tree, tuple):
        parts = [_layers(v) for v in tree]
        return [tuple(p[i] for p in parts) for i in range(len(parts[0]))]
    return list(tree.unbind(0))


def _stack(trees: list):
    """Per-layer trees stacked leaf by leaf on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([t[i] for t in trees]) for i in range(len(first)))
    return torch.stack(trees)


def scan_or_unroll(cfg: ArchConfig, fn, x, xs):
    """The reference's ``lax.scan`` of ``fn`` over the leading axis of the
    tree ``xs``, or its unrolled loop (``cfg.scan_layers`` False, which
    the reference's roofline accounting lowers).  The port has no scan,
    so both are this loop: ``x, y = fn(x, xs_i)`` layer by layer over
    views of ``xs`` (``_layers``; a write into a view writes ``xs``).
    Returns x and the ys stacked on a new leading axis, or None when
    ``fn`` returns None."""
    ys = []
    for xs_i in _layers(xs):
        x, y = fn(x, xs_i)
        ys.append(y)
    if ys and ys[0] is not None:
        return x, _stack(ys)
    return x, None


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Keep the products without a batch dimension (``aten.mm`` /
    ``aten.addmm``: every ``x @ W`` of a layer), recompute everything
    else: JAX's ``dots_with_no_batch_dims_saveable``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_SAVE_DOTS = functools.partial(create_selective_checkpoint_contexts,
                               _dots_policy)


def remat(cfg: ArchConfig, fn, *args, dots: bool = False):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant) when
    the config asks for rematerialisation (``cfg.remat`` not "none": the
    reference's ``jax.checkpoint``) and a gradient is being taken; its
    activations are then recomputed in the backward pass.  Under
    ``cfg.remat == "dots"`` a caller that passes ``dots`` (the decoder
    stack, where the reference applies its policy) keeps the outputs of
    ``_dots_policy``'s products instead of recomputing them; elsewhere
    "dots" recomputes everything, as "full" does."""
    if cfg.remat != "none" and torch.is_grad_enabled():
        extra = {"context_fn": _SAVE_DOTS} \
            if dots and cfg.remat == "dots" else {}
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **extra)
    return fn(*args)


def _group_layer(cfg: ArchConfig, mctx: MeshCtx | None, mode: str,
                 positions, t=None):
    """One index of the stacked groups: each group's layer in sorted key
    order (dense0..denseK then moe), the reference's ``_group_body``."""
    def body(x, gp: dict, gcache: dict | None):
        for name in sorted(gp):
            p = gp[name]
            x, _ = attn_block(p, x, cfg, mode=mode, positions=positions,
                              cache=None if gcache is None else gcache[name],
                              t=t)
            if name.startswith("dense"):
                x = dense_ffn_block(p, x)
            else:
                x = moe_ffn_block(p, x, cfg, mctx)
        return x
    return body


def _run_stack(params, x, cfg: ArchConfig, mctx: MeshCtx | None, mode: str,
               positions, caches: dict | None = None, t=None):
    """The decoder stack on one device (a step across ranks runs
    ``_stack_ranked``).  ``caches`` (prefill, decode) are written in
    place; "train" takes none and runs each layer under ``remat``."""
    groups = {name: _layers(g) for name, g in params["layers"].items()}
    body = _group_layer(cfg, mctx, mode, positions, t)
    for i in range(len(next(iter(groups.values())))):
        gp = {name: g[i] for name, g in groups.items()}
        if caches is None:
            x = remat(cfg, body, x, gp, None, dots=True)
        else:
            x = body(x, gp, {name: {"k": c["k"][i], "v": c["v"][i]}
                             for name, c in caches.items()})
    return x


def _prepend_images(params, x_tok: torch.Tensor, batch: dict,
                    cfg: ArchConfig) -> torch.Tensor:
    """A VLM's sequence: the projected image embeddings
    ``batch["img_emb"]`` [B, img_tokens, 1024] before the token
    embeddings; any other family's token embeddings as they are."""
    if cfg.family != "vlm":
        return x_tok
    dt = x_tok.dtype
    img_x = batch["img_emb"].to(dt) @ params["img_proj"].to(dt)
    return torch.cat([img_x, x_tok], dim=1)


def next_token_loss(x: torch.Tensor, tokens: torch.Tensor, unembed,
                    cfg: ArchConfig, rk: "_Ranks | None" = None
                    ) -> torch.Tensor:
    """Mean next-token cross-entropy of the final hidden states x [B, S,
    d] (after ``ln_f``) against ``tokens`` [B, S]: label i is token
    i + 1, the last position weighs 0 (the reference's labels roll the
    first token there), through ``chunked_softmax_xent`` in chunks of
    ``cfg.loss_chunk``.  Across ranks (``rk``) x and the tokens are this
    rank's rows, ``unembed`` its vocabulary columns, x enters them through
    ``pvary`` over ``model``, and the mean is over the global batch: the
    sum of NLLs and of weights psummed over the data axes (where they do
    not split the batch, every data rank holds the whole of it and adds
    its 1/dp share, so each one's gradient is a share too, as an FSDP
    gather's reduce-scatter and the replicated leaves' sum over the data
    axes take it)."""
    b, s = tokens.shape
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    weights = torch.ones((b, s), dtype=torch.float32, device=x.device)
    weights[:, -1] = 0.0
    mesh = None if rk is None else rk.mesh
    if mesh is not None:
        x = mesh.pvary(x, "model")
    loss_sum = chunked_softmax_xent(x.reshape(b * s, -1), unembed,
                                    labels.reshape(-1), weights.reshape(-1),
                                    cfg.loss_chunk, mesh)
    if mesh is None:
        return loss_sum / torch.clamp(weights.sum(), min=1.0)
    share = 1 if rk.dp else rk.mctx.dp_size
    tot = mesh.psum(torch.stack([loss_sum, weights.sum()]) / share,
                    rk.mctx.dp)
    return tot[0] / torch.clamp(tot[1], min=1.0)


def decoder_loss(params, batch: dict, cfg: ArchConfig,
                 mctx: MeshCtx | None = None, *,
                 global_batch: int | None = None) -> torch.Tensor:
    """The training loss (float32 scalar) of ``batch["tokens"]`` [B, S]
    (and a VLM's ``img_emb``): the stack in "train" mode over the whole
    sequence, the cross-entropy over the text positions only.  On a mesh
    over ranks (``on_ranks``) ``params`` and the batch are this rank's
    blocks, as for ``decoder_prefill``, and every rank returns the loss
    of the whole global batch (``_loss_ranked``)."""
    _check_supported(cfg)
    if on_ranks(mctx):
        return _loss_ranked(params, batch, cfg, mctx, global_batch)
    tokens = batch["tokens"]
    x = _prepend_images(params, _embed_tokens(params, tokens, cfg), batch,
                        cfg)
    n_img = x.shape[1] - tokens.shape[1]
    positions = torch.arange(x.shape[1], device=x.device)
    x = _run_stack(params, x, cfg, None, "train", positions)
    x = rms_norm(x, params["ln_f"])
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return next_token_loss(x[:, n_img:], tokens, unembed, cfg)


def decoder_prefill(params, batch: dict, cfg: ArchConfig,
                    mctx: MeshCtx | None = None, *,
                    global_batch: int | None = None):
    """batch["tokens"]: [B, S] ids (and a VLM's ``img_emb``).  Returns
    (last-token logits [B, V] float32, caches with exactly as many slots
    as positions: S, or img_tokens + S for a VLM).  On a mesh over ranks
    (``on_ranks``) every argument and result is this rank's block:
    ``params`` under ``decoder_param_specs``, the batch under
    ``batch_specs`` for ``global_batch`` rows, the logits under ``P(dp,
    "model")`` and the caches under ``decoder_cache_specs(cfg, mctx, S)``
    (the data axes dropped where they do not divide ``global_batch``)."""
    _check_supported(cfg)
    if on_ranks(mctx):
        return _prefill_ranked(params, batch, cfg, mctx, global_batch)
    x = _prepend_images(params, _embed_tokens(params, batch["tokens"], cfg),
                        batch, cfg)
    b, s, _ = x.shape
    caches = _alloc(kv_shapes(cfg, b, s), x)
    positions = torch.arange(s, device=x.device)
    x = _run_stack(params, x, cfg, mctx, "prefill", positions, caches)
    x = rms_norm(x[:, -1], params["ln_f"])
    return _logits(params, x, cfg), caches


def decoder_decode_step(params, caches, tokens: torch.Tensor, t: int,
                        cfg: ArchConfig, mctx: MeshCtx | None = None, *,
                        global_batch: int | None = None,
                        n_slots: int | None = None):
    """tokens: [B, 1] new token ids at absolute position ``t`` (an int;
    for a VLM the image tokens count).  Writes the new keys and values
    into ``caches`` in place.  Returns (logits [B, V] float32, caches).
    On a mesh over ranks the arguments and results are this rank's blocks,
    as for ``decoder_prefill``: the tokens of ``global_batch`` rows, the
    caches of ``n_slots`` slots under ``kv_spec(cfg, mctx, n_slots)``
    (which a block alone does not tell where ``model`` cuts the slots)."""
    _check_supported(cfg)
    if on_ranks(mctx):
        return _decode_ranked(params, caches, tokens, t, cfg, mctx,
                              global_batch, n_slots)
    x = _embed_tokens(params, tokens, cfg)
    positions = torch.arange(t, t + 1, device=x.device)
    x = _run_stack(params, x, cfg, mctx, "decode", positions, caches, t=t)
    x = rms_norm(x[:, -1], params["ln_f"])
    return _logits(params, x, cfg), caches


# ---------------------------------------------------------------------------
# Across ranks: the reference's sharded program, one rank's part of it
# ---------------------------------------------------------------------------

def on_ranks(mctx: MeshCtx | None) -> bool:
    """Whether a step on ``mctx`` runs across ranks: a mesh of more than
    one device seen from one rank (``Mesh.over_ranks`` or a
    ``CountingMesh``).  None and one-device meshes run the one-device
    path; an abstract mesh of more than one device raises."""
    if mctx is None or mctx.mesh.size == 1:
        return False
    if not mctx.mesh.coords:
        raise RuntimeError(f"a step on a {mctx.mesh} mesh runs on the "
                           f"ranks of a process group (Mesh.over_ranks) or "
                           f"on a CountingMesh")
    return True


def _need_slots(mctx: MeshCtx, n_slots: int | None) -> None:
    if n_slots is None:
        raise ValueError(f"a decode step on a {mctx.mesh} mesh over ranks "
                         f"takes the caches' global slot count (n_slots=)")


def kv_branch(cfg: ArchConfig, mctx: MeshCtx, n_slots: int) -> str:
    """``kv_spec``'s branch for a cache of ``n_slots`` slots: "heads",
    "slots" or "replicated"."""
    spec = kv_spec(cfg, mctx, n_slots)
    return ("heads" if spec[2] == "model" else
            "slots" if spec[3] == "model" else "replicated")


class _Ranks:
    """One step's layout on this rank: the global batch and the data axes
    that split it, this rank's q heads and KV heads, the KV caches'
    ``kv_spec`` branches (the self-attention's of ``n_slots`` slots; an
    enc-dec's cross-attention's of ``enc_seq``; ``n_slots`` None for a
    family without attention), and each layer group's stored and
    computed weight layouts.  ``stored`` is the family's stored spec tree
    of its layer groups by name (stacked: a leading layer dim), the
    decoder's ``layers`` by default; the computed layout is chosen leaf
    by leaf: the attention and FFN leaves' from ``_computed_specs``, the
    family's own leaves' from ``computed`` (a leaf named in both
    raises).

    The q heads (of ``padded_heads``): under "auto" this rank's block
    where ``model`` divides them, else the heads covering its block of
    ``wo``'s rows (``o_off``, ``cols``); with padding, or under "heads"
    where ``model`` does not divide them, whole heads, the ceiling of
    their count over ``model`` a rank (``whole``: ``wo`` gathered whole,
    the rank's real heads ``r0``..``r1`` at ``real`` among its own); with
    ``seq`` (a prefill or training step under ``attn_shard="seq"``) every
    head, and every KV head computed (``k0``..``k1``; the cache keeps its
    block ``c0``..``c1`` as under "auto")."""

    def __init__(self, cfg: ArchConfig, mctx: MeshCtx, global_batch,
                 rows: int, n_slots: int | None, stored: dict | None = None,
                 computed: dict | None = None, *, seq: bool = False):
        if global_batch is None:
            raise ValueError(f"a step on a {mctx.mesh} mesh over ranks takes "
                             f"the global batch (global_batch=): its "
                             f"tensors are this rank's blocks")
        self.cfg, self.mctx, self.mesh = cfg, mctx, mctx.mesh
        self.global_batch = global_batch
        self.dp = mctx.dp if global_batch % mctx.dp_size == 0 else None
        want = global_batch // mctx.dp_size if self.dp else global_batch
        if rows != want:
            raise ValueError(f"{rows} rows on this rank: the block of a "
                             f"batch of {global_batch} on {mctx.mesh} has "
                             f"{want}")
        tp, r = mctx.tp_size, self.mesh.axis_index("model")
        hq, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        hp = cfg.padded_heads
        self.tp, self.r = tp, r
        self.n_slots = n_slots
        self.seq = seq and cfg.attn_shard == "seq" and n_slots is not None
        self.whole = n_slots is not None and (
            self.seq or hp != hq or (cfg.attn_shard == "heads"
                                     and hq % tp != 0))
        if n_slots is not None:
            if self.seq:
                self.q0, self.q1 = 0, hp
            elif self.whole:
                c = -(-hp // tp)
                self.q0, self.q1 = min(r * c, hp), min((r + 1) * c, hp)
            else:
                # wo's rows on this rank are o's columns [r * cols,
                # (r + 1) * cols): the q heads that cover them are this
                # rank's
                self.cols = hq * dh // tp
                if hq % tp == 0:
                    self.q0, self.q1 = r * hq // tp, (r + 1) * hq // tp
                else:
                    self.q0 = r * self.cols // dh
                    self.q1 = -(-(r + 1) * self.cols // dh)
                self.o_off = r * self.cols - self.q0 * dh
            if self.whole:
                real = [(j - self.q0, _real_index(cfg, j))
                        for j in range(self.q0, self.q1)]
                real = [(i, h) for i, h in real if h is not None]
                self.real = [i for i, _ in real]
                self.r0 = real[0][1] if real else 0
                self.r1 = real[-1][1] + 1 if real else 0
            # the KV heads the cache keeps on this rank: its block where
            # ``model`` divides them, else all (the cache holds every head
            # in both other branches); this rank computes those, or every
            # head under ``seq``
            self.c0, self.c1 = ((r * hk // tp, (r + 1) * hk // tp)
                                if hk % tp == 0 else (0, hk))
            self.k0, self.k1 = (0, hk) if self.seq else (self.c0, self.c1)
            g = hp // hk
            self.kv_idx = [qh // g - self.k0
                           for qh in range(self.q0, self.q1)]
            self.branch = kv_branch(cfg, mctx, n_slots)
            if cfg.family == "encdec":
                self.x_branch = kv_branch(cfg, mctx, cfg.enc_seq)
        if stored is None:
            stored = decoder_param_specs(cfg, mctx)["layers"]
        self.stored = {name: _drop_lead(sp) for name, sp in stored.items()}
        own = computed or {}
        computed = _computed_specs(cfg, mctx, global_batch,
                                   whole=self.whole, seq=self.seq)
        if computed.keys() & own.keys():
            raise ValueError(f"{sorted(computed.keys() & own.keys())}: a "
                             f"family's leaf named as an attention or FFN "
                             f"leaf")
        computed = computed | own
        self.want = {name: {k: computed[k.removeprefix("x_")] for k in sp}
                     for name, sp in self.stored.items()}

    def layer(self, name: str, p: dict, whole: tuple = ()) -> dict:
        """Layer ``p`` of group ``name`` (this rank's stored blocks) in the
        layout its products take: ``relayout`` of every leaf (those named
        in ``whole`` gathered whole), each matrix cast to the compute dtype
        first (the cast each use makes, made before the gather: the same
        values, fewer bytes)."""
        want = self.want[name]
        if whole:
            want = want | {k: P() for k in whole}
        return _relayout_tree(p, self.stored[name], want, self.mctx,
                              getattr(torch, self.cfg.compute_dtype))

    def kv(self, kt: torch.Tensor) -> torch.Tensor:
        """The KV heads of ``kt`` [B, heads computed, S, D] that this
        rank's q heads attend, in the grouped layout (a slice) where the
        q heads share them evenly, else one per q head."""
        idx = self.kv_idx
        if not idx:
            return kt[:, :0]
        lo, n, nq = idx[0], idx[-1] - idx[0] + 1, len(idx)
        if nq % n == 0 and idx == [lo + i // (nq // n) for i in range(nq)]:
            return kt[:, lo:lo + n]
        return kt.index_select(1, torch.tensor(idx, device=kt.device))


def _computed_specs(cfg: ArchConfig, mctx: MeshCtx, global_batch, *,
                    whole: bool = False, seq: bool = False) -> dict:
    """The layout each attention and FFN leaf takes where its product
    runs, by key (a cross-attention leaf ``x_*`` as its self-attention
    one): the norms whole; column-parallel ``wq``/``wk``/``wv`` (whole
    where ``model`` does not divide the padded q heads or the KV heads)
    and ``wg``/``wu``; row-parallel ``wo`` (whole for ``_Ranks``' whole
    heads) and ``wd``; the MoE block's ``moe_in_specs``.  Under ``seq``
    the four attention matrices are whole.  Each drops the stored FSDP
    cut over the data axes.  The SSM's and the RG-LRU's leaves come from
    their modules (``_Ranks``' ``computed``)."""
    tp = mctx.tp_size
    cols, rows = P(None, "model"), P("model", None)
    q_cols = cols if cfg.padded_heads and cfg.padded_heads % tp == 0 \
        and not seq else P()
    kv_cols = cols if cfg.num_kv_heads and cfg.num_kv_heads % tp == 0 \
        and not seq else P()
    out = {"ln1": P(), "ln2": P(),
           "wq": q_cols, "wk": kv_cols, "wv": kv_cols,
           "wo": P() if whole else rows,
           "wg": cols, "wu": cols, "wd": rows}
    if cfg.num_experts:
        out["moe"] = moe_in_specs(cfg, mctx, global_batch)
    return out


def _drop_lead(specs):
    if isinstance(specs, P):
        return P(*specs[1:])
    return {k: _drop_lead(v) for k, v in specs.items()}


def _relayout_tree(p, have, want, mctx: MeshCtx, dt: torch.dtype,
                   key: str = ""):
    if isinstance(p, dict):
        return {k: _relayout_tree(v, have[k], want[k], mctx, dt, k)
                for k, v in p.items()}
    return relayout(p.to(dt) if key in MATRICES else p, have, want, mctx)


def _embed_ranked(params, tokens: torch.Tensor, cfg: ArchConfig,
                  rk: _Ranks) -> torch.Tensor:
    """The vocab-parallel embedding: this rank's rows of the table (its
    block ``P("model", None)``) gathered for the tokens they hold, the
    others zero, summed over ``model`` (a sum of zeros and one row:
    exact), gathered and cast in ``_embed_tokens``' order."""
    table = params["embed"]
    n = table.shape[0]
    local = tokens - rk.r * n
    mine = (local >= 0) & (local < n)
    x = _embed_tokens({"embed": table}, torch.where(mine, local, 0), cfg)
    x = x.masked_fill(~mine[..., None], 0)
    return rk.mesh.psum(x, "model")


def _q_ranked(p, h: torch.Tensor, cfg: ArchConfig, rk: _Ranks
              ) -> torch.Tensor:
    """This rank's q heads [B, S, q1 - q0, Dh] of the normed input ``h``:
    its columns of ``wq``, or its span of them where ``wq`` is gathered
    whole (``model`` does not divide the padded heads)."""
    b, s, _ = h.shape
    dh = cfg.head_dim
    wq = p["wq"]
    if wq.shape[1] != (rk.q1 - rk.q0) * dh:          # every head gathered
        wq = wq[:, rk.q0 * dh:rk.q1 * dh]
    return (h @ wq.to(h.dtype)).reshape(b, s, rk.q1 - rk.q0, dh)


def _out_ranked(p, x: torch.Tensor, o: torch.Tensor, rk: _Ranks
                ) -> torch.Tensor:
    """x plus the output projection of this rank's heads' output ``o``
    [B, heads, S, Dh], summed over ``model``: row-parallel, its columns
    times its rows of ``wo``; with whole heads (``rk.whole``) its real
    heads times their rows of the whole ``wo``."""
    b, s, _ = x.shape
    if rk.whole:
        o = _own_real(o, rk).transpose(1, 2).reshape(b, s, -1)
        dh = rk.cfg.head_dim
        wo = p["wo"][rk.r0 * dh:rk.r1 * dh]
        return x + rk.mesh.psum(o @ wo.to(x.dtype), "model")
    o = o.transpose(1, 2).reshape(b, s, -1)[..., rk.o_off:rk.o_off + rk.cols]
    return x + rk.mesh.psum(o @ p["wo"].to(x.dtype), "model")


def _own_real(o: torch.Tensor, rk: _Ranks) -> torch.Tensor:
    """The real heads of this rank's heads' output ``o`` [B, heads, S,
    Dh] (``rk.real``): itself where it holds no pad head."""
    if len(rk.real) == o.shape[1]:
        return o
    return o.index_select(1, torch.tensor(rk.real, device=o.device))


def _seq_span(rk: _Ranks, s: int) -> tuple[int, int, int]:
    """This rank's block of ``s`` positions under "seq": [a, e) and the
    block length every rank pads to (the ceiling of ``s`` over
    ``model``)."""
    c = -(-s // rk.tp)
    return min(rk.r * c, s), min((rk.r + 1) * c, s), c


def _seq_out(p, x: torch.Tensor, o: torch.Tensor, rk: _Ranks
             ) -> torch.Tensor:
    """x plus ``o @ wo`` of this rank's query rows under "seq" (``o`` [B,
    heads, rows, Dh], every head; ``wo`` whole), the rows gathered over
    ``model`` along the sequence: the same on every rank, so the
    gather's backward is this rank's block of the cotangent."""
    b, s, _ = x.shape
    a, e, c = _seq_span(rk, s)
    width = rk.cfg.num_heads * rk.cfg.head_dim         # rows may be none
    o = _real_heads(o, rk.cfg).transpose(1, 2).reshape(b, e - a, width)
    y = torch.nn.functional.pad(o @ p["wo"].to(x.dtype),
                                (0, 0, 0, c - (e - a)))
    return x + rk.mesh.all_gather_invariant(y, "model", dim=1)[:, :s]


def _attend(rk: _Ranks, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            **mask) -> torch.Tensor:
    """``chunked_attention`` of this rank's q heads [B, heads, Sq, Dh] over
    the KV heads they attend (``rk.kv``).  A rank with no q head (whole
    heads, the ceiling of their count over ``model`` a rank: the last
    ranks may hold none) or no query row ("seq", the ceiling of the
    positions over ``model`` a rank: the same) returns its empty output
    as a function of q, k and v, so that its backward, zeros, reaches the
    gathers of ``wq``, ``wk`` and ``wv`` as on every other rank of
    ``model`` (each gather's reduce-scatter is a collective all of them
    issue)."""
    if not rk.kv_idx or q.shape[2] == 0:
        return q + (k.sum() + v.sum()) * 0
    return chunked_attention(q, rk.kv(k), rk.kv(v), **mask)


def _store_kv(cache: torch.Tensor, kt: torch.Tensor, branch: str,
              rk: _Ranks) -> None:
    """Write a prefill's keys or values ``kt`` [B, heads computed, S, Dh]
    into this rank's cache block: its block of slots in the "slots"
    branch, all of them otherwise."""
    if branch == "slots":
        n = cache.shape[2]
        kt = kt[:, :, rk.r * n:(rk.r + 1) * n]
    cache.copy_(kt)


def _attn_ranked(p, x: torch.Tensor, cfg: ArchConfig, rk: _Ranks, *,
                 mode: str, positions, cache: dict, t=None,
                 causal: bool = True, use_rotary: bool = True
                 ) -> torch.Tensor:
    """``attn_block`` on this rank's q heads, ``p`` in the computed layout
    (``_Ranks.layer``).  The cache by ``kv_spec``'s branch: "heads", this
    rank's KV heads; "slots", every head of this rank's block of slots
    (decode: the rank holding slot ``t % S`` writes it, and the blocks are
    gathered over ``model`` before the kernel); "replicated", every head
    and slot of this rank's rows; "train" keeps none (and runs the
    encoder: ``causal`` and ``use_rotary`` False).  The output projection is
    row-parallel (``_out_ranked``).  The normed input enters this rank's
    heads through ``pvary``: its cotangents, this rank's heads' alone
    (every KV head's where each rank computes all and keeps some), are
    summed over ``model``.  Under ``rk.seq`` (prefill and "train") this
    rank takes its block of query positions [a, e) with every head, and
    keys and values from position 0 to e (every position in a prefill,
    whose cache keeps them all): the kernel's suffix alignment puts query
    row i at a + i, so the causal, window and chunk masks hold at
    absolute positions (``_seq_out`` gathers the rows)."""
    h = rk.mesh.pvary(rms_norm(x, p["ln1"]), "model")
    b, s, _ = x.shape
    dt, dh = h.dtype, cfg.head_dim
    f32 = cfg.attn_f32_scores
    seq = rk.seq and mode != "decode"
    a, e = _seq_span(rk, s)[:2] if seq else (0, s)
    hkv = h[:, :e] if seq and mode == "train" and causal else h
    q = _q_ranked(p, h[:, a:e], cfg, rk)
    k = (hkv @ p["wk"].to(dt)).reshape(b, -1, rk.k1 - rk.k0, dh)
    v = (hkv @ p["wv"].to(dt)).reshape(b, -1, rk.k1 - rk.k0, dh)
    if use_rotary:
        q = rotary(q, positions[a:e], cfg.rope_theta)
        k = rotary(k, positions[:k.shape[1]], cfg.rope_theta)
    if mode == "prefill":
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        heads = slice(rk.c0 - rk.k0, rk.c1 - rk.k0)
        _store_kv(cache["k"], kt[:, heads], rk.branch, rk)
        _store_kv(cache["v"], vt[:, heads], rk.branch, rk)
        kt, vt = kt[:, :, :e], vt[:, :, :e]
        o = _attend(rk, qt, kt, vt, causal=True, window=cfg.window,
                    chunk_attn=cfg.chunk_attn, f32_stats=f32)
    elif mode == "decode":
        slot = t % rk.n_slots
        kc, vc = cache["k"], cache["v"]
        if rk.branch == "slots":
            n = kc.shape[2]
            if slot // n == rk.r:
                kc[:, :, slot - rk.r * n] = k[:, 0]
                vc[:, :, slot - rk.r * n] = v[:, 0]
            kc = rk.mesh.all_gather(kc, "model", dim=2)
            vc = rk.mesh.all_gather(vc, "model", dim=2)
        else:
            kc[:, :, slot] = k[:, 0]
            vc[:, :, slot] = v[:, 0]
        o = decode_attention(q.transpose(1, 2), rk.kv(kc), rk.kv(vc), None,
                             t, window=cfg.window, chunk_attn=cfg.chunk_attn
                             ) if rk.kv_idx else q.transpose(1, 2)
    elif mode == "train":
        o = _attend(rk, q.transpose(1, 2), k.transpose(1, 2),
                    v.transpose(1, 2), causal=causal, window=cfg.window,
                    chunk_attn=cfg.chunk_attn, f32_stats=f32)
    else:
        raise ValueError(f"mode must be 'prefill', 'decode' or 'train', "
                         f"got {mode!r}")
    if seq:
        return _seq_out(p, x, o, rk)
    return _out_ranked(p, x, o, rk)


def _cross_ranked(p, x: torch.Tensor, cfg: ArchConfig, rk: _Ranks, *,
                  mode: str, cache: tuple | None, enc_out=None
                  ) -> torch.Tensor:
    """``attn_block``'s cross-attention on this rank's q heads (no rotary,
    not causal), ``p`` the ``x_*`` leaves in the computed layout.  The
    cross caches ``(cross_k, cross_v)`` by ``kv_spec(cfg, mctx,
    enc_seq)``'s branch (``_Ranks.x_branch``): the prefill projects the
    encoder output ``enc_out`` (this rank's rows, whole over ``model``)
    into this rank's KV heads and stores its block; decode reads them,
    gathered over ``model`` first in the "slots" branch, at ``t =
    enc_seq - 1`` as the reference does.  "train" projects ``enc_out`` as
    the prefill does, inside the layer (so ``remat`` recomputes the keys
    and values), and keeps no cache (``cache`` None)."""
    h = rk.mesh.pvary(rms_norm(x, p["ln1"]), "model")
    b, dh = x.shape[0], cfg.head_dim
    q = _q_ranked(p, h, cfg, rk).transpose(1, 2)
    if mode in ("prefill", "train"):
        kt, vt = ((enc_out @ p[w].to(enc_out.dtype)).reshape(
            b, -1, rk.k1 - rk.k0, dh).transpose(1, 2) for w in ("wk", "wv"))
        if mode == "prefill":
            _store_kv(cache[0], kt, rk.x_branch, rk)
            _store_kv(cache[1], vt, rk.x_branch, rk)
        o = _attend(rk, q, kt, vt, causal=False, window=cfg.window,
                    chunk_attn=cfg.chunk_attn, f32_stats=cfg.attn_f32_scores)
    else:
        kc, vc = cache
        if rk.x_branch == "slots":
            kc = rk.mesh.all_gather(kc, "model", dim=2)
            vc = rk.mesh.all_gather(vc, "model", dim=2)
        o = decode_attention(q, rk.kv(kc), rk.kv(vc), None, kc.shape[2] - 1
                             ) if rk.kv_idx else q
    return _out_ranked(p, x, o, rk)


def _ffn_ranked(p, x: torch.Tensor, rk: _Ranks) -> torch.Tensor:
    """The SwiGLU FFN with ``wg``/``wu`` column-parallel (the normed input
    through ``pvary``) and ``wd`` row-parallel: the partial outputs summed
    over ``model``."""
    h = rk.mesh.pvary(rms_norm(x, p["ln2"]), "model")
    return x + rk.mesh.psum(swiglu(h, p["wg"], p["wu"], p["wd"]), "model")


def _stack_ranked(params, x: torch.Tensor, cfg: ArchConfig, rk: _Ranks,
                  mode: str, positions, caches: dict | None = None,
                  t=None) -> torch.Tensor:
    """The decoder stack on this rank: per layer its weights gathered into
    the computed layout (then dropped), attention, then the dense FFN or
    the MoE block (``moe_ffn`` on this rank's rows).  "train" takes no
    caches and runs each index of the groups under ``remat``, gathers
    included: the recompute in the backward pass gathers the weights
    again, and each gather's backward reduce-scatters the weights'
    gradients into their FSDP blocks."""
    groups = {name: _layers(g) for name, g in params["layers"].items()}

    def body(x, gp: dict, gcache: dict | None):
        for name in sorted(gp):
            p = rk.layer(name, gp[name])
            x = _attn_ranked(p, x, cfg, rk, mode=mode, positions=positions,
                             cache=None if gcache is None else gcache[name],
                             t=t)
            if name.startswith("dense"):
                x = _ffn_ranked(p, x, rk)
            else:
                x = moe_ffn_block(p, x, cfg, rk.mctx,
                                  global_batch=rk.global_batch)
            del p
        return x

    for i in range(len(next(iter(groups.values())))):
        gp = {name: g[i] for name, g in groups.items()}
        if caches is None:
            x = remat(cfg, body, x, gp, None, dots=True)
        else:
            x = body(x, gp, {name: {"k": c["k"][i], "v": c["v"][i]}
                             for name, c in caches.items()})
    return x


def _cache_alloc(shapes: dict, specs: dict, rk: _Ranks,
                 like: torch.Tensor) -> dict:
    """Empty caches: this rank's blocks of ``shapes`` (the global caches)
    under ``specs`` (a family's cache specs), the data axes dropped where
    they do not divide the batch, in ``like``'s dtype and on its
    device."""
    dp = P(rk.mctx.dp)[0]

    def block(shape, spec: P) -> tuple:
        spec = P(*(rk.dp if e == dp else e for e in spec))
        return rk.mctx.sharding(spec).shard_shape(shape)

    def walk(sh, sp):
        if isinstance(sh, dict):
            return {k: walk(v, sp[k]) for k, v in sh.items()}
        return block(sh, sp)

    return _alloc(walk(shapes, specs), like)


def _prefill_ranked(params, batch: dict, cfg: ArchConfig, mctx: MeshCtx,
                    global_batch):
    tokens = batch["tokens"]
    s = tokens.shape[1] + (cfg.img_tokens if cfg.family == "vlm" else 0)
    rk = _Ranks(cfg, mctx, global_batch, tokens.shape[0],
                kv_cache_len(cfg, s), seq=True)
    x = _prepend_images(params, _embed_ranked(params, tokens, cfg, rk),
                        batch, cfg)
    caches = _cache_alloc(kv_shapes(cfg, global_batch, s),
                          decoder_cache_specs(cfg, mctx, s), rk, x)
    positions = torch.arange(s, device=x.device)
    x = _stack_ranked(params, x, cfg, rk, "prefill", positions, caches)
    x = rms_norm(x[:, -1], params["ln_f"])
    return _logits(params, x, cfg), caches


def _loss_ranked(params, batch: dict, cfg: ArchConfig, mctx: MeshCtx,
                 global_batch) -> torch.Tensor:
    """``decoder_loss`` on this rank: the stack in "train" mode on its rows
    and blocks, ``ln_f``, then the vocab-parallel cross-entropy of its
    tokens (``next_token_loss`` against this rank's vocabulary columns:
    ``unembed``'s ``P(None, "model")`` block, or the tied ``embed``'s
    ``P("model", None)`` block transposed)."""
    tokens = batch["tokens"]
    s = tokens.shape[1] + (cfg.img_tokens if cfg.family == "vlm" else 0)
    rk = _Ranks(cfg, mctx, global_batch, tokens.shape[0], s, seq=True)
    x = _prepend_images(params, _embed_ranked(params, tokens, cfg, rk),
                        batch, cfg)
    n_img = x.shape[1] - tokens.shape[1]
    x = _stack_ranked(params, x, cfg, rk, "train",
                      torch.arange(s, device=x.device))
    x = rms_norm(x, params["ln_f"])
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return next_token_loss(x[:, n_img:], tokens, unembed, cfg, rk)


def _decode_ranked(params, caches, tokens: torch.Tensor, t: int,
                   cfg: ArchConfig, mctx: MeshCtx, global_batch, n_slots):
    _need_slots(mctx, n_slots)
    rk = _Ranks(cfg, mctx, global_batch, tokens.shape[0], n_slots)
    x = _embed_ranked(params, tokens, cfg, rk)
    positions = torch.arange(t, t + 1, device=x.device)
    x = _stack_ranked(params, x, cfg, rk, "decode", positions, caches, t=t)
    x = rms_norm(x[:, -1], params["ln_f"])
    return _logits(params, x, cfg), caches


# ---------------------------------------------------------------------------
# Whisper-style encoder-decoder
# ---------------------------------------------------------------------------

def encdec_cache_shapes(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """The reference's enc-dec cache tree: self-attention k/v of
    ``seq_len`` slots and the cross-attention keys and values over the
    encoder's ``enc_seq`` frames, per decoder layer."""
    _check_supported(cfg, ("encdec",))
    kv = (cfg.num_layers, batch, cfg.num_kv_heads, seq_len, cfg.head_dim)
    xkv = (cfg.num_layers, batch, cfg.num_kv_heads, cfg.enc_seq,
           cfg.head_dim)
    return {"self": {"k": kv, "v": kv}, "cross_k": xkv, "cross_v": xkv}


def encdec_cache_specs(cfg: ArchConfig, mctx: MeshCtx,
                       seq_len: int = 0) -> dict:
    spec = kv_spec(cfg, mctx, seq_len)
    xspec = kv_spec(cfg, mctx, cfg.enc_seq)
    return {"self": {"k": spec, "v": spec}, "cross_k": xspec,
            "cross_v": xspec}


def _enc_layer(cfg: ArchConfig):
    def body(x, p):
        x, _ = attn_block(p, x, cfg, mode="train", use_rotary=False,
                          causal=False)
        return dense_ffn_block(p, x)
    return body


def _encoder_input(params, frames: torch.Tensor, cfg: ArchConfig
                   ) -> torch.Tensor:
    """The frames projected (``frame_proj``, replicated across ranks) in
    the compute dtype, plus the sinusoid positions."""
    dt = getattr(torch, cfg.compute_dtype)
    x = frames.to(dt) @ params["frame_proj"].to(dt)
    return x + sinusoid_positions(x.shape[1], cfg.d_model,
                                  x.device).to(dt)[None]


def _encode(params, frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Encoder output [B, enc_seq, d]: the frames projected, plus sinusoid
    positions, through non-causal self-attention layers without rotary
    (each under ``remat`` when a gradient is taken)."""
    x = _encoder_input(params, frames, cfg)
    body = _enc_layer(cfg)
    x, _ = scan_or_unroll(cfg, lambda c, p: (remat(cfg, body, c, p), None),
                          x, params["enc_layers"])
    return rms_norm(x, params["ln_enc"])


def _dec_body(p, x: torch.Tensor, cfg: ArchConfig, mode: str, positions,
              cache: dict, t: int | None = None) -> torch.Tensor:
    """One decoder layer: causal self-attention with rotary over
    ``cache["self"]``, cross-attention over ``cache["cross_k"]`` /
    ``cache["cross_v"]`` [B, Hk, enc_seq, Dh], then the SwiGLU FFN."""
    x, _ = attn_block(p, x, cfg, mode=mode, positions=positions,
                      cache=cache["self"], t=t)
    xp = {k[2:]: v for k, v in p.items() if k.startswith("x_")}
    x, _ = attn_block(xp, x, cfg, mode=mode,
                      kv_override=(cache["cross_k"], cache["cross_v"]))
    return dense_ffn_block(p, x)


def _dec_train_layer(cfg: ArchConfig, positions):
    """One decoder layer of the training pass: the cross-attention keys
    and values projected from the encoder output inside the layer (so
    ``remat`` recomputes them), then ``_dec_body``'s three blocks."""
    def body(x, p, enc_out):
        b = x.shape[0]
        kv = [(enc_out @ p[w].to(enc_out.dtype)).reshape(
            b, -1, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
            for w in ("x_wk", "x_wv")]
        x, _ = attn_block(p, x, cfg, mode="train", positions=positions)
        xp = {k[2:]: v for k, v in p.items() if k.startswith("x_")}
        x, _ = attn_block(xp, x, cfg, mode="train", kv_override=tuple(kv))
        return dense_ffn_block(p, x)
    return body


def encdec_loss(params, batch: dict, cfg: ArchConfig,
                mctx: MeshCtx | None = None, *,
                global_batch: int | None = None) -> torch.Tensor:
    """The training loss (float32 scalar) of ``batch["frames"]`` [B,
    enc_seq, 1024] and ``batch["tokens"]`` [B, S]: the encoder, then the
    decoder in "train" mode (causal self-attention with rotary,
    cross-attention over the encoder output), the next-token
    cross-entropy against ``unembed``.  On a mesh over ranks ``params``
    and the batch are this rank's blocks, as for ``encdec_prefill``, and
    every rank returns the loss of the whole global batch
    (``_encdec_loss_ranked``)."""
    _check_supported(cfg, ("encdec",))
    if on_ranks(mctx):
        return _encdec_loss_ranked(params, batch, cfg, mctx, global_batch)
    enc_out = _encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg)
    body = _dec_train_layer(
        cfg, torch.arange(tokens.shape[1], device=x.device))
    x, _ = scan_or_unroll(
        cfg, lambda c, p: (remat(cfg, body, c, p, enc_out), None), x,
        params["dec_layers"])
    x = rms_norm(x, params["ln_f"])
    return next_token_loss(x, tokens, params["unembed"], cfg)


def encdec_prefill(params, batch: dict, cfg: ArchConfig,
                   mctx: MeshCtx | None = None, *,
                   global_batch: int | None = None):
    """batch["frames"]: [B, enc_seq, 1024], batch["tokens"]: [B, S] ids.
    Returns (last-token logits [B, V] float32, caches: self-attention with
    exactly S slots, and the cross-attention keys and values of every
    decoder layer over the encoder output).  On a mesh over ranks every
    argument and result is this rank's block, as for ``decoder_prefill``:
    ``params`` under ``encdec_param_specs``, the frames and tokens of
    ``global_batch`` rows, the caches under ``encdec_cache_specs(cfg,
    mctx, S)`` (``_encdec_ranked``)."""
    _check_supported(cfg, ("encdec",))
    if on_ranks(mctx):
        return _encdec_ranked(params, batch, None, batch["tokens"], None,
                              cfg, mctx, global_batch, None)
    enc_out = _encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed_tokens(params, tokens, cfg)
    caches = _alloc(encdec_cache_shapes(cfg, b, s), x)
    positions = torch.arange(s, device=x.device)

    def layer(x, xs):
        p, lc = xs
        for w, c in (("x_wk", lc["cross_k"]), ("x_wv", lc["cross_v"])):
            c.copy_((enc_out @ p[w].to(x.dtype)).reshape(
                b, -1, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2))
        return _dec_body(p, x, cfg, "prefill", positions, lc), None

    x, _ = scan_or_unroll(cfg, layer, x, (params["dec_layers"], caches))
    x = rms_norm(x[:, -1], params["ln_f"])
    return _logits(params, x, cfg), caches


def encdec_decode_step(params, caches, tokens: torch.Tensor, t: int,
                       cfg: ArchConfig, mctx: MeshCtx | None = None, *,
                       global_batch: int | None = None,
                       n_slots: int | None = None):
    """tokens: [B, 1] new token ids at absolute position ``t`` (an int).
    Writes the new self-attention keys and values into ``caches`` in
    place; the cross caches are read whole.  Returns (logits [B, V]
    float32, caches).  On a mesh over ranks the arguments and results are
    this rank's blocks, as for ``decoder_decode_step``: the
    self-attention caches of ``n_slots`` slots."""
    _check_supported(cfg, ("encdec",))
    if on_ranks(mctx):
        _need_slots(mctx, n_slots)
        return _encdec_ranked(params, None, caches, tokens, t, cfg, mctx,
                              global_batch, n_slots)
    x = _embed_tokens(params, tokens, cfg)
    positions = torch.arange(t, t + 1, device=x.device)
    def layer(x, xs):
        p, lc = xs
        return _dec_body(p, x, cfg, "decode", positions, lc, t=t), None

    x, _ = scan_or_unroll(cfg, layer, x, (params["dec_layers"], caches))
    x = rms_norm(x[:, -1], params["ln_f"])
    return _logits(params, x, cfg), caches


def _encdec_ranked(params, batch: dict | None, caches: dict | None,
                   tokens: torch.Tensor, t: int | None, cfg: ArchConfig,
                   mctx: MeshCtx, global_batch, n_slots):
    """The enc-dec's prefill (``batch`` given) or decode step (``caches``
    given) on this rank.  The prefill runs the encoder first: the frames
    of this rank's rows through the replicated ``frame_proj``, the
    sinusoid positions, then per encoder layer non-causal attention
    without rotary on this rank's heads (``_attn_ranked``) and the
    tensor-parallel FFN; ``ln_enc``.  Each decoder layer: self-attention
    (``_attn_ranked``, the cache by ``kv_spec(cfg, mctx, S)``),
    cross-attention (``_cross_ranked``, the cross caches by ``kv_spec(cfg,
    mctx, enc_seq)``), the FFN.  The logits are this rank's block
    ``P(dp, "model")``, against ``unembed``'s ``P(None, "model")``
    block."""
    specs = encdec_param_specs(cfg, mctx)
    stored = {"enc": specs["enc_layers"], "dec": specs["dec_layers"]}
    prefill = batch is not None
    s = tokens.shape[1]
    rk = _Ranks(cfg, mctx, global_batch, tokens.shape[0],
                s if prefill else n_slots, stored)
    x = _embed_ranked(params, tokens, cfg, rk)
    enc_out = None
    if prefill:
        enc_out = _encode_ranked(params, batch["frames"], cfg, rk)
        caches = _cache_alloc(encdec_cache_shapes(cfg, global_batch, s),
                              encdec_cache_specs(cfg, mctx, s), rk, x)
        positions = torch.arange(s, device=x.device)
    else:
        positions = torch.arange(t, t + 1, device=x.device)
    mode = "prefill" if prefill else "decode"
    for p, lc in zip(_layers(params["dec_layers"]), _layers(caches)):
        p = rk.layer("dec", p)
        x = _attn_ranked(p, x, cfg, rk, mode=mode, positions=positions,
                         cache=lc["self"], t=t)
        xp = {k[2:]: v for k, v in p.items() if k.startswith("x_")}
        x = _cross_ranked(xp, x, cfg, rk, mode=mode,
                          cache=(lc["cross_k"], lc["cross_v"]),
                          enc_out=enc_out)
        x = _ffn_ranked(p, x, rk)
        del p, xp
    x = rms_norm(x[:, -1], params["ln_f"])
    return _logits(params, x, cfg), caches


def _encode_ranked(params, frames: torch.Tensor, cfg: ArchConfig,
                   rk: _Ranks) -> torch.Tensor:
    """``_encode`` on this rank's rows: [B_rank, enc_seq, d], whole over
    ``model`` (the row-parallel products' psums), entering the
    cross-attention's column-parallel products through ``pvary`` (its
    backward sums the decoder layers' cotangents over ``model``).  Each
    layer, its gathers included, runs under ``remat`` when a gradient is
    taken."""
    def layer(x, p):
        p = rk.layer("enc", p)
        x = _attn_ranked(p, x, cfg, rk, mode="train", positions=None,
                         cache=None, causal=False, use_rotary=False)
        return _ffn_ranked(p, x, rk)

    x = _encoder_input(params, frames, cfg)
    for p in _layers(params["enc_layers"]):
        x = remat(cfg, layer, x, p)
    return rk.mesh.pvary(rms_norm(x, params["ln_enc"]), "model")


def _encdec_loss_ranked(params, batch: dict, cfg: ArchConfig, mctx: MeshCtx,
                        global_batch) -> torch.Tensor:
    """``encdec_loss`` on this rank: the vocab-parallel embedding, the
    encoder (``_encode_ranked``), then each decoder layer under ``remat``,
    its weights gathered inside it: causal self-attention with rotary
    (``_attn_ranked``), cross-attention over the encoder output
    (``_cross_ranked``, the keys and values projected in the layer), the
    tensor-parallel FFN; ``ln_f`` and the vocab-parallel cross-entropy
    against ``unembed``'s ``P(None, "model")`` block."""
    specs = encdec_param_specs(cfg, mctx)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    rk = _Ranks(cfg, mctx, global_batch, tokens.shape[0], s,
                {"enc": specs["enc_layers"], "dec": specs["dec_layers"]})
    x = _embed_ranked(params, tokens, cfg, rk)
    enc_out = _encode_ranked(params, batch["frames"], cfg, rk)
    positions = torch.arange(s, device=x.device)

    def layer(x, p, enc_out):
        p = rk.layer("dec", p)
        x = _attn_ranked(p, x, cfg, rk, mode="train", positions=positions,
                         cache=None)
        xp = {k[2:]: v for k, v in p.items() if k.startswith("x_")}
        x = _cross_ranked(xp, x, cfg, rk, mode="train", cache=None,
                          enc_out=enc_out)
        return _ffn_ranked(p, x, rk)

    for p in _layers(params["dec_layers"]):
        x = remat(cfg, layer, x, p, enc_out)
    x = rms_norm(x, params["ln_f"])
    return next_token_loss(x, tokens, params["unembed"], cfg, rk)
