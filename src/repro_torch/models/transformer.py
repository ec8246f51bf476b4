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
One GPU needs no mesh, so the reference's sharding constraints have no
counterpart here.

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
blocks, initialisation and helpers; head padding (an XLA layout knob)
raises.

Training (``decoder_loss``, ``encdec_loss``): the reference's losses,
next-token cross-entropy over the text positions through
``layers.chunked_softmax_xent``.  The float32 parameters stay the leaves
autograd differentiates; every matrix is cast to the compute dtype where
it is used, inside the layer, so under ``cfg.remat`` (each layer run
under ``torch.utils.checkpoint``, the reference's ``jax.checkpoint``) the
bf16 copies are recomputed in the backward pass, not kept.  A stacked
leaf is split into its layers once per forward (``_layers``:
``torch.unbind``), so its gradient is stacked once, not summed into a
zero tensor of the whole leaf at every layer.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (chunked_attention,
                                       chunked_softmax_xent, decode_attention,
                                       rms_norm, rotary, sinusoid_positions,
                                       swiglu)
from repro_torch.models.moe import moe_ffn, moe_param_shapes, moe_param_specs
from repro_torch.models.sharding import MeshCtx, P

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
    reference does."""
    h = rms_norm(x, p["ln1"])
    b, s, _ = x.shape
    if kv_override is not None:
        q = (h @ p["wq"].to(h.dtype)).reshape(b, s, cfg.num_heads,
                                             cfg.head_dim)
        k, v = kv_override
        if mode == "decode":
            o = decode_attention(q.transpose(1, 2), k, v, None,
                                 k.shape[2] - 1)
        else:
            o = chunked_attention(q.transpose(1, 2), k, v, causal=False,
                                  window=cfg.window,
                                  chunk_attn=cfg.chunk_attn)
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
                                  chunk_attn=cfg.chunk_attn)
        elif mode == "train":
            o = chunked_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=cfg.window,
                                  chunk_attn=cfg.chunk_attn)
        else:
            raise ValueError(f"mode must be 'prefill', 'decode' or "
                             f"'train', got {mode!r}")
    o = o.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.head_dim)
    return x + o @ p["wo"].to(x.dtype), cache


def dense_ffn_block(p, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln2"])
    return x + swiglu(h, p["wg"], p["wu"], p["wd"])


def moe_ffn_block(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = rms_norm(x, p["ln2"])
    return x + moe_ffn(p["moe"], h, cfg)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _attn_shapes(cfg: ArchConfig, n: int) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "ln1": (n, d),
        "wq": (n, d, cfg.num_heads * hd),
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
                        device=None, dtype: torch.dtype | None = None
                        ) -> dict:
    """The decoder's tree, drawn as ``_init_from_shapes`` draws."""
    return _init_from_shapes(decoder_param_shapes(cfg), cfg, generator,
                             device, dtype)


def init_encdec_params(cfg: ArchConfig, generator: torch.Generator,
                       device=None, dtype: torch.dtype | None = None
                       ) -> dict:
    """The enc-dec tree, drawn as ``_init_from_shapes`` draws."""
    return _init_from_shapes(encdec_param_shapes(cfg), cfg, generator,
                             device, dtype)


def leaf_dtype(name: str, cfg: ArchConfig,
               dtype: torch.dtype | None = None) -> torch.dtype:
    """The dtype the init holds leaf ``name`` in: ``dtype`` for the
    ``MATRICES`` leaves when it is given, else the config's
    ``param_dtype``."""
    if dtype is not None and name in MATRICES:
        return dtype
    return getattr(torch, cfg.param_dtype)


def _init_from_shapes(shapes: dict, cfg: ArchConfig,
                      generator: torch.Generator, device, dtype) -> dict:
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
    memory of the cast tree."""
    device = generator.device if device is None else device
    params: dict = {}
    for path, shape in _leaves(shapes):
        ldt = leaf_dtype(path[-1], cfg, dtype)
        if len(shape) == 1:
            _set(params, path, torch.ones(shape, dtype=ldt, device=device))
            continue
        leaf = torch.empty(shape, dtype=ldt, device=device)
        for mat in leaf.reshape(-1, *shape[-2:]):
            mat.copy_(torch.randn(shape[-2:], generator=generator,
                                  dtype=torch.float32, device=device)
                      .mul_(0.02))
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


def remat(cfg: ArchConfig, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant) when
    the config asks for rematerialisation (``cfg.remat`` not "none": the
    reference's ``jax.checkpoint``; "dots" recomputes everything too) and
    a gradient is being taken; its activations are then recomputed in the
    backward pass."""
    if cfg.remat != "none" and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _group_layer(cfg: ArchConfig, mode: str, positions, t=None):
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
                x = moe_ffn_block(p, x, cfg)
        return x
    return body


def _run_stack(params, x, cfg: ArchConfig, mode: str, positions,
               caches: dict | None = None, t=None):
    """The decoder stack.  ``caches`` (prefill, decode) are written in
    place; "train" takes none and runs each layer under ``remat``."""
    groups = {name: _layers(g) for name, g in params["layers"].items()}
    body = _group_layer(cfg, mode, positions, t)
    for i in range(len(next(iter(groups.values())))):
        gp = {name: g[i] for name, g in groups.items()}
        if caches is None:
            x = remat(cfg, body, x, gp, None)
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
                    cfg: ArchConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of the final hidden states x [B, S,
    d] (after ``ln_f``) against ``tokens`` [B, S]: label i is token
    i + 1, the last position weighs 0 (the reference's labels roll the
    first token there), through ``chunked_softmax_xent`` in chunks of
    ``cfg.loss_chunk``."""
    b, s = tokens.shape
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    weights = torch.ones((b, s), dtype=torch.float32, device=x.device)
    weights[:, -1] = 0.0
    loss_sum = chunked_softmax_xent(x.reshape(b * s, -1), unembed,
                                    labels.reshape(-1), weights.reshape(-1),
                                    cfg.loss_chunk)
    return loss_sum / torch.clamp(weights.sum(), min=1.0)


def decoder_loss(params, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """The training loss (float32 scalar) of ``batch["tokens"]`` [B, S]
    (and a VLM's ``img_emb``): the stack in "train" mode over the whole
    sequence, the cross-entropy over the text positions only."""
    _check_supported(cfg)
    tokens = batch["tokens"]
    x = _prepend_images(params, _embed_tokens(params, tokens, cfg), batch,
                        cfg)
    n_img = x.shape[1] - tokens.shape[1]
    positions = torch.arange(x.shape[1], device=x.device)
    x = _run_stack(params, x, cfg, "train", positions)
    x = rms_norm(x, params["ln_f"])
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return next_token_loss(x[:, n_img:], tokens, unembed, cfg)


def decoder_prefill(params, batch: dict, cfg: ArchConfig):
    """batch["tokens"]: [B, S] ids (and a VLM's ``img_emb``).  Returns
    (last-token logits [B, V] float32, caches with exactly as many slots
    as positions: S, or img_tokens + S for a VLM)."""
    _check_supported(cfg)
    x = _prepend_images(params, _embed_tokens(params, batch["tokens"], cfg),
                        batch, cfg)
    b, s, _ = x.shape
    caches = _alloc(kv_shapes(cfg, b, s), x)
    positions = torch.arange(s, device=x.device)
    x = _run_stack(params, x, cfg, "prefill", positions, caches)
    x = rms_norm(x[:, -1], params["ln_f"])
    return _logits(params, x, cfg), caches


def decoder_decode_step(params, caches, tokens: torch.Tensor, t: int,
                        cfg: ArchConfig):
    """tokens: [B, 1] new token ids at absolute position ``t`` (an int;
    for a VLM the image tokens count).  Writes the new keys and values
    into ``caches`` in place.  Returns (logits [B, V] float32, caches)."""
    _check_supported(cfg)
    x = _embed_tokens(params, tokens, cfg)
    positions = torch.arange(t, t + 1, device=x.device)
    x = _run_stack(params, x, cfg, "decode", positions, caches, t=t)
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


def _encode(params, frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Encoder output [B, enc_seq, d]: the frames projected, plus sinusoid
    positions, through non-causal self-attention layers without rotary
    (each under ``remat`` when a gradient is taken)."""
    dt = getattr(torch, cfg.compute_dtype)
    x = frames.to(dt) @ params["frame_proj"].to(dt)
    x = x + sinusoid_positions(x.shape[1], cfg.d_model,
                               x.device).to(dt)[None]
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


def encdec_loss(params, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """The training loss (float32 scalar) of ``batch["frames"]`` [B,
    enc_seq, 1024] and ``batch["tokens"]`` [B, S]: the encoder, then the
    decoder in "train" mode (causal self-attention with rotary,
    cross-attention over the encoder output), the next-token
    cross-entropy against ``unembed``."""
    _check_supported(cfg, ("encdec",))
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


def encdec_prefill(params, batch: dict, cfg: ArchConfig):
    """batch["frames"]: [B, enc_seq, 1024], batch["tokens"]: [B, S] ids.
    Returns (last-token logits [B, V] float32, caches: self-attention with
    exactly S slots, and the cross-attention keys and values of every
    decoder layer over the encoder output)."""
    _check_supported(cfg, ("encdec",))
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
                       cfg: ArchConfig):
    """tokens: [B, 1] new token ids at absolute position ``t`` (an int).
    Writes the new self-attention keys and values into ``caches`` in
    place; the cross caches are read whole.  Returns (logits [B, V]
    float32, caches)."""
    _check_supported(cfg, ("encdec",))
    x = _embed_tokens(params, tokens, cfg)
    positions = torch.arange(t, t + 1, device=x.device)
    def layer(x, xs):
        p, lc = xs
        return _dec_body(p, x, cfg, "decode", positions, lc, t=t), None

    x, _ = scan_or_unroll(cfg, layer, x, (params["dec_layers"], caches))
    x = rms_norm(x[:, -1], params["ln_f"])
    return _logits(params, x, cfg), caches
