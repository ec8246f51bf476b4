"""Mamba2 (SSD, state-space duality) blocks: the training loss, prefill
and recurrent decode.

The counterpart of the JAX package's ``models/ssm.py``.  Prefill runs the
chunked SSD algorithm of arXiv:2405.21060 (``ssd_chunked``: an
attention-like product inside each chunk of ``cfg.ssd_chunk`` positions,
and the recurrence across chunks as a small chunk-level decay product);
decode is the O(1)-state recurrent step.  Plain PyTorch: the reference
runs no Pallas kernel here.

The parameter tree is the reference's (``ssm_param_shapes``), layers
stacked on a leading axis under ``params["layers"]``; the stack runs as a
Python loop over it (the reference's ``lax.scan``).  Caches are
``{"conv": [L, B, W-1, Cc], "state": [L, B, H, Pd, N]}``, both in the
compute dtype as the reference stores them: the conv state is the raw
``xbc`` of the last W-1 positions, the SSM state the float32 state
rounded to the compute dtype.  Prefill fills them; decode writes every
layer's new state into them in place and returns them.

Across ranks (``_ssm_ranked``, ``_ssm_loss_ranked``) each rank holds its
blocks under ``ssm_param_specs`` and ``ssm_cache_specs``: the prefill and
the training loss run the SSD on the heads whose channels cover its block
of ``d_inner``, the decode step updates the SSM state in its stored
layout, this rank's block of N of every head (``_mamba_ranked``).

Mixed dtypes: where the reference's ``jnp.einsum`` meets a bf16 and a
float32 operand it promotes to float32; here the bf16 operands are cast
to float32 first, and each four-operand einsum is split into two-operand
steps, which bounds the intermediates to one [B, H, C, Q, Q] float32
decay tensor per layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import causal_conv1d, conv1d_step, rms_norm
from repro_torch.models.sharding import MeshCtx, P


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: [..., q] -> lower-triangular pairwise cumulative sums [..., q, q]
    (-inf above the diagonal)."""
    q = x.shape[-1]
    xc = torch.cumsum(x, dim=-1)
    d = xc[..., :, None] - xc[..., None, :]
    i = torch.arange(q, device=x.device)
    return d.masked_fill(i[:, None] < i[None, :], float("-inf"))


def ssd_chunked(x: torch.Tensor, a_bar: torch.Tensor, b_mat: torch.Tensor,
                c_mat: torch.Tensor, chunk: int):
    """SSD scan.  x: [B, S, H, Pd] (dt-premultiplied); a_bar: [B, S, H]
    (dt * A, float32); b_mat / c_mat: [B, S, N] (one group, broadcast over
    heads).  Returns y [B, S, H, Pd] and the final state [B, H, Pd, N],
    both float32 (the reference's promotion of its bf16 operands)."""
    bsz, s0, h, pd = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, s0)
    pad = (-s0) % q
    x, b_mat, c_mat = x.float(), b_mat.float(), c_mat.float()
    a_bar = a_bar.float()
    if pad:     # a_bar = 0 => decay 1 (state kept); x = 0 => no contribution
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a_bar = F.pad(a_bar, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    s = s0 + pad
    nc = s // q

    xc = x.reshape(bsz, nc, q, h, pd)
    ac = a_bar.reshape(bsz, nc, q, h).permute(0, 3, 1, 2)       # [b,h,c,q]
    bc = b_mat.reshape(bsz, nc, q, n)
    cc = c_mat.reshape(bsz, nc, q, n)
    a_cum = torch.cumsum(ac, dim=-1)                            # [b,h,c,q]

    # 1. intra-chunk (diagonal blocks): (C B^T) * L, then times x
    # (out of place: autograd keeps exp's output for its gradient)
    l_mat = torch.exp(_segsum(ac)) \
        * torch.einsum("bcln,bcsn->bcls", cc, bc)[:, None]     # [b,h,c,l,s]
    y = torch.einsum("bhcls,bcshp->bclhp", l_mat, xc)
    del l_mat

    # 2. per-chunk final states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)           # [b,h,c,q]
    states = torch.einsum("bcln,bclhp->bchpn", bc,
                          xc * decay_states.permute(0, 2, 3, 1)[..., None])

    # 3. inter-chunk recurrence as a (c+1) x (c+1) decay product
    chunk_decay = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0))))
    states_in = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    all_states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states_in)
    prev_states, final_state = all_states[:, :-1], all_states[:, -1]

    # 4. inter-chunk contribution to the outputs
    out_decay = torch.exp(a_cum).permute(0, 2, 3, 1)[..., None]  # [b,c,l,h,1]
    y += torch.einsum("bcln,bchpn->bclhp", cc, prev_states) * out_decay
    return y.reshape(bsz, s, h, pd)[:, :s0], final_state


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

def _conv_state(xs: torch.Tensor, width: int) -> torch.Tensor:
    """The conv state a prefill leaves: the raw inputs [B, W-1, C] of the
    last W-1 positions, left-padded with zeros when S < W-1."""
    s = xs.shape[1]
    if s >= width - 1:
        return xs[:, s - (width - 1):, :]
    return F.pad(xs, (0, 0, width - 1 - s, 0))


def mamba_block(p, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
                cache: dict | None = None):
    """x: [B, S, D].  ``mode`` "train" (no cache), "prefill" (returns the
    layer's new cache) or "decode" (S = 1; cache {"conv": [B, W-1, Cc],
    "state": [B, H, Pd, N]}, returns the new one).  Returns (x + out,
    cache)."""
    bsz, s, _ = x.shape
    d_in, ds, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, \
        cfg.ssm_headdim
    u = rms_norm(x, p["ln"])
    z = u @ p["wz"].to(u.dtype)
    xbc = u @ p["wxbc"].to(u.dtype)
    dt = u @ p["wdt"].to(u.dtype)
    dt = F.softplus(dt.float() + p["dt_bias"].float())          # [B, S, H]
    a = -torch.exp(p["A_log"].float())                          # [H]

    new_cache = cache
    if mode == "decode":
        xbc_t, conv_state = conv1d_step(xbc[:, 0], cache["conv"],
                                        p["conv_w"], p["conv_b"])
        xbc_t = F.silu(xbc_t)
        xs = xbc_t[..., :d_in].reshape(bsz, h, pd).float()
        b_t = xbc_t[..., d_in:d_in + ds].float()
        c_t = xbc_t[..., d_in + ds:].float()
        dt_t = dt[:, 0]                                         # [B, H]
        a_bar = torch.exp(dt_t * a[None])                       # [B, H]
        st = cache["state"].float()
        st = (a_bar[..., None, None] * st
              + (dt_t[..., None] * xs)[..., None] * b_t[:, None, None, :])
        y = torch.einsum("bhpn,bn->bhp", st, c_t)
        y = y + p["D"].float()[None, :, None] * xs
        y = y.reshape(bsz, 1, d_in).to(x.dtype)
        new_cache = {"conv": conv_state,
                     "state": st.to(cache["state"].dtype)}
    else:
        xbc_c = F.silu(causal_conv1d(xbc, p["conv_w"], p["conv_b"]))
        xs = xbc_c[..., :d_in].reshape(bsz, s, h, pd)
        b_mat = xbc_c[..., d_in:d_in + ds]
        c_mat = xbc_c[..., d_in + ds:]
        x_bar = (xs.float() * dt[..., None]).to(x.dtype)
        y, final_state = ssd_chunked(x_bar, dt * a[None, None], b_mat,
                                     c_mat, cfg.ssd_chunk)
        y = y + p["D"].to(y.dtype)[None, None, :, None] * xs.to(y.dtype)
        y = y.reshape(bsz, s, d_in).to(x.dtype)
        if mode == "prefill":
            new_cache = {"conv": _conv_state(xbc, p["conv_w"].shape[-1]),
                         "state": final_state.to(x.dtype)}

    y = rms_norm(y * F.silu(z if mode != "decode" else z[:, :1]),
                 p["ssm_ln"])
    return x + y @ p["out_proj"].to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# Model-level
# ---------------------------------------------------------------------------

def ssm_param_shapes(cfg: ArchConfig) -> dict:
    n, d = cfg.num_layers, cfg.d_model
    d_in, ds, g, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups, \
        cfg.ssm_nheads
    conv_dim = d_in + 2 * g * ds
    layers = {
        "ln": (n, d),
        "wz": (n, d, d_in),
        "wxbc": (n, d, conv_dim),
        "wdt": (n, d, h),
        "conv_w": (n, conv_dim, cfg.conv_width),
        "conv_b": (n, conv_dim),
        "A_log": (n, h), "D": (n, h), "dt_bias": (n, h),
        "ssm_ln": (n, d_in),
        "out_proj": (n, d_in, d),
    }
    return {"embed": (cfg.padded_vocab, d), "ln_f": (d,), "layers": layers}


def ssm_param_specs(cfg: ArchConfig, mctx: MeshCtx) -> dict:
    dp = mctx.dp if cfg.fsdp else None
    layers = {
        "ln": P(None, None),
        "wz": P(None, dp, "model"),
        "wxbc": P(None, dp, "model"),
        "wdt": P(None, dp, None),            # nheads may not divide the axis
        "conv_w": P(None, "model", None),
        "conv_b": P(None, "model"),
        "A_log": P(None, None), "D": P(None, None), "dt_bias": P(None, None),
        "ssm_ln": P(None, "model"),
        "out_proj": P(None, "model", dp),
    }
    return {"embed": P("model", None), "ln_f": P(None), "layers": layers}


def init_ssm_params(cfg: ArchConfig, generator: torch.Generator,
                    device=None, dtype: torch.dtype | None = None,
                    blocks: dict | None = None) -> dict:
    """The SSM tree, drawn as ``transformer._init_from_shapes`` draws."""
    return tfm._init_from_shapes(ssm_param_shapes(cfg), cfg, generator,
                                 device, dtype, blocks)


def ssm_cache_shapes(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    n = cfg.num_layers
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {"conv": (n, batch, cfg.conv_width - 1, conv_dim),
            "state": (n, batch, cfg.ssm_nheads, cfg.ssm_headdim,
                      cfg.ssm_state)}


def ssm_cache_specs(cfg: ArchConfig, mctx: MeshCtx, seq_len: int = 0
                    ) -> dict:
    dp = mctx.dp
    tp = mctx.tp_size
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    conv_spec = P(None, dp, None, "model") if conv_dim % tp == 0 \
        else P(None, dp, None, None)
    state_spec = P(None, dp, None, None, "model") \
        if cfg.ssm_state % tp == 0 else P(None, dp, None, None, None)
    return {"conv": conv_spec, "state": state_spec}


def _train_layer(cfg: ArchConfig):
    def body(x, p):
        return mamba_block(p, x, cfg, mode="train")[0]
    return body


def _stack(params, x: torch.Tensor, cfg: ArchConfig, mode: str,
           caches: dict | None) -> torch.Tensor:
    """Every layer in turn (the reference's ``_stack_scan``), each layer's
    new cache written into ``caches`` [L, ...] in place; "train" takes no
    caches and runs each layer under ``remat``."""
    layers = tfm._layers(params["layers"])
    if caches is None:
        body = _train_layer(cfg)
        for p in layers:
            x = tfm.remat(cfg, body, x, p)
        return x
    for i, p in enumerate(layers):
        cache = {k: c[i] for k, c in caches.items()}
        x, new = mamba_block(p, x, cfg, mode=mode,
                             cache=cache if mode == "decode" else None)
        for k, c in cache.items():
            c.copy_(new[k])
    return x


def ssm_loss(params, batch: dict, cfg: ArchConfig,
             mctx: MeshCtx | None = None, *,
             global_batch: int | None = None) -> torch.Tensor:
    """The training loss (float32 scalar) of ``batch["tokens"]`` [B, S]:
    the SSD stack in "train" mode, then the next-token cross-entropy
    against the (tied) embedding.  On a mesh over ranks ``params`` and the
    tokens are this rank's blocks, as for ``ssm_prefill``, and every rank
    returns the loss of the whole global batch (``_ssm_loss_ranked``)."""
    tokens = batch["tokens"]
    if tfm.on_ranks(mctx):
        return _ssm_loss_ranked(params, tokens, cfg, mctx, global_batch)
    x = _stack(params, tfm._embed_tokens(params, tokens, cfg), cfg, "train",
               None)
    x = rms_norm(x, params["ln_f"])
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return tfm.next_token_loss(x, tokens, unembed, cfg)


def ssm_prefill(params, batch: dict, cfg: ArchConfig,
                mctx: MeshCtx | None = None, *,
                global_batch: int | None = None):
    """batch["tokens"]: [B, S] ids.  Returns (last-token logits [B, V]
    float32, caches).  On a mesh over ranks every argument and result is
    this rank's block, as for ``transformer.decoder_prefill``: ``params``
    under ``ssm_param_specs``, the tokens of ``global_batch`` rows, the
    caches under ``ssm_cache_specs`` (``_ssm_ranked``)."""
    tokens = batch["tokens"]
    if tfm.on_ranks(mctx):
        return _ssm_ranked(params, None, tokens, cfg, mctx, global_batch)
    x = tfm._embed_tokens(params, tokens, cfg)
    caches = tfm._alloc(ssm_cache_shapes(cfg, *tokens.shape), x)
    x = _stack(params, x, cfg, "prefill", caches)
    x = rms_norm(x[:, -1], params["ln_f"])
    return tfm._logits(params, x, cfg), caches


def ssm_decode_step(params, caches: dict, tokens: torch.Tensor, t: int,
                    cfg: ArchConfig, mctx: MeshCtx | None = None, *,
                    global_batch: int | None = None,
                    n_slots: int | None = None):
    """tokens: [B, 1] new token ids (the position ``t`` is not read: the
    state carries it).  Writes the new conv and SSM states into
    ``caches`` in place.  Returns (logits [B, V] float32, caches).  On a
    mesh over ranks the arguments and results are this rank's blocks, as
    for ``ssm_prefill`` (``n_slots`` is not read: the caches hold no
    slots)."""
    if tfm.on_ranks(mctx):
        return _ssm_ranked(params, caches, tokens, cfg, mctx, global_batch)
    x = tfm._embed_tokens(params, tokens, cfg)
    x = _stack(params, x, cfg, "decode", caches)
    x = rms_norm(x[:, -1], params["ln_f"])
    return tfm._logits(params, x, cfg), caches


# ---------------------------------------------------------------------------
# Across ranks
# ---------------------------------------------------------------------------

def _ssm_ranked(params, caches: dict | None, tokens: torch.Tensor,
                cfg: ArchConfig, mctx: MeshCtx, global_batch):
    """``ssm_prefill`` (``caches`` None) or ``ssm_decode_step`` on this
    rank: the vocab-parallel embedding, each layer's weights gathered
    from their FSDP blocks (``_Ranks.layer``), ``_mamba_ranked``, then
    this rank's block of the logits against its rows of the tied
    embedding."""
    rk = tfm._Ranks(cfg, mctx, global_batch, tokens.shape[0], None,
                    {"layers": ssm_param_specs(cfg, mctx)["layers"]},
                    _COMPUTED)
    x = tfm._embed_ranked(params, tokens, cfg, rk)
    mode = "decode" if caches is not None else "prefill"
    if caches is None:
        caches = tfm._cache_alloc(
            ssm_cache_shapes(cfg, global_batch, tokens.shape[1]),
            ssm_cache_specs(cfg, mctx), rk, x)
    whole = () if mode == "decode" else ("wxbc", "conv_w", "conv_b")
    for p, cache in zip(tfm._layers(params["layers"]), tfm._layers(caches)):
        p = rk.layer("layers", p, whole)
        x, new = _mamba_ranked(p, x, cfg, rk, mode=mode, cache=cache)
        for k, c in cache.items():
            c.copy_(new[k])
        del p, new
    x = rms_norm(x[:, -1], params["ln_f"])
    return tfm._logits(params, x, cfg), caches


def _ssm_loss_ranked(params, tokens: torch.Tensor, cfg: ArchConfig,
                     mctx: MeshCtx, global_batch) -> torch.Tensor:
    """``ssm_loss`` on this rank: the vocab-parallel embedding, then per
    layer, under ``remat`` with its gathers, the weights in the computed
    layout (``wxbc`` and the conv filters whole) and ``_mamba_ranked`` in
    "train" mode; ``ln_f`` and the vocab-parallel cross-entropy against
    the tied embedding's rows (its block transposed)."""
    rk = tfm._Ranks(cfg, mctx, global_batch, tokens.shape[0], None,
                    {"layers": ssm_param_specs(cfg, mctx)["layers"]},
                    _COMPUTED)

    def layer(x, p):
        p = rk.layer("layers", p, ("wxbc", "conv_w", "conv_b"))
        return _mamba_ranked(p, x, cfg, rk, mode="train", cache=None)[0]

    x = tfm._embed_ranked(params, tokens, cfg, rk)
    for p in tfm._layers(params["layers"]):
        x = tfm.remat(cfg, layer, x, p)
    x = rms_norm(x, params["ln_f"])
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return tfm.next_token_loss(x, tokens, unembed, cfg, rk)


# The layout each mamba leaf takes where its product runs: column-parallel
# ``wz`` and ``wxbc``, every head's ``wdt``, ``A_log``, ``D`` and
# ``dt_bias``, the conv filters and ``ssm_ln`` per channel as stored over
# ``model``, row-parallel ``out_proj`` (the stored FSDP cut dropped)
_COMPUTED = {"ln": P(), "wz": P(None, "model"), "wxbc": P(None, "model"),
             "wdt": P(), "A_log": P(), "D": P(), "dt_bias": P(),
             "conv_w": P("model", None), "conv_b": P("model"),
             "ssm_ln": P("model"), "out_proj": P("model", None)}


def _head_span(cfg: ArchConfig, tp: int, r: int) -> tuple[int, int, int]:
    """The heads [h0, h1) whose channels cover rank ``r``'s block of
    ``d_inner`` (``wz``'s columns, ``ssm_ln``'s and ``out_proj``'s rows:
    ``d_inner / tp`` channels, which may cut a head), and the block's
    offset into the span's channels."""
    cols, pd = cfg.d_inner // tp, cfg.ssm_headdim
    h0 = r * cols // pd
    return h0, -(-(r + 1) * cols // pd), r * cols - h0 * pd


def _states_to_store(fs: torch.Tensor, cfg: ArchConfig, rk) -> torch.Tensor:
    """The prefill's final states of this rank's head span ``fs`` [B, span,
    Pd, N] as the stored cache block: every head's states, gathered over
    ``model`` (each rank's span padded to the longest; a head taken from
    the rank whose block holds its first channel), cut to this rank's
    block of N where ``ssm_cache_specs`` splits N over ``model``."""
    tp, h = rk.tp, cfg.ssm_nheads
    cols, pd = cfg.d_inner // tp, cfg.ssm_headdim
    spans = [_head_span(cfg, tp, r) for r in range(tp)]
    m = max(h1 - h0 for h0, h1, _ in spans)
    fs = F.pad(fs, (0, 0, 0, 0, 0, m - fs.shape[1]))
    full = rk.mesh.all_gather(fs, "model", dim=1)           # [B, tp*m, ..]
    idx = [(j * pd // cols) * m + j - spans[j * pd // cols][0]
           for j in range(h)]
    if idx != list(range(h)):
        full = full.index_select(1, torch.tensor(idx, device=fs.device))
    if cfg.ssm_state % tp == 0:
        nb = cfg.ssm_state // tp
        full = full[..., rk.r * nb:(rk.r + 1) * nb]
    return full


def _mamba_ranked(p, x: torch.Tensor, cfg: ArchConfig, rk, *, mode: str,
                  cache: dict | None):
    """``mamba_block`` on this rank, ``p`` in the computed layout.  The
    gate ``z``, the norm ``ssm_ln`` and ``out_proj``'s rows are this
    rank's block of ``d_inner`` (a row-parallel product, summed over
    ``model``); ``ssm_ln``'s mean of squares is summed over ``model`` too,
    and enters this rank's block through ``pvary``.  ``dt`` is every
    head's (``wdt`` whole), taken from the normed input before its
    ``pvary``: work every rank does alike.

    Prefill and "train" (``wxbc`` and the conv filters gathered whole):
    the SSD runs on this rank's head span, from x's channels of those
    heads and all of B and C (the column cut of ``wxbc`` does not follow
    the x | B | C split).  The prefill's cache takes the raw ``xbc`` of
    the last W-1 positions in its stored channel block and the final
    states relaid to the stored layout (``_states_to_store``); "train"
    keeps none, and its per-head ``dt``, decay and skip ``D``, the same
    on every rank, enter the head span through one ``pvary``, so that
    each is differentiated whole (the ranks' spans summed) and not by
    this rank's span alone.

    Decode: the conv step runs in the stored layout (per channel, on this
    rank's block of ``wxbc``'s columns and of the conv state), its output
    gathered over ``model``; the SSM state is updated in its stored layout,
    this rank's block of N of every head (or all of it where N is not
    split), and y's partial sums over N are summed over ``model``."""
    bsz, s, _ = x.shape
    d_in, ds, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, \
        cfg.ssm_headdim
    tp, r = rk.tp, rk.r
    cols = d_in // tp
    hn = rms_norm(x, p["ln"])
    u = rk.mesh.pvary(hn, "model")
    z = u @ p["wz"].to(u.dtype)
    dt = hn @ p["wdt"].to(hn.dtype)
    dt = F.softplus(dt.float() + p["dt_bias"].float())          # [B, S, H]
    a = -torch.exp(p["A_log"].float())                          # [H]
    d_skip = p["D"].float()
    new = None
    if mode == "decode":
        xbc_t, conv_state = conv1d_step((u @ p["wxbc"].to(u.dtype))[:, 0],
                                        cache["conv"], p["conv_w"],
                                        p["conv_b"])
        xbc_t = rk.mesh.all_gather(F.silu(xbc_t), "model", dim=-1)
        xs = xbc_t[..., :d_in].reshape(bsz, h, pd).float()
        n0, n1 = 0, ds
        if ds % tp == 0:
            n0, n1 = r * ds // tp, (r + 1) * ds // tp
        b_t = xbc_t[..., d_in + n0:d_in + n1].float()
        c_t = xbc_t[..., d_in + ds + n0:d_in + ds + n1].float()
        dt_t = dt[:, 0]                                         # [B, H]
        a_bar = torch.exp(dt_t * a[None])                       # [B, H]
        st = cache["state"].float()
        st = (a_bar[..., None, None] * st
              + (dt_t[..., None] * xs)[..., None] * b_t[:, None, None, :])
        y = torch.einsum("bhpn,bn->bhp", st, c_t)
        if ds % tp == 0:
            y = rk.mesh.psum(y, "model")
        y = y + d_skip[None, :, None] * xs
        y = y.reshape(bsz, 1, d_in)[..., r * cols:(r + 1) * cols]
        y = y.to(x.dtype)
        new = {"conv": conv_state, "state": st.to(cache["state"].dtype)}
    else:
        if mode == "train":
            dt, a, d_skip = _pvary_all(rk, dt, a, d_skip)
        h0, h1, off = _head_span(cfg, tp, r)
        w = p["wxbc"]
        w_need = torch.cat([w[:, h0 * pd:h1 * pd], w[:, d_in:]], dim=1)
        cw, cb = p["conv_w"], p["conv_b"]
        xbc = u @ w_need.to(u.dtype)
        xbc_c = F.silu(causal_conv1d(
            xbc, torch.cat([cw[h0 * pd:h1 * pd], cw[d_in:]]),
            torch.cat([cb[h0 * pd:h1 * pd], cb[d_in:]])))
        nx = (h1 - h0) * pd
        xs = xbc_c[..., :nx].reshape(bsz, s, h1 - h0, pd)
        b_mat, c_mat = xbc_c[..., nx:nx + ds], xbc_c[..., nx + ds:]
        dt_h = dt[..., h0:h1]
        x_bar = (xs.float() * dt_h[..., None]).to(x.dtype)
        y, final_state = ssd_chunked(x_bar, dt_h * a[None, None, h0:h1],
                                     b_mat, c_mat, cfg.ssd_chunk)
        y = y + d_skip[h0:h1].to(y.dtype)[None, None, :, None] \
            * xs.to(y.dtype)
        y = y.reshape(bsz, s, nx)[..., off:off + cols].to(x.dtype)
        if mode == "prefill":
            # the conv state: the raw xbc of the stored channel block
            cc = w.shape[1] // tp
            width = cw.shape[-1]
            tail = u[:, max(0, s - (width - 1)):] \
                @ w[:, r * cc:(r + 1) * cc].to(u.dtype)
            new = {"conv": _conv_state(tail, width),
                   "state": _states_to_store(final_state.to(x.dtype), cfg,
                                             rk)}
    g = (y * F.silu(z)).float()
    ss = rk.mesh.psum((g * g).sum(-1, keepdim=True), "model")
    ss = rk.mesh.pvary(ss, "model")
    g = (g * torch.rsqrt(ss / d_in + 1e-6) * p["ssm_ln"].float()).to(x.dtype)
    return x + rk.mesh.psum(g @ p["out_proj"].to(x.dtype), "model"), new


def _pvary_all(rk, *xs: torch.Tensor) -> list:
    """``xs`` (float32, the same on every rank of ``model``) through one
    ``pvary`` over ``model`` (their concatenation): one psum of their
    cotangents in the backward pass."""
    flat = rk.mesh.pvary(torch.cat([t.reshape(-1) for t in xs]), "model")
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in xs]), xs)]
