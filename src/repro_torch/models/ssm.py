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
                    device=None, dtype: torch.dtype | None = None) -> dict:
    """The SSM tree, drawn as ``transformer._init_from_shapes`` draws."""
    return tfm._init_from_shapes(ssm_param_shapes(cfg), cfg, generator,
                                 device, dtype)


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


def ssm_loss(params, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """The training loss (float32 scalar) of ``batch["tokens"]`` [B, S]:
    the SSD stack in "train" mode, then the next-token cross-entropy
    against the (tied) embedding."""
    tokens = batch["tokens"]
    x = _stack(params, tfm._embed_tokens(params, tokens, cfg), cfg, "train",
               None)
    x = rms_norm(x, params["ln_f"])
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return tfm.next_token_loss(x, tokens, unembed, cfg)


def ssm_prefill(params, batch: dict, cfg: ArchConfig):
    """batch["tokens"]: [B, S] ids.  Returns (last-token logits [B, V]
    float32, caches)."""
    tokens = batch["tokens"]
    x = tfm._embed_tokens(params, tokens, cfg)
    caches = tfm._alloc(ssm_cache_shapes(cfg, *tokens.shape), x)
    x = _stack(params, x, cfg, "prefill", caches)
    x = rms_norm(x[:, -1], params["ln_f"])
    return tfm._logits(params, x, cfg), caches


def ssm_decode_step(params, caches: dict, tokens: torch.Tensor, t: int,
                    cfg: ArchConfig):
    """tokens: [B, 1] new token ids (the position ``t`` is not read: the
    state carries it).  Writes the new conv and SSM states into
    ``caches`` in place.  Returns (logits [B, V] float32, caches)."""
    x = tfm._embed_tokens(params, tokens, cfg)
    x = _stack(params, x, cfg, "decode", caches)
    x = rms_norm(x[:, -1], params["ln_f"])
    return tfm._logits(params, x, cfg), caches
