"""Plain float32 decoder (the ``dense`` family): RMSNorm, half-split
rotary, grouped-query attention under a causal sliding window, SwiGLU,
tied or untied logits, next-token cross-entropy and AdamW.

Written from the published description (Llama / Mistral style blocks, as
h2o-danube-1.8b and Mixtral use them) in plain ``torch`` operations,
without kernels, caches or batching tricks.  Departures, all of them the
configuration as the port runs it: RMSNorm's epsilon is 1e-6; AdamW
decays every leaf of two or more dimensions of the port's stacked tree,
so each layer's norm scales decay and the final norm's does not.

``quant="fp8"`` computes every product the program computes in its
compute dtype with both operands rounded to float8 (e4m3) under a scale
per tensor, the forward and the backward alike: the control, the
precision below bf16, that the comparison must fail.  Matrix products
run with TF32 off (``exact_matmul``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-6
FP8_MAX = 448.0


def exact_matmul() -> None:
    """float32 products in float32 (TF32 is a lower precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Round(torch.autograd.Function):
    """Rounding to float8 whose gradient is rounded to float8 too, each
    under its own scale."""

    @staticmethod
    def forward(ctx, t):
        return _round8(t)

    @staticmethod
    def backward(ctx, g):
        return _round8(g)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a scale per tensor (its largest
    magnitude to 448), back in float32."""
    return _Fp8Round.apply(t)


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _round8(x) @ _round8(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g8 = _round8(g)
        return (g8 @ _round8(w).transpose(-1, -2),
                _round8(x).transpose(-1, -2) @ g8)


def mm(x: torch.Tensor, w: torch.Tensor, quant: str | None = None
       ) -> torch.Tensor:
    """x @ w in float32, or in the control's precision."""
    if quant == "fp8":
        return _Fp8Matmul.apply(x, w)
    return x @ w


def rnd(t: torch.Tensor, quant: str | None) -> torch.Tensor:
    return fp8(t) if quant == "fp8" else t


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of x [B, S, H, D] at positions pos [S]."""
    half = x.shape[-1] // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[:, None] * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


BLOCK = 1 << 28             # score elements a block of the attention holds


def attention(q, k, v, qpos, kpos, window, quant=None):
    """q [B, S, Hq, D] against k, v [B, T, Hk, D]; query at qpos [S]
    attends keys at kpos [T] with ``qpos - window < kpos <= qpos``.
    Softmax in float32, over blocks of rows and queries that hold at most
    ``BLOCK`` scores."""
    b, s, hq, d = q.shape
    hk, t = k.shape[2], k.shape[1]
    g = hq // hk
    n = min(s, max(1, BLOCK // (hq * t)))
    bb = max(1, BLOCK // (hq * n * t))
    kt = rnd(k, quant).permute(0, 2, 3, 1)[:, :, None]     # [B,Hk,1,D,T]
    vt = rnd(v, quant).permute(0, 2, 1, 3)[:, :, None]     # [B,Hk,1,T,D]
    rows = []
    for r in range(0, b, bb):
        outs = []
        for i in range(0, s, n):
            qb = rnd(q[r:r + bb, i:i + n], quant)
            nb, ni = qb.shape[:2]
            qg = qb.reshape(nb, ni, hk, g, d).permute(0, 2, 3, 1, 4)
            sc = (qg @ kt[r:r + bb]) * d ** -0.5           # [b,Hk,G,n,T]
            qp = qpos[i:i + n][:, None]
            ok = kpos[None, :] <= qp
            if window is not None:
                ok = ok & (kpos[None, :] > qp - window)
            sc = sc.masked_fill(~ok, float("-inf"))
            p = torch.softmax(sc, dim=-1)
            o = rnd(p, quant) @ vt[r:r + bb]               # [b,Hk,G,n,D]
            outs.append(o.permute(0, 3, 1, 2, 4).reshape(nb, ni, hq, d))
        rows.append(torch.cat(outs, dim=1))
    return torch.cat(rows, dim=0)


def ffn(h: torch.Tensor, w: dict, a: dict, groups: str | None = None,
        quant: str | None = None) -> torch.Tensor:
    """SwiGLU: (silu(h Wg) * h Wu) Wd."""
    return mm(F.silu(mm(h, w["wg"], quant)) * mm(h, w["wu"], quant),
              w["wd"], quant)


def block(x, w, pos, a, ffn_fn, *, prefix=None, groups=None, quant=None):
    """One pre-norm layer over x [B, S, d] at positions pos [S], its keys
    and values after ``prefix`` ((k, v) [B, P, Hk, D] of positions
    0..P-1) when given.  Returns (x, (k, v) of x's positions)."""
    b, s, _ = x.shape
    hq, hk, hd = a["num_heads"], a["num_kv_heads"], a["head_dim"]
    h = rms_norm(x, w["ln1"])
    q = mm(h, w["wq"], quant).reshape(b, s, hq, hd)
    k = mm(h, w["wk"], quant).reshape(b, s, hk, hd)
    v = mm(h, w["wv"], quant).reshape(b, s, hk, hd)
    q, k = rope(q, pos, a["rope_theta"]), rope(k, pos, a["rope_theta"])
    kk, vv, kpos = k, v, pos
    if prefix is not None:
        pk, pv = prefix
        kk, vv = torch.cat([pk, k], 1), torch.cat([pv, v], 1)
        kpos = torch.cat([torch.arange(pk.shape[1], device=x.device), pos])
    o = attention(q, kk, vv, pos, kpos, a.get("window"), quant)
    x = x + mm(o.reshape(b, s, hq * hd), w["wo"], quant)
    x = x + ffn_fn(rms_norm(x, w["ln2"]), w, a, groups, quant)
    return x, (k, v)


def unembed(top: dict, a: dict) -> torch.Tensor:
    return top["embed"].T if a.get("tie_embeddings") else top["unembed"]


def logits(x: torch.Tensor, top: dict, a: dict) -> torch.Tensor:
    """float32 logits of final hidden states (the port takes them in
    float32 when it serves, so the control leaves them so)."""
    return rms_norm(x, top["ln_f"]) @ unembed(top, a)


def _nll(x, top, a, labels, quant):
    lg = mm(rms_norm(x, top["ln_f"]), unembed(top, a), quant)
    return F.cross_entropy(lg, labels, reduction="sum")


def loss_sum(top: dict, layers: list, tokens: torch.Tensor, a: dict,
             quant: str | None = None, chunk: int = 2048) -> torch.Tensor:
    """Sum of next-token NLLs of tokens [R, S] (label i is token i + 1; the
    last position has none), each layer and each chunk of the logits
    recomputed in the backward pass."""
    r, s = tokens.shape
    x = rnd(top["embed"][tokens], quant)
    pos = torch.arange(s, device=tokens.device)
    for w in layers:
        x = checkpoint(lambda x_, w_: block(x_, w_, pos, a, ffn, quant=quant)[0],
                       x, w, use_reentrant=False)
    xf = x[:, :-1].reshape(-1, x.shape[-1])
    labels = tokens[:, 1:].reshape(-1)
    total = x.new_zeros(())
    for i in range(0, xf.shape[0], chunk):
        total = total + checkpoint(_nll, xf[i:i + chunk], top, a,
                                   labels[i:i + chunk], quant,
                                   use_reentrant=False)
    return total


ADAMW = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0)


@torch.no_grad()
def adamw(leaves: list, grads: list, m: list, v: list, step: int,
          decay: list, lr: float) -> tuple[float, list]:
    """One AdamW step over lists of float32 leaves, in place: the
    gradients clipped to a global norm of ``grad_clip``, bias-corrected
    moments, decoupled weight decay where ``decay``.  Returns (the
    global norm before clipping, each clipped gradient's norm)."""
    c = ADAMW
    gnorm = math.sqrt(sum(float((g * g).sum()) for g in grads))
    clip = min(1.0, c["grad_clip"] / max(gnorm, 1e-9))
    clipped = []
    for p, g, mi, vi, dec in zip(leaves, grads, m, v, decay):
        g = g * clip
        clipped.append(float(torch.linalg.vector_norm(g)))
        mi.mul_(c["b1"]).add_(g, alpha=1 - c["b1"])
        vi.mul_(c["b2"]).addcmul_(g, g, value=1 - c["b2"])
        mhat = mi / (1 - c["b1"] ** step)
        vhat = vi / (1 - c["b2"] ** step)
        delta = mhat / (vhat.sqrt() + c["eps"])
        if dec:
            delta = delta + c["weight_decay"] * p
        p.sub_(lr * delta)
    return gnorm, clipped
