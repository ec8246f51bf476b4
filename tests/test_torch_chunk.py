"""llama4's chunked local attention in the port against the JAX package.

A query attends only keys of its own chunk of ``chunk_attn`` positions
(``k // c == q // c``, floor division) on top of the causal mask.  The
port's ``flash_attention_ref`` (the plain version of the CUDA kernel,
what ``flash_attn.ops.attention`` runs on the CPU) and the decoder's
``layers.chunked_attention`` are held against the reference's model
layer ``repro.models.layers.chunked_attention`` on the same seeded
inputs: chunks that are and are not a multiple of its key chunk, a chunk
edge inside the sequence, suffix-aligned queries (Sq < Skv), a window
and a chunk together, no causal mask, GQA.  Skv is a multiple of
``kv_chunk`` (the reference reads a clamped last chunk under wrong
positions otherwise; ROADMAP, Reference caveats).  Rows at negative
positions (causal with Sq > Skv, which the reference averages instead)
are held against a mask written out here.  Then the reduced
llama4-maverick (``chunk_attn`` 32, four layers, MoE every second, a
shared expert) through both models: a 64-token prefill (two chunks) and
40 teacher-forced decode steps, the first at a chunk start (t = 64), one
crossing the next edge (t = 96), max|Δ|/max|ref| 1e-4 in float32 and
3e-2 in bfloat16 (``tests/torch_model_parity.py``).  Attention
tolerances: 1e-5 in float32 (sums in another order), 2e-2 in bfloat16
(one output rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.transformer import _ring_positions  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from torch_model_parity import (assert_close, jax_params,  # noqa: E402
                                run_both)

LLAMA4 = "llama4-maverick-400b-a17b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b, hq, hk, sq, skv, d, dtype):
    r = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    out = []
    for shape in ((b, hq, sq, d), (b, hk, skv, d), (b, hk, skv, d)):
        a = r.normal(size=shape).astype(np.float32)
        out.append((jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)))
    return out


# (sq, skv, hq, hk, causal, window, chunk): a chunk a multiple of the
# reference's 32-key chunk and not (48, 100), one chunk past the sequence
# (160), suffix-aligned queries, a window inside the chunk and one across
# it, no causal mask (Sq = Skv, where both align queries alike), GQA 3:1
CASES = [(128, 128, 4, 2, True, None, 32), (128, 128, 4, 2, True, None, 48),
         (128, 128, 4, 2, True, None, 100), (128, 128, 4, 2, True, None, 160),
         (64, 128, 4, 2, True, None, 40), (1, 128, 4, 2, True, None, 32),
         (96, 96, 3, 1, True, 16, 32), (96, 96, 3, 1, True, 40, 32),
         (128, 128, 4, 2, False, None, 32), (96, 96, 4, 4, False, None, 40)]


@pytest.mark.parametrize("sq,skv,hq,hk,causal,window,chunk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_mask_matches_reference_layer(sq, skv, hq, hk, causal, window,
                                            chunk, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(sq + skv + chunk, 2, hq, hk, sq,
                                           skv, 32, dtype)
    want = jax_layers.chunked_attention(jq, jk, jv, causal=causal,
                                        window=window, chunk_attn=chunk,
                                        q_chunk=32, kv_chunk=32)
    got = flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                              chunk_attn=chunk)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=0)
    # the decoder's layer and the kernel's public op take the same path
    for fn in (layers.chunked_attention, flash_ops.attention):
        assert torch.equal(fn(tq, tk, tv, causal=causal, window=window,
                              chunk_attn=chunk), got)


def _mask(sq: int, skv: int, causal: bool, window, chunk) -> np.ndarray:
    """[Sq, Skv] keys kept, written out with Python's floor division."""
    keep = np.zeros((sq, skv), bool)
    for i in range(sq):
        pos = i + skv - sq
        for k in range(skv):
            keep[i, k] = ((not causal or k <= pos)
                          and (window is None or k > pos - window)
                          and (chunk is None or k // chunk == pos // chunk))
    return keep


@pytest.mark.parametrize("sq,skv,chunk", [(100, 40, 16), (70, 64, 32),
                                          (40, 40, 7)])
def test_chunk_mask_floor_divides_negative_positions(sq, skv, chunk):
    """Causal with Sq > Skv puts the first rows at negative positions; the
    chunk of position -1 is [-c, 0), which holds no key, so those rows see
    none and give zeros.  Every other row equals a softmax over the keys
    the written-out mask keeps."""
    g = torch.Generator().manual_seed(sq + chunk)
    q = torch.randn((2, 2, sq, 16), generator=g)
    k, v = (torch.randn((2, 1, skv, 16), generator=g) for _ in range(2))
    got = flash_attention_ref(q, k, v, causal=True, chunk_attn=chunk)
    keep = torch.from_numpy(_mask(sq, skv, True, None, chunk))
    scores = torch.einsum("bhqd,bkd->bhqk", q, k[:, 0]) * 16 ** -0.5
    p = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
    want = torch.einsum("bhqk,bkd->bhqd", p.nan_to_num(0.0), v[:, 0])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not keep[:sq - skv].any()
    assert torch.equal(got[:, :, :sq - skv], torch.zeros_like(
        got[:, :, :sq - skv]))


# (t, slots, chunk): the serve path's cache (t < slots) at a chunk start,
# just past it and just before the next one
@pytest.mark.parametrize("t,s,chunk", [(64, 104, 32), (65, 104, 32),
                                       (95, 104, 32), (96, 104, 32),
                                       (8192, 10304, 8192)])
def test_decode_at_a_chunk_start_reads_one_slot(t, s, chunk):
    """At a chunk start the decode mask leaves only the new token's slot;
    the slot range the card reads is the reference's mask exactly."""
    pos = np.asarray(_ring_positions(t, s))
    mask = (pos >= 0) & (pos <= t) & (pos // chunk == t // chunk)
    lo, hi = layers.decode_slot_range(t, s, None, chunk)
    assert (lo, hi) == (t // chunk * chunk, t + 1)
    np.testing.assert_array_equal(mask, (np.arange(s) >= lo)
                                  & (np.arange(s) < hi))
    if t % chunk == 0:
        assert hi - lo == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_layer_chunk_matches_reference(dtype):
    """The decode layer's plain path at a chunk start and after it."""
    r = np.random.default_rng(7)
    jdt, tdt = DTYPES[dtype]
    arrs = [r.normal(size=shape).astype(np.float32)
            for shape in ((2, 6, 1, 32), (2, 2, 104, 32), (2, 2, 104, 32))]
    (jq, jk, jv), (tq, tk, tv) = ([jnp.asarray(a, jdt) for a in arrs],
                                  [torch.from_numpy(a).to(tdt) for a in arrs])
    for t in (64, 80, 96, 103):
        pos = jnp.broadcast_to(_ring_positions(t, 104)[None], (2, 104))
        want = jax_layers.decode_attention(jq, jk, jv, pos, jnp.asarray(t),
                                           chunk_attn=32)
        got = layers.decode_attention(tq, tk, tv, None, t, chunk_attn=32)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=TOL[dtype], rtol=0)


def _configs(**kw):
    jcfg = jax_get_config(LLAMA4).reduced().replace(**kw)
    return jcfg, ArchConfig(**{f: getattr(jcfg, f)
                               for f in jcfg.__dataclass_fields__})


def test_reduced_llama4_config_matches_reference():
    jcfg, tcfg = _configs()
    assert tcfg == get_config(LLAMA4).reduced()
    assert (tcfg.chunk_attn, tcfg.attn_kv_chunk, tcfg.moe_period) == (32, 32,
                                                                      2)
    full = get_config(LLAMA4)
    assert (full.chunk_attn, full.num_heads, full.num_kv_heads,
            full.num_experts) == (8192, 40, 8, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_llama4_chunked_prefill_and_decode_match_jax(dtype):
    """Prefill over two chunks, then 40 decode steps from t = 64 (a chunk
    start: the step sees only itself) past the edge at t = 96."""
    jcfg, tcfg = _configs(compute_dtype=dtype)
    toks = np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (2, 104)).astype(np.int32)
    results = run_both(jcfg, tcfg, jax_params(jcfg), toks, 64, 40)
    labels = [label for label, _, _ in results]
    assert "decode t=64" in labels and "decode t=96" in labels
    assert_close(results, dtype)
