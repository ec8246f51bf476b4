"""The port's sliding-window attention against the JAX package.

``models.layers.decode_attention`` (its plain path, the full position
mask) against ``repro.models.layers.decode_attention`` on the same seeded
inputs: slots that hold their own positions (the serve path's cache), a
wrapped ring longer than the window, and ``chunk_attn``; and the slot
range the card's path reads in place of that mask.  Then the reduced
h2o-danube-1.8b (window 32) through both models: a 64-token prefill and
8 teacher-forced decode steps whose window moves past the prompt's first
tokens, max|Δ|/max|ref| 1e-4 in float32 and 3e-2 in bfloat16 (the two
frameworks round bf16 products at other places).  The prompt is a
multiple of the reduced config's 32-key chunk (the reference's
``chunked_attention`` reads a clamped last chunk under wrong positions
otherwise).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.transformer import _ring_positions  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attn import ops as decode_ops  # noqa: E402
from repro_torch.models import get_model, layers  # noqa: E402
from repro_torch.models.transformer import (cast_params,  # noqa: E402
                                            kv_cache_len)
from torch_model_parity import (assert_close, jax_params,  # noqa: E402
                                run_both)

ARCH = "h2o-danube-1.8b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _decode_inputs(seed, b, hq, hk, s, dh, dtype):
    r = np.random.default_rng(seed)
    return [_pair(r.normal(size=shape).astype(np.float32), dtype)
            for shape in ((b, hq, 1, dh), (b, hk, s, dh), (b, hk, s, dh))]


# (t, slots, window, chunk): slots holding their own positions (t < S);
# a full ring inside the window; a wrapped ring longer than the window;
# chunked local attention on either side of a chunk edge
CASES = [(40, 96, None, None), (40, 96, 16, None), (95, 96, 32, None),
         (150, 64, 64, None), (150, 64, 100, None), (150, 96, 32, None),
         (40, 96, None, 32), (63, 96, 16, 32), (150, 64, None, 32)]


@pytest.mark.parametrize("t,s,window,chunk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_layer_matches_reference_mask(t, s, window, chunk, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _decode_inputs(t + s, 3, 6, 2, s, 32,
                                                  dtype)
    pos = jnp.broadcast_to(_ring_positions(t, s)[None], (3, s))
    want = jax_layers.decode_attention(jq, jk, jv, pos, jnp.asarray(t),
                                       window=window, chunk_attn=chunk)
    # the ring's positions built by the port (None) and given explicitly
    got = layers.decode_attention(tq, tk, tv, None, t, window=window,
                                  chunk_attn=chunk)
    given = layers.decode_attention(tq, tk, tv,
                                    torch.from_numpy(np.array(pos)), t,
                                    window=window, chunk_attn=chunk)
    assert got.shape == (3, 6, 1, 32) and torch.equal(got, given)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=0)
    assert torch.equal(layers.ring_positions(t, s),
                       torch.from_numpy(np.array(_ring_positions(t, s))))


@pytest.mark.parametrize("t,s,window,chunk", CASES)
def test_slot_range_is_the_reference_mask(t, s, window, chunk):
    """Where the card's path takes a slot range [lo, hi) in place of the
    position mask, the range is exactly the slots the mask leaves; a
    wrapped ring the window cuts raises."""
    pos = np.asarray(_ring_positions(t, s))
    mask = (pos >= 0) & (pos <= t)
    if window is not None:
        mask &= pos > t - window
    if chunk is not None:
        mask &= pos // chunk == t // chunk
    if t >= s and not mask.all():
        with pytest.raises(NotImplementedError, match="slot range"):
            layers.decode_slot_range(t, s, window, chunk)
        return
    lo, hi = layers.decode_slot_range(t, s, window, chunk)
    np.testing.assert_array_equal(mask, (np.arange(s) >= lo)
                                  & (np.arange(s) < hi))


# the cases whose mask is one slot range (the others are wrapped rings
# the window or chunk cuts)
RANGE_CASES = [c for c in CASES
               if c not in ((150, 96, 32, None), (150, 64, None, 32))]


@pytest.mark.parametrize("t,s,window,chunk", RANGE_CASES)
def test_slot_bounds_give_the_layer_mask(t, s, window, chunk):
    """The bounds the card's path hands the kernel (``slot_bounds`` of
    the slot range, every row alike) give, through the kernel's plain
    version, what the layer's full position mask gives; one bounds tensor
    serves every call with the same range."""
    lo, hi = layers.decode_slot_range(t, s, window, chunk)
    bounds = layers.slot_bounds(torch.device("cpu"), 3, lo, hi)
    assert bounds.dtype == torch.int32 and bounds.tolist() == [[lo] * 3,
                                                              [hi] * 3]
    assert layers.slot_bounds(torch.device("cpu"), 3, lo, hi) is bounds
    g = torch.Generator().manual_seed(t)
    q = torch.randn((3, 8, 1, 16), generator=g)
    k, v = (torch.randn((3, 2, s, 16), generator=g) for _ in range(2))
    want = layers.decode_attention(q, k, v, None, t, window=window,
                                   chunk_attn=chunk)
    got = decode_ops.decode(q[:, :, 0], k, v, bounds[1], bounds[0],
                            span=hi - lo)
    torch.testing.assert_close(got, want[:, :, 0], rtol=1e-5, atol=1e-6)


def test_kv_cache_len_matches_reference():
    from repro.models.transformer import kv_cache_len as jax_kv_cache_len
    for arch in ("h2o-danube-1.8b", "mixtral-8x7b", "llama3.2-3b"):
        for seq in (16, 4096, 32768):
            jcfg, tcfg = jax_get_config(arch), get_config(arch)
            assert kv_cache_len(tcfg, seq) == jax_kv_cache_len(jcfg, seq)
            assert kv_cache_len(tcfg.replace(chunk_attn=8192), seq) \
                == jax_kv_cache_len(jcfg.replace(chunk_attn=8192), seq)


def test_reduced_config_matches_reference():
    assert get_config(ARCH).reduced().window == 32
    for arch in ("h2o-danube-1.8b", "mixtral-8x7b", "minitron-4b",
                 "internlm2-20b"):
        for cfg in (get_config(arch), get_config(arch).reduced()):
            j = jax_get_config(arch)
            j = j.reduced() if cfg.name.endswith("-reduced") else j
            assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} \
                == {f: getattr(j, f) for f in j.__dataclass_fields__}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_h2o_prefill_and_decode_match_jax(dtype):
    jcfg = jax_get_config(ARCH).reduced().replace(compute_dtype=dtype)
    tcfg = get_config(ARCH).reduced().replace(compute_dtype=dtype)
    assert tcfg.window == 32
    toks = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 72)).astype(np.int32)
    assert_close(run_both(jcfg, tcfg, jax_params(jcfg), toks, 64, 8), dtype)


def test_swa_limits_attention_window():
    """A token beyond the window does not move the logits (the port's
    counterpart of the reference's test of the same name): position 0 is
    63 tokens from the last one, outside window 32."""
    cfg = get_config(ARCH).reduced()
    model = get_model(cfg)
    params = cast_params(model.init(cfg, torch.Generator().manual_seed(0)),
                         cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, 64),
                         generator=torch.Generator().manual_seed(1))
    logits1, _ = model.prefill(params, {"tokens": toks}, cfg)
    toks2 = toks.clone()
    toks2[:, 0] = (toks[:, 0] + 7) % cfg.vocab_size
    logits2, _ = model.prefill(params, {"tokens": toks2}, cfg)
    torch.testing.assert_close(logits1, logits2, atol=1e-4, rtol=0)
    # the same in decode: token 63 against the caches of the two prompts,
    # grown by the slot it writes
    steps = []
    for t in (toks, toks2):
        _, caches = model.prefill(params, {"tokens": t[:, :63]}, cfg)
        caches = {g: {kv: F.pad(c, (0, 0, 0, 1)) for kv, c in d.items()}
                  for g, d in caches.items()}
        steps.append(model.decode(params, caches, t[:, 63:], 63, cfg)[0])
    torch.testing.assert_close(steps[0], steps[1], atol=1e-4, rtol=0)
    # without the window the changed token does move them
    full = cfg.replace(window=None)
    assert not torch.allclose(model.prefill(params, {"tokens": toks2},
                                            full)[0], logits1,
                              atol=1e-4, rtol=0)
