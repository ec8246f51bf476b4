"""The port's attention ops against the JAX package.

On the CPU the port's ``flash_attn.ops.attention`` and
``decode_attn.ops.decode`` run their plain PyTorch versions.  They are
held against two JAX counterparts on the same seeded numpy inputs: the
Pallas kernels through their ``ops`` (interpret mode, as
``tests/test_kernels.py`` runs them) and the model layer's pure-jnp
``chunked_attention`` / ``decode_attention`` (with ``kv_positions =
arange(S)`` and ``t = valid_len - 1``).  The shapes are those of
``test_kernels.py``: GQA 4:2 and 3:1, windows 64/128, ragged
``valid_len`` and garbage past it; and recurrentgemma's local attention,
head dim 256 with 10 q-heads on one KV head, and a group of 10 at head
dim 128 (20:2), which the decode kernel serves in sub-groups.  Tolerances: 1e-5 in float32, 2e-2 in
bfloat16 (one output rounding).  The CUDA kernels themselves run only on
a card (``test_torch_cuda``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attn.ops import decode as jax_decode  # noqa: E402
from repro.kernels.flash_attn.ops import attention as jax_attention  # noqa
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.kernels.decode_attn import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.models import layers as torch_layers  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _close(got: torch.Tensor, want, dtype: str) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("s,dh,hq,hk", [(128, 64, 4, 2), (300, 64, 3, 1),
                                        (512, 128, 4, 2), (256, 256, 10, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_kernel(s, dh, hq, hk, causal, dtype):
    r = np.random.default_rng(s + dh + hq)
    jq, tq = _pair(r.normal(size=(2, hq, s, dh)).astype(np.float32), dtype)
    jk, tk = _pair(r.normal(size=(2, hk, s, dh)).astype(np.float32), dtype)
    jv, tv = _pair(r.normal(size=(2, hk, s, dh)).astype(np.float32), dtype)
    want = jax_attention(jq, jk, jv, causal=causal)
    got = flash_ops.attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("window", [64, 128])
@pytest.mark.parametrize("hq,hk", [(2, 2), (3, 1)])
def test_flash_attention_window_matches_pallas_kernel(window, hq, hk):
    r = np.random.default_rng(window + hq)
    jq, tq = _pair(r.normal(size=(1, hq, 384, 64)).astype(np.float32),
                   "float32")
    jk, tk = _pair(r.normal(size=(1, hk, 384, 64)).astype(np.float32),
                   "float32")
    jv, tv = _pair(r.normal(size=(1, hk, 384, 64)).astype(np.float32),
                   "float32")
    want = jax_attention(jq, jk, jv, causal=True, window=window)
    got = flash_ops.attention(tq, tk, tv, causal=True, window=window)
    _close(got, want, "float32")


def test_flash_attention_rows_with_no_key_give_zeros():
    """Causal with Sq > Skv: query row i sits at position i - 500, so rows
    0..499 see no key.  The port gives zeros there.  The Pallas kernel
    agrees where it skips the row's whole 256-row query block (rows
    0..255); inside the block it runs (rows 256..499) it weighs that
    block's keys equally instead.  Every row that sees a key matches."""
    r = np.random.default_rng(7)
    jq, tq = _pair(r.normal(size=(1, 2, 600, 32)).astype(np.float32),
                   "float32")
    jk, tk = _pair(r.normal(size=(1, 1, 100, 32)).astype(np.float32),
                   "float32")
    jv, tv = _pair(r.normal(size=(1, 1, 100, 32)).astype(np.float32),
                   "float32")
    want = np.asarray(jax_attention(jq, jk, jv, causal=True))
    got = flash_ops.attention(tq, tk, tv, causal=True)
    assert not got[:, :, :500].any()
    _close(got[:, :, 500:], want[:, :, 500:], "float32")
    assert not want[:, :, :256].any() and want[:, :, 256:500].any()


@pytest.mark.parametrize("sq,skv,window", [(256, 256, None), (128, 320, None),
                                           (256, 256, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches_model_layer(sq, skv, window, dtype):
    """The port's layer == the JAX model's pure-jnp chunked_attention,
    GQA 4:2, suffix-aligned when Sq < Skv."""
    r = np.random.default_rng(sq + skv)
    jq, tq = _pair(r.normal(size=(2, 4, sq, 32)).astype(np.float32), dtype)
    jk, tk = _pair(r.normal(size=(2, 2, skv, 32)).astype(np.float32), dtype)
    jv, tv = _pair(r.normal(size=(2, 2, skv, 32)).astype(np.float32), dtype)
    want = jax_layers.chunked_attention(jq, jk, jv, causal=True,
                                        window=window, q_chunk=64,
                                        kv_chunk=64)
    got = torch_layers.chunked_attention(tq, tk, tv, causal=True,
                                         window=window)
    _close(got, want, dtype)


def _decode_inputs(r, b, h, kv, s, dh, dtype):
    q = r.normal(size=(b, h, dh)).astype(np.float32)
    kc = r.normal(size=(b, kv, s, dh)).astype(np.float32)
    vc = r.normal(size=(b, kv, s, dh)).astype(np.float32)
    return _pair(q, dtype), _pair(kc, dtype), _pair(vc, dtype)


@pytest.mark.parametrize("s,h,kv,dh", [(512, 8, 4, 64), (1000, 4, 4, 128),
                                       (513, 8, 2, 64), (300, 3, 1, 64),
                                       (512, 10, 1, 256), (300, 20, 2, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_pallas_kernel(s, h, kv, dh, dtype):
    r = np.random.default_rng(s + h)
    (jq, tq), (jk, tk), (jv, tv) = _decode_inputs(r, 2, h, kv, s, dh, dtype)
    lens = np.array([s, max(1, s // 3)], np.int32)
    want = jax_decode(jq, jk, jv, jnp.asarray(lens))
    got = decode_ops.decode(tq, tk, tv, torch.from_numpy(lens))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dtype)


def test_decode_garbage_past_valid_len_and_zero_length():
    """Slots past valid_len change nothing; valid_len 0 gives zeros, as the
    Pallas kernel does (its pure-jnp oracle averages every slot there)."""
    r = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = _decode_inputs(r, 3, 4, 2, 512, 64,
                                                  "float32")
    lens = np.array([100, 0, 512], np.int32)
    k2, v2 = tk.clone(), tv.clone()
    for b, n in enumerate(lens):
        k2[b, :, n:] = 999.0
        v2[b, :, n:] = -999.0
    got = decode_ops.decode(tq, k2, v2, torch.from_numpy(lens))
    want = jax_decode(jq, jk, jv, jnp.asarray(lens))
    _close(got, want, "float32")
    assert not got[1].any()
    torch.testing.assert_close(
        got, decode_ops.decode(tq, tk, tv, torch.from_numpy(lens)),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("h,kv", [(4, 2), (3, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_model_layer(h, kv, dtype):
    r = np.random.default_rng(h * 10 + kv)
    s = 300
    (jq, tq), (jk, tk), (jv, tv) = _decode_inputs(r, 3, h, kv, s, 32, dtype)
    lens = np.array([s, 1, 77], np.int32)
    kv_pos = jnp.broadcast_to(jnp.arange(s)[None], (3, s))
    want = jax_layers.decode_attention(jq[:, :, None], jk, jv, kv_pos,
                                       jnp.asarray(lens - 1))
    got = torch_layers.decode_attention(tq[:, :, None], tk, tv,
                                        torch.from_numpy(np.array(kv_pos)),
                                        torch.from_numpy(lens - 1))
    assert got.shape == (3, h, 1, 32)
    _close(got, want, dtype)


def test_degenerate_shapes_short_circuit():
    q = torch.zeros((2, 4, 0, 16))
    k = torch.zeros((2, 2, 5, 16))
    assert flash_ops.attention(q, k, k).shape == (2, 4, 0, 16)
    q = torch.ones((2, 4, 3, 16))
    out = flash_ops.attention(q, k[:, :, :0], k[:, :, :0])
    assert out.shape == q.shape and not out.any()
    out = decode_ops.decode(q[:, :, 0], k[:, :, :0], k[:, :, :0], 0)
    assert out.shape == (2, 4, 16) and not out.any()
