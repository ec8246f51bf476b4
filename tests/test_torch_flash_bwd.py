"""The plain flash-attention backward (``flash_attention_bwd_ref``, the
step-by-step version the CUDA backward kernel computes) and the forward's
log-sum-exp, on the CPU.

``flash_attention_bwd_ref`` is held against ``torch.autograd`` through
``flash_attention_ref`` (every mask, Sq != Skv both ways, GQA groups 1, 2
and 4, rows the mask leaves no key) and against ``jax.vjp`` of the
reference's ``chunked_attention``, the function the reference trains
through, where the two agree on the forward: Skv a multiple of the
reference's ``kv_chunk`` (its clamped last chunk reads keys under wrong
positions otherwise), suffix alignment only under the causal mask (the
reference shifts positions only there) and no row without a key (the
reference averages every key there, the port gives zeros).  Inputs come
from numpy with a seed; float32 throughout, tolerance 1e-5 of max|ref|
(the same products summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.layers import chunked_attention  # noqa: E402
from repro_torch.kernels.flash_attn import ops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (  # noqa: E402
    LSE_EMPTY, attention_mask, flash_attention_bwd_ref, flash_attention_ref)

TOL = 1e-5

# (b, hq, hk, sq, skv, d, causal, window, chunk)
CASES = [
    (2, 4, 4, 64, 64, 16, True, None, None),       # causal, group 1
    (2, 4, 2, 64, 64, 16, True, 16, None),         # window, group 2
    (2, 8, 2, 64, 64, 32, True, None, 16),         # chunk, group 4
    (1, 4, 2, 64, 64, 16, False, None, None),      # not causal
    (1, 4, 1, 32, 64, 16, True, None, None),       # Sq < Skv (suffix)
    (1, 4, 2, 64, 96, 16, True, 20, 32),           # window and chunk
    (1, 4, 2, 48, 32, 16, True, None, None),       # Sq > Skv: empty rows
    (1, 2, 1, 40, 40, 16, False, None, 16),        # chunk, not causal
    (1, 2, 2, 40, 40, 16, True, 1, None),          # window of 1
]
IDS = [f"{c[0]}x{c[1]}:{c[2]} {c[3]}x{c[4]} D{c[5]} causal={c[6]} "
       f"w={c[7]} c={c[8]}" for c in CASES]


def _inputs(case, seed=0):
    b, hq, hk, sq, skv, d = case[:6]
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hk, skv, d), (b, hk, skv, d),
                      (b, hq, sq, d))]


def _mask_kw(case):
    return dict(causal=case[6], window=case[7], chunk_attn=case[8])


def _rel(got: torch.Tensor, want) -> float:
    """max|got - want| / max(max|want|, 1).  The inputs are N(0, 1), so
    every gradient here is of order 1 but one: a window of 1 leaves each
    row one key, whose softmax has no gradient, so dq is exactly 0 in
    autodiff and ~1e-6 in the step-by-step version (dP - Delta of two
    sums taken in different orders)."""
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().numpy() - want).max()
                 / max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_ref_matches_autograd_of_forward_ref(case):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case))
    kw = _mask_kw(case)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = flash_attention_ref(*ins, return_lse=True, **kw)
    out.backward(do)
    got = flash_attention_bwd_ref(q, k, v, out.detach(), do, lse, **kw)
    for g, t in zip(got, ins):
        assert g.shape == t.shape and g.dtype == t.dtype
        assert _rel(g, t.grad.numpy()) <= TOL


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_lse_is_the_rows_logsumexp(case):
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(case))
    kw = _mask_kw(case)
    out, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, flash_attention_ref(q, k, v, **kw))
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    mask = attention_mask(q.shape[2], k.shape[2], "cpu", **kw)
    rep = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q,
                     k.repeat_interleave(rep, 1)) * q.shape[3] ** -0.5
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), -1)
    empty = ~mask.any(-1)
    assert torch.equal(torch.isinf(lse), empty.expand_as(lse))
    assert bool((lse[..., empty] == LSE_EMPTY).all())
    torch.testing.assert_close(lse[..., ~empty], want[..., ~empty],
                               rtol=1e-6, atol=1e-5)


def test_rows_without_a_key_get_zero_gradients():
    """Causal with Sq > Skv: the first rows see no key.  Their output is
    zero, their P is exactly 0 (lse +inf), so their dq is zero and they
    add nothing to dk and dv."""
    case = (1, 4, 2, 48, 32, 16, True, None, None)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case, seed=3))
    out, lse = flash_attention_ref(q, k, v, return_lse=True, causal=True)
    empty = 48 - 32
    assert bool((out[:, :, :empty] == 0).all())
    assert bool(torch.isinf(lse[:, :, :empty]).all())
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, do, lse, causal=True)
    assert bool((dq[:, :, :empty] == 0).all())
    do2 = do.clone()
    do2[:, :, :empty] = 1e3          # a huge gradient on the empty rows
    _, dk2, dv2 = flash_attention_bwd_ref(q, k, v, out, do2, lse,
                                          causal=True)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def _jax_case_ok(case) -> bool:
    b, hq, hk, sq, skv, d, causal, window, chunk = case
    kv_chunk = 16
    return (skv % kv_chunk == 0 and (causal or sq == skv)
            and not (causal and sq > skv))


@pytest.mark.parametrize("case", [c for c in CASES if _jax_case_ok(c)],
                         ids=[i for c, i in zip(CASES, IDS)
                              if _jax_case_ok(c)])
def test_backward_ref_matches_jax_vjp_of_chunked_attention(case):
    """The gradient the reference takes by autodiff through its
    ``chunked_attention`` (q chunks of 16, KV chunks of 16)."""
    q, k, v, do = _inputs(case, seed=1)
    kw = _mask_kw(case)

    def f(q, k, v):
        return chunked_attention(q, k, v, causal=kw["causal"],
                                 window=kw["window"],
                                 chunk_attn=kw["chunk_attn"], q_chunk=16,
                                 kv_chunk=16)
    jout, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    assert _rel(out, jout) <= TOL
    got = flash_attention_bwd_ref(tq, tk, tv, out, tdo, lse, **kw)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


def test_ops_attention_on_the_cpu_is_the_differentiable_plain_version():
    """On a CPU tensor ``ops.attention`` runs the plain version (no kernel
    launch, forward or backward, is counted) and its gradient is
    autograd's through it."""
    case = (1, 4, 2, 64, 64, 16, True, 16, None)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case, seed=2))
    ops.launches = ops.bwd_launches = 0
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.attention(*ins, causal=True, window=16)
    out.backward(do)
    assert (ops.launches, ops.bwd_launches) == (0, 0)
    out2, lse = flash_attention_ref(q, k, v, return_lse=True, causal=True,
                                    window=16)
    got = flash_attention_bwd_ref(q, k, v, out2, do, lse, causal=True,
                                  window=16)
    for g, t in zip(got, ins):
        assert _rel(g, t.grad.numpy()) <= TOL


def test_cuda_tensor_that_requires_grad_takes_the_autograd_function(
        monkeypatch):
    """On a CUDA tensor with a gradient to carry, ``ops.attention`` goes
    through ``FlashAttention`` (the forward kernel with its log-sum-exp,
    the backward kernel for the gradient), never the plain version; a
    call without a gradient launches the forward alone.  The kernels are
    stood in for here (no card): the routing is what is checked."""
    calls = []

    class FakeFunction:
        @staticmethod
        def apply(*args):
            calls.append("function")
            return "through the autograd function"

    def fake_forward(*args, **kw):
        calls.append("forward")
        return "forward alone"

    def no_plain(*args, **kw):
        raise AssertionError("plain version reached with a CUDA tensor")

    class FakeCuda:
        is_cuda = True
        requires_grad = True
        shape = (1, 2, 8, 16)

        def numel(self):
            return 256

    monkeypatch.setattr(ops, "FlashAttention", FakeFunction)
    monkeypatch.setattr(ops, "flash_attention", fake_forward)
    monkeypatch.setattr(ops, "flash_attention_ref", no_plain)
    t = FakeCuda()
    assert ops.attention(t, t, t) == "through the autograd function"
    with torch.no_grad():
        assert ops.attention(t, t, t) == "forward alone"
    assert calls == ["function", "forward"]
