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
(the same products summed in another order).  ``bwd_plan`` (the kernel's
route, shares, scratch and launches) is checked at every config's
training shape and the card sweep's shapes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.layers import chunked_attention  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels.flash_attn import ops  # noqa: E402
from repro_torch.kernels.flash_attn.kernel import (  # noqa: E402
    BWD_DQ_STEP_WIDE_S, BWD_PART_BYTES_PER_S, BWD_STEP_WIDE_S, BwdPlan,
    bwd_plan, bwd_step_s, dkdv_span, dkdv_walks, dq_walks)

SMS = 132       # streaming multiprocessors of an H100 SXM
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


# --------------------------------------------------------------- bwd_plan
# the training attention of every config with attention: 2 x 2,048 tokens
# (chip_smoke's phase 10 (b) batch), q-heads, KV heads and head dim
TRAIN_SHAPES = {}
for _arch in list_archs():
    _cfg = get_config(_arch)
    if _cfg.num_heads:
        TRAIN_SHAPES[_arch] = (2, _cfg.num_heads, _cfg.num_kv_heads, 2048,
                               2048, _cfg.head_dim)
# chip_smoke.flash_bwd_cases' wgmma-route shapes (b, hq, hk, sq, skv, d)
SWEEP_SHAPES = [(2, 4, 2, 64, 64, 16), (1, 8, 2, 300, 300, 128),
                (1, 3, 1, 513, 513, 64), (1, 4, 4, 513, 300, 128),
                (1, 6, 1, 200, 700, 128), (1, 4, 1, 700, 700, 80),
                (1, 2, 1, 300, 300, 48), (1, 3, 1, 129, 129, 128),
                (1, 5, 5, 191, 1000, 64), (1, 6, 1, 1000, 191, 80),
                (1, 10, 1, 1024, 1024, 128), (2, 24, 8, 1024, 1024, 128),
                (4, 8, 4, 1100, 1100, 64), (1, 10, 1, 500, 500, 256),
                (1, 2, 2, 300, 300, 160), (2, 10, 1, 300, 300, 256),
                (1, 3, 1, 129, 129, 256), (1, 2, 1, 191, 191, 256),
                (1, 2, 1, 191, 1000, 256), (1, 3, 1, 1000, 191, 256),
                (1, 10, 1, 1024, 1024, 256), (1, 2, 1, 300, 300, 256),
                (1, 3, 1, 1000, 1000, 256), (1, 2, 1, 513, 513, 256),
                (1, 2, 1, 300, 300, 192)]
# recurrentgemma-2b's training attention (window 2,048) at full width and
# on each rank of chip_smoke's phase 17 (b): (b, hq, hk, s, d)
HYBRID_FULL = (1, 10, 1, 4096, 256)
HYBRID_RANK = (1, 3, 1, 2048, 256)


def _check_plan(plan, b, hq, hk, sq, skv, d):
    """What holds for every plan: shares cut a group, partials exactly
    where there is more than one share, the scratch is their bytes, and
    one launch more sums them (above D 128 the wgmma route runs its dK/dV
    and dQ walks in one launch)."""
    group = hq // hk
    assert 1 <= plan.shares <= group
    has_part = plan.shares > 1 if plan.route == "wgmma" else group > 1
    assert (plan.part_elems > 0) == has_part
    assert plan.scratch_bytes == 4 * (plan.delta_elems + plan.part_elems)
    fused = plan.route == "wgmma" and d > 128
    assert plan.launches == 3 - fused + has_part


@pytest.mark.parametrize("arch", sorted(TRAIN_SHAPES))
def test_bwd_plan_routes_every_training_shape_by_dtype_and_head_dim(arch):
    """bf16 at every D (recurrentgemma's 256 too) takes the wgmma route,
    with 128-key dK/dV blocks up to D 128 and 64-key ones above, float32
    at any D the mma_sync route; a wgmma dK/dV grid of at least 132 blocks
    keeps each group whole (one share, no partials, three launches)."""
    b, hq, hk, sq, skv, d = TRAIN_SHAPES[arch]
    plan = bwd_plan(b, hq, hk, sq, skv, d, torch.bfloat16, SMS)
    _check_plan(plan, b, hq, hk, sq, skv, d)
    assert plan.route == "wgmma"
    assert (plan.key_tile, plan.row_tile) == ((128 if d <= 128 else 64), 128)
    assert plan.delta_elems == 2 * b * hq * 2048
    if b * hk * 2048 // plan.key_tile >= 132:
        assert (plan.shares, plan.part_elems, plan.launches) == (1, 0, 3)
    f32 = bwd_plan(b, hq, hk, sq, skv, d, torch.float32, SMS)
    _check_plan(f32, b, hq, hk, sq, skv, d)
    assert (f32.route, f32.shares) == ("mma_sync", hq // hk)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mixtral-8x7b",
                                  "internvl2-26b"])
def test_bwd_plan_full_grid_needs_no_group_scratch(arch):
    """At llama's, mixtral's and internvl2's training shapes the grid is
    2 x 8 x 16 = 256 blocks: each walks its whole group in registers."""
    b, hq, hk, sq, skv, d = TRAIN_SHAPES[arch]
    plan = bwd_plan(b, hq, hk, sq, skv, d, torch.bfloat16, SMS)
    assert plan == BwdPlan("wgmma", 128, 128, 1, 2 * b * hq * 2048, 0,
                           4 * 2 * b * hq * 2048, 3)


def test_bwd_plan_splits_an_mqa_that_leaves_the_card_idle():
    """One KV head over 1,024 keys is 8 blocks: the group of 10 is cut
    into 10 shares (80 blocks walking one head each, against 8 walking
    ten), whose float32 partials take 10 x 2 x 1,024 x 128 floats; four
    launches.  llama3.2-3b's heads at batch 1 are 128 blocks: under the
    causal mask their walks run from 32 tiles down to 2, so one head a
    block (3 shares) ends sooner; without the mask every walk is 32 tiles
    and the group stays whole."""
    plan = bwd_plan(1, 10, 1, 1024, 1024, 128, torch.bfloat16, SMS)
    assert plan == BwdPlan("wgmma", 128, 128, 10, 2 * 10 * 1024,
                           10 * 2 * 1024 * 128,
                           4 * (2 * 10 * 1024 + 10 * 2 * 1024 * 128), 4)
    assert plan.scratch_bytes == 10_567_680
    plan = bwd_plan(1, 24, 8, 2048, 2048, 128, torch.bfloat16, SMS)
    assert (plan.shares, plan.part_elems, plan.launches) == (
        3, 3 * 2 * 8 * 2048 * 128, 4)
    plan = bwd_plan(1, 24, 8, 2048, 2048, 128, torch.bfloat16, SMS,
                    causal=False)
    assert (plan.shares, plan.part_elems, plan.launches) == (1, 0, 3)


def _modelled_us(b, hq, hk, sq, skv, d, s, sms, **mask):
    """The plan's model of the time of cut s, without its pruning: the
    dK/dV blocks' span (above D 128 with the dQ blocks of the same launch
    after them) and the partials."""
    walks = dkdv_walks(sq, skv, **mask, keys=128 if d <= 128 else 64)
    tail = [] if d <= 128 else [
        w * BWD_DQ_STEP_WIDE_S / BWD_STEP_WIDE_S
        for w in dq_walks(sq, skv, **mask) for _ in range(b * hq)]
    part = 16 * s * b * hk * skv * d if s > 1 else 0
    return 1e6 * (dkdv_span(b, hk, hq // hk, s, walks, sms, tail)
                  * bwd_step_s(d) + part / BWD_PART_BYTES_PER_S)


@pytest.mark.parametrize("shape,sms,mask,shares", [
    ((2, 24, 8, 2048, 2048, 128), 132, {}, 1),      # llama's training
    ((1, 24, 8, 2048, 2048, 128), 132, {}, 3),      # causal, 128 blocks
    ((1, 24, 8, 2048, 2048, 128), 132, {"causal": False}, 1),
    ((1, 10, 1, 4096, 4096, 128), 132, {}, 10),
    ((1, 10, 1, 1024, 1024, 128), 16, {}, 4),       # a 16-SM card
    ((2, 4, 2, 64, 64, 16), 132, {}, 2),            # the reduced configs
    ((1, 3, 1, 129, 129, 128), 132, {}, 3),
    ((1, 32, 8, 6144, 6144, 80), 132, {"window": 4096}, 1),     # h2o
    ((2, 40, 8, 10240, 10240, 128), 132, {"chunk": 8192}, 1),   # llama4
    ((8, 16, 16, 1500, 1500, 64), 132, {"causal": False}, 1),   # whisper
])
def test_bwd_plan_picks_the_cut_of_least_modelled_time(shape, sms, mask,
                                                      shares):
    """The plan's share count is the one whose modelled dK/dV time (the
    blocks' span on the card plus the partials' traffic) is least, the
    fewest shares among equals, found without simulating every cut; it
    follows the card's SM count and the mask."""
    plan = bwd_plan(*shape, torch.bfloat16, sms, **mask)
    _check_plan(plan, *shape)
    assert plan.shares == shares
    group = shape[1] // shape[2]
    times = [_modelled_us(*shape, s, sms, **mask) for s in range(1, group + 1)]
    assert times[shares - 1] == min(times)
    assert all(t > min(times) for t in times[:shares - 1])


@pytest.mark.parametrize("sq,skv,causal,window,chunk", [
    (2048, 2048, True, None, None), (300, 300, False, None, None),
    (700, 700, True, 256, None), (1000, 1000, True, None, 300),
    (513, 513, False, None, 100), (600, 600, True, 200, 256),
    (200, 700, True, None, None), (1000, 191, True, None, None),
    (300, 300, True, 1, None), (1000, 1000, True, 64, 128),
    (129, 191, False, None, 64), (1100, 1100, True, 300, None)])
def test_dkdv_walks_count_the_query_tiles_the_mask_keeps(sq, skv, causal,
                                                         window, chunk):
    """Each 128-key tile's walk is the number of 64-row query tiles with a
    row that keeps one of its keys under the plain mask."""
    mask = attention_mask(sq, skv, "cpu", causal=causal, window=window,
                          chunk_attn=chunk)
    want = [sum(bool(mask[r:r + 64, k0:k0 + 128].any())
                for r in range(0, sq, 64)) for k0 in range(0, skv, 128)]
    assert dkdv_walks(sq, skv, causal, window, chunk) == want
    if causal and window is None and chunk is None and sq == skv:
        assert want == [sq // 64 - 2 * t for t in range(skv // 128)]


@pytest.mark.parametrize("sq,skv,causal,window,chunk", [
    (2048, 2048, True, 2048, None), (4096, 4096, True, 2048, None),
    (191, 1000, True, None, None), (1000, 191, True, None, None),
    (513, 513, False, None, 100), (300, 300, True, 1, None),
    (1000, 1000, True, None, 300)])
def test_dkdv_walks_count_64_key_tiles(sq, skv, causal, window, chunk):
    """Above D 128 a dK/dV block holds 64 keys: each 64-key tile's walk is
    the number of 64-row query tiles with a row that keeps one of its keys
    under the plain mask."""
    mask = attention_mask(sq, skv, "cpu", causal=causal, window=window,
                          chunk_attn=chunk)
    want = [sum(bool(mask[r:r + 64, k0:k0 + 64].any())
                for r in range(0, sq, 64)) for k0 in range(0, skv, 64)]
    assert dkdv_walks(sq, skv, causal, window, chunk, keys=64) == want


@pytest.mark.parametrize("shape,shares", [(HYBRID_FULL, 2),
                                          (HYBRID_RANK, 3)],
                         ids=["full", "rank"])
def test_bwd_plan_at_recurrentgemma_training_shapes(shape, shares):
    """recurrentgemma-2b's training attention (D 256, window 2,048, one KV
    head) at full width (10 q-heads over 4,096 tokens: 64 dK/dV blocks of
    64 keys) and on each rank of phase 17 (b) (3 q-heads over 2,048: 32
    blocks) takes the wgmma route: 64-key dK/dV and 128-row dQ blocks in
    one launch after prep, the group cut into the shares of least
    modelled time (2 of five heads, whose 128 dK/dV blocks leave 4 SMs
    and the late key tiles' short walks to the 320 dQ blocks; 3 of one),
    their float32 partials [s, 2, 1, 1, S, 256] summed by a third launch.
    float32 takes the mma_sync route, one share a q-head."""
    b, hq, hk, s, d = shape
    plan = bwd_plan(b, hq, hk, s, s, d, torch.bfloat16, SMS, window=2048)
    delta = 2 * b * hq * s
    part = shares * 2 * b * hk * s * d
    assert plan == BwdPlan("wgmma", 64, 128, shares, delta, part,
                           4 * (delta + part), 3)
    times = [_modelled_us(b, hq, hk, s, s, d, n, SMS, window=2048)
             for n in range(1, hq // hk + 1)]
    assert times[shares - 1] == min(times)
    f32 = bwd_plan(b, hq, hk, s, s, d, torch.float32, SMS, window=2048)
    assert (f32.route, f32.key_tile, f32.shares, f32.launches) == (
        "mma_sync", 32, hq // hk, 4)


@pytest.mark.parametrize("sq,skv,causal,window,chunk", [
    (2048, 2048, True, 2048, None), (4096, 4096, True, 2048, None),
    (191, 1000, True, None, None), (1000, 191, True, None, None),
    (513, 513, False, None, 100), (300, 300, True, 1, None),
    (1000, 1000, True, 64, 128)])
def test_dq_walks_count_the_key_tiles_each_block_sees(sq, skv, causal,
                                                      window, chunk):
    """Each 128-row dQ block walks the 32-key tiles from the first to the
    last that a row of it keeps (the rows' keys, a range whose ends grow
    with the position, cover them all); blocks in dispatch order, the last
    query tile first."""
    mask = attention_mask(sq, skv, "cpu", causal=causal, window=window,
                          chunk_attn=chunk)
    want = []
    for r in reversed(range(0, sq, 128)):
        seen = [bool(mask[r:r + 128, k0:k0 + 32].any())
                for k0 in range(0, skv, 32)]
        want.append(len(seen) - seen.index(True) - seen[::-1].index(True)
                    if any(seen) else 0)
    assert dq_walks(sq, skv, causal, window, chunk) == want


def test_dkdv_span_dispatches_blocks_in_grid_order():
    """Blocks go in grid order, key tile slowest, each to the SM that
    frees first: a group of 4 on two SMs over walks of 5 and 3 tiles ends
    at 20 steps whole (one SM takes 4 x 5, the other 4 x 3) and at 16 in
    two shares of 2 heads (10, 10, then 6 on each); uneven shares of a
    group of 3 take 1 and 2 heads."""
    assert dkdv_span(1, 1, 4, 1, [5, 3], 2) == 20
    assert dkdv_span(1, 1, 4, 2, [5, 3], 2) == 16
    assert dkdv_span(1, 1, 3, 2, [4], 2) == 8
    assert dkdv_span(2, 1, 3, 3, [4], 2) == 12
    # the blocks after them (above D 128 the same launch's dQ blocks) go
    # to the SM that frees first: after 20 and 12, 3 and 5 on the second
    # (to 20), then 4 and 6 one on each: 26
    assert dkdv_span(1, 1, 4, 1, [5, 3], 2, [3, 5, 4, 6]) == 26


def test_bwd_plan_takes_a_cut_it_is_given():
    """``shares`` overrides the cut on the wgmma route (1 to the group,
    with partials above 1; at D 256 too) and is refused out of that range
    and on the mma_sync route (float32), whose groups are always cut per
    q-head."""
    plan = bwd_plan(2, 24, 8, 1024, 1024, 128, torch.bfloat16, SMS,
                    shares=2)
    assert (plan.shares, plan.part_elems, plan.launches) == (
        2, 2 * 2 * 2 * 8 * 1024 * 128, 4)
    _check_plan(plan, 2, 24, 8, 1024, 1024, 128)
    assert bwd_plan(1, 10, 1, 1024, 1024, 128, torch.bfloat16, SMS,
                    shares=1) == BwdPlan("wgmma", 128, 128, 1, 2 * 10 * 1024,
                                         0, 4 * 2 * 10 * 1024, 3)
    for shares in (0, 4):
        with pytest.raises(ValueError, match="shares"):
            bwd_plan(2, 24, 8, 1024, 1024, 128, torch.bfloat16, SMS,
                     shares=shares)
    assert bwd_plan(1, 10, 1, 1024, 1024, 256, torch.bfloat16, SMS,
                    shares=1) == BwdPlan("wgmma", 64, 128, 1, 2 * 10 * 1024,
                                         0, 4 * 2 * 10 * 1024, 2)
    for d in (128, 256):
        with pytest.raises(ValueError, match="wgmma route"):
            bwd_plan(1, 10, 1, 1024, 1024, d, torch.float32, SMS, shares=1)


@pytest.mark.parametrize("shape", SWEEP_SHAPES,
                         ids=[str(s) for s in SWEEP_SHAPES])
def test_bwd_plan_sweep_shapes(shape):
    """The sweep's wgmma cases: Sq rounded up to 128 for the padded lse
    and Delta rows, and the plan's invariants."""
    b, hq, hk, sq, skv, d = shape
    plan = bwd_plan(b, hq, hk, sq, skv, d, torch.bfloat16, SMS)
    assert plan.route == "wgmma"
    assert plan.delta_elems == 2 * b * hq * (-(-sq // 128) * 128)
    _check_plan(plan, *shape)
    if plan.shares > 1:
        assert plan.part_elems == plan.shares * 2 * b * hk * skv * d
