"""The port's mixture-of-experts block against the JAX package.

``models.moe._route_local`` against the reference's on the same float32
inputs: the selected slot of every (token, choice) (``flat_pos``: expert,
rank within it, or the drop row), the capacity and the gates; with a
router skewed by hand so that the capacity bound drops assignments, and
with exact ties, where both take the lower expert index first.  Then
``moe_ffn``, the reduced mixtral-8x7b (4 experts, top-2, window 32) and
the reduced llama4-maverick (``moe_period`` 2 and a shared expert; its
``chunk_attn``, not ported yet, replaced by None on both sides) through
both models: prefill and 8 teacher-forced decode steps, max|Δ|/max|ref|
1e-4 in float32 and 3e-2 in bfloat16.  Routing is asserted exactly in
float32 only: in bfloat16 the two frameworks round the products before
the router at other places, which can flip a near tie and send a token
to another expert.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import cpu_mesh_ctx  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import get_model, moe  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import cast_params  # noqa: E402
from torch_model_parity import (REL_TOL, assert_close,  # noqa: E402
                                jax_params, rel_err, run_both)

MIXTRAL = "mixtral-8x7b"
LLAMA4 = "llama4-maverick-400b-a17b"


def _cfg(e=4, k=2, cf=1.25, **kw) -> ArchConfig:
    return get_config(MIXTRAL).reduced().replace(
        num_experts=e, top_k=k, capacity_factor=cf, **kw)


def _route_both(x: np.ndarray, router: np.ndarray, cfg: ArchConfig,
                n_local=None, offset=0):
    from repro.models.config import ArchConfig as JaxArchConfig
    jcfg = JaxArchConfig(**{f: getattr(cfg, f)
                            for f in cfg.__dataclass_fields__})
    n_local = cfg.num_experts if n_local is None else n_local
    jbuf, jpos, jgates, jcap = jax_moe._route_local(
        jnp.asarray(x), jnp.asarray(router), n_local, offset, jcfg)
    tbuf, tpos, tgates, tcap = moe._route_local(
        torch.from_numpy(x), torch.from_numpy(router), n_local, offset, cfg)
    return (np.asarray(jbuf), np.asarray(jpos), np.asarray(jgates), jcap), \
        (tbuf.numpy(), tpos.numpy(), tgates.numpy(), tcap)


def _assert_same_routing(j, t) -> None:
    (jbuf, jpos, jgates, jcap), (tbuf, tpos, tgates, tcap) = j, t
    assert tcap == jcap
    np.testing.assert_array_equal(tpos, jpos)
    # gates in [0, 1]: the two frameworks sum the router product in other
    # orders and exponentiate differently, a few float32 ulps of 1 apart
    np.testing.assert_allclose(tgates, jgates, rtol=0, atol=1e-6)
    kept = jbuf.shape[0] - 1                 # the drop row sums drops
    np.testing.assert_array_equal(tbuf[:kept], jbuf[:kept])


@pytest.mark.parametrize("n,e,k,cf", [(64, 4, 2, 1.25), (37, 8, 2, 1.25),
                                      (50, 16, 1, 1.0), (8, 8, 2, 1.25)])
def test_route_local_matches_reference(n, e, k, cf):
    r = np.random.default_rng(n + e)
    x = r.normal(size=(n, 32)).astype(np.float32)
    router = r.normal(size=(32, e)).astype(np.float32)
    _assert_same_routing(*_route_both(x, router, _cfg(e, k, cf)))


def test_skewed_router_drops_past_capacity_as_the_reference():
    """Most tokens prefer expert 0: the capacity bound drops their
    assignments to the last row, the later tokens first."""
    r = np.random.default_rng(5)
    x = np.abs(r.normal(size=(48, 32))).astype(np.float32)
    router = r.normal(size=(32, 4)).astype(np.float32) * 0.1
    router[:, 0] += 1.0                       # every token leans to 0
    cfg = _cfg(4, 2, 1.0)
    j, t = _route_both(x, router, cfg)
    _assert_same_routing(j, t)
    pos, cap = t[1], t[3]
    drop_row = cfg.num_experts * cap
    assert (pos == drop_row).sum() > 10       # drops happened
    first = pos[:, 0]                         # token order decides: the
    assert (first[:cap] < cap).all()          # first cap tokens are kept
    moe.dropped = torch.zeros((), dtype=torch.int64)
    try:
        moe._route_local(torch.from_numpy(x), torch.from_numpy(router), 4, 0,
                         cfg)
        assert int(moe.dropped) == int((pos == drop_row).sum())
    finally:
        moe.dropped = None


def test_ties_take_the_lower_expert_first():
    """A zero router ties every expert: both pick experts 0 .. k-1, equal
    gates; a tie between two non-adjacent experts keeps index order."""
    x = np.ones((6, 32), np.float32)
    _assert_same_routing(*_route_both(x, np.zeros((32, 8), np.float32),
                                      _cfg(8, 2)))
    router = np.zeros((32, 8), np.float32)
    router[:, [2, 6]] = 0.5                   # experts 2 and 6 tie on top
    j, t = _route_both(x, router, _cfg(8, 2, 4.0))     # room for all
    _assert_same_routing(j, t)
    cap = t[3]
    assert (t[1] // cap == [2, 6]).all()
    vals, idx = moe.top_k(torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]]), 2)
    assert idx.tolist() == [[1, 2]] and vals.tolist() == [[3.0, 3.0]]


def test_expert_partition_matches_reference():
    """The reference's per-shard view (a slice of the experts at an
    offset), which the port's one-device body never takes, routes as the
    reference's too."""
    r = np.random.default_rng(9)
    x = r.normal(size=(40, 32)).astype(np.float32)
    router = r.normal(size=(32, 8)).astype(np.float32)
    _assert_same_routing(*_route_both(x, router, _cfg(8, 2), n_local=4,
                                      offset=4))


def _moe_params(cfg, r):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": r.normal(size=(d, e)), "wg": r.normal(size=(e, d, f)),
         "wu": r.normal(size=(e, d, f)), "wo": r.normal(size=(e, f, d))}
    if cfg.shared_expert:
        p |= {"sh_wg": r.normal(size=(d, f)), "sh_wu": r.normal(size=(d, f)),
              "sh_wo": r.normal(size=(f, d))}
    return {k: (v * 0.1).astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_reference(shared, dtype):
    from repro.models.config import ArchConfig as JaxArchConfig
    cfg = _cfg(4, 2, shared_expert=shared, compute_dtype=dtype)
    jcfg = JaxArchConfig(**{f: getattr(cfg, f)
                            for f in cfg.__dataclass_fields__})
    r = np.random.default_rng(11)
    params = _moe_params(cfg, r)
    x = r.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = jax_moe.moe_ffn(jax.tree.map(jnp.asarray, params),
                           jnp.asarray(x, jdt), jcfg, cpu_mesh_ctx())
    got = moe.moe_ffn(params_from_numpy(params, "cpu"),
                      torch.from_numpy(x).to(getattr(torch, dtype)), cfg)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    assert rel_err(got, want) <= REL_TOL[dtype]


def test_params_and_caches_carry_over_with_the_reference_tree():
    for arch, groups in ((MIXTRAL, ["moe"]), (LLAMA4, ["dense0", "moe"])):
        jcfg, tcfg = _configs(arch)
        np_params = jax_params(jcfg)
        assert sorted(np_params["layers"]) == groups
        own = get_model(tcfg).init(tcfg, torch.Generator().manual_seed(0))
        carried = params_from_numpy(np_params, "cpu")
        for tree in (own, carried):
            assert jax.tree.structure(jax.tree.map(lambda _: 0, tree)) \
                == jax.tree.structure(jax.tree.map(lambda _: 0, np_params))
        for path, arr in jax.tree_util.tree_flatten_with_path(np_params)[0]:
            leaf, mine = carried, own
            for key in (p.key for p in path):
                leaf, mine = leaf[key], mine[key]
            assert tuple(leaf.shape) == arr.shape == tuple(mine.shape)
        assert sorted(get_model(tcfg).cache_shapes(tcfg, 2, 64)) == groups


def test_init_in_the_compute_dtype_equals_the_cast_tree():
    """Drawing the matrices straight into bf16 gives the tree that casting
    the float32 tree gives, bit for bit (the card's serving path draws
    mixtral so)."""
    cfg = get_config(MIXTRAL).reduced()
    model = get_model(cfg)
    cast = cast_params(model.init(cfg, torch.Generator().manual_seed(3)),
                       cfg)
    direct = model.init(cfg, torch.Generator().manual_seed(3),
                        dtype=torch.bfloat16)
    got = dict(jax.tree_util.tree_flatten_with_path(direct)[0])
    want = dict(jax.tree_util.tree_flatten_with_path(cast)[0])
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype
        assert torch.equal(got[path], leaf), path
    assert cast["layers"]["moe"]["moe"]["wg"].dtype == torch.bfloat16
    assert cast["layers"]["moe"]["moe"]["router"].dtype == torch.float32


def _configs(arch: str, **kw):
    """The reduced ``arch`` in both packages; llama4's ``chunk_attn`` (not
    ported yet) replaced by None.  The port's registry lists only what it
    runs, so its llama4 config is the reference's, field for field."""
    jcfg = jax_get_config(arch).reduced().replace(**kw)
    if jcfg.chunk_attn is not None:
        jcfg = jcfg.replace(chunk_attn=None)
    return jcfg, ArchConfig(**{f: getattr(jcfg, f)
                               for f in jcfg.__dataclass_fields__})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_mixtral_prefill_and_decode_match_jax(dtype):
    jcfg, tcfg = _configs(MIXTRAL, compute_dtype=dtype)
    assert tcfg == get_config(MIXTRAL).reduced().replace(compute_dtype=dtype)
    assert (tcfg.num_experts, tcfg.top_k, tcfg.window) == (4, 2, 32)
    toks = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 72)).astype(np.int32)
    assert_close(run_both(jcfg, tcfg, jax_params(jcfg), toks, 64, 8), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_llama4_moe_period_and_shared_expert_match_jax(dtype):
    jcfg, tcfg = _configs(LLAMA4, compute_dtype=dtype)
    assert tcfg.moe_period == 2 and tcfg.shared_expert
    toks = np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (2, 72)).astype(np.int32)
    assert_close(run_both(jcfg, tcfg, jax_params(jcfg), toks, 64, 8), dtype)


def test_llama4_chunked_attention_still_raises():
    """llama4's chunk mask is ported (``test_torch_chunk.py`` holds it
    against the reference); what the kernels do not take still raises
    rather than being computed another way: a decode over a wrapped ring
    that the chunk cuts (no entry point reaches one: the serve caches hold
    their own positions) and a chunk width that is not positive."""
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.models import layers
    cfg = _configs(LLAMA4)[1].replace(chunk_attn=32)
    assert sorted(get_model(cfg).param_shapes(cfg)["layers"]) == [
        "dense0", "moe"]
    with pytest.raises(NotImplementedError, match="chunk_attn=32"):
        layers.decode_slot_range(100, 64, None, cfg.chunk_attn)
    q = torch.zeros((1, 4, 8, 16))
    with pytest.raises(ValueError, match="chunk_attn"):
        flash_ops.attention(q, q, q, chunk_attn=0)
