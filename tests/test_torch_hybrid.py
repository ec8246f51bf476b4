"""The port's RecurrentGemma hybrid against the JAX package.

``models.hybrid.rg_lru_scan`` (the log-depth prefix against the
reference's ``lax.associative_scan``) and ``rg_lru_step``, and
``rec_block`` in each mode, on the same seeded numpy inputs and JAX
weights; then the reduced recurrentgemma-2b through both models: its 4
layers (one (rec, rec, attn) group and ``tail0_rec``), a 5-layer variant
(``tail0_rec`` and ``tail1_rec``) and a variant at the real attention
geometry (head dim 256, 10 q-heads on one KV head, d_model kept at 64):
a 64-token prefill and 8 teacher-forced decode steps whose 32-token
window has moved past the prompt's start, the caches compared leaf for
leaf.  max|Δ|/max|ref| within 1e-4 in float32 and 3e-2 in bfloat16
(``torch_model_parity.REL_TOL``).  The prompt is a multiple of the
reduced config's 32-key chunk (the reference's ``chunked_attention``
reads a clamped last chunk under wrong positions otherwise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import hybrid as jax_hybrid  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import get_model, hybrid  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import MATRICES, cast_params  # noqa
from torch_model_parity import (REL_TOL, assert_close,  # noqa: E402
                                jax_params, rel_err, run_both)

ARCH = "recurrentgemma-2b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _configs(**kw):
    """The reduced recurrentgemma-2b in both packages, field for field."""
    jcfg = jax_get_config(ARCH).reduced().replace(**kw)
    return jcfg, ArchConfig(**{f: getattr(jcfg, f)
                               for f in jcfg.__dataclass_fields__})


def _rec_params(dtype: str) -> tuple:
    jcfg, tcfg = _configs(compute_dtype=dtype)
    p = {k: v[0] for k, v in jax_params(jcfg)["groups"]["0_rec"].items()}
    return jcfg, tcfg, p


@pytest.mark.parametrize("s", [1, 7, 64, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rg_lru_scan_and_step_match_reference(s, dtype):
    _, tcfg, p = _rec_params(dtype)
    assert tcfg.lru_width == 64
    r = np.random.default_rng(s)
    jx, tx = _pair(r.normal(size=(2, s, 64)).astype(np.float32), dtype)
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")
    want = jax_hybrid.rg_lru_scan(jp, jx)
    got = hybrid.rg_lru_scan(tp, tx, hybrid.lru_gates(tp, tx))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert rel_err(got, want) <= REL_TOL[dtype]
    (jxt, txt), (jh, th) = (
        _pair(r.normal(size=(2, 64)).astype(np.float32), dtype)
        for _ in range(2))
    got = hybrid.rg_lru_step(tp, txt, th, hybrid.lru_gates(tp, txt))
    want = jax_hybrid.rg_lru_step(jp, jxt, jh)
    assert got.dtype == txt.dtype and rel_err(got, want) <= REL_TOL[dtype]


def test_rg_lru_scan_equals_the_sequential_recurrence():
    """The parallel prefix computes h_t = a_t h_{t-1} + b_t, up to the
    float32 rounding of its other order of products."""
    _, _, p = _rec_params("float32")
    tp = params_from_numpy(p, "cpu")
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, 37, 64)).astype(np.float32))
    gates = hybrid.lru_gates(tp, x)
    a, b = hybrid._lru_coeffs(tp, x, gates)
    h, want = torch.zeros_like(b[:, 0]), []
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(hybrid.rg_lru_scan(tp, x, gates),
                               torch.stack(want, 1), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rec_block_matches_reference(mode, dtype):
    jcfg, tcfg, p = _rec_params(dtype)
    r = np.random.default_rng(11)
    s = 1 if mode == "decode" else 2
    jx, tx = _pair(r.normal(size=(2, s, tcfg.d_model)).astype(np.float32),
                   dtype)
    jcache = tcache = None
    if mode == "decode":
        pairs = {"conv": _pair(r.normal(size=(2, 3, 64)).astype(
                     np.float32), dtype),
                 "h": _pair(r.normal(size=(2, 64)).astype(np.float32),
                            dtype)}
        jcache = {k: j for k, (j, _) in pairs.items()}
        tcache = {k: t for k, (_, t) in pairs.items()}
    jy, jnew = jax_hybrid.rec_block(jax.tree.map(jnp.asarray, p), jx, jcfg,
                                    mode=mode, cache=jcache)
    ty, tnew = hybrid.rec_block(params_from_numpy(p, "cpu"), tx, tcfg,
                                mode=mode, cache=tcache)
    assert ty.dtype == tx.dtype and rel_err(ty, jy) <= REL_TOL[dtype]
    # a 2-token prefill leaves a left-padded conv state
    assert sorted(tnew) == sorted(jnew) == ["conv", "h"]
    for k in tnew:
        assert tnew[k].dtype == tx.dtype and tnew[k].shape == jnew[k].shape
        assert rel_err(tnew[k], jnew[k]) <= REL_TOL[dtype], k


VARIANTS = {"4 layers": {},
            "5 layers": {"num_layers": 5},
            "head dim 256, 10:1": {"head_dim": 256, "num_heads": 10,
                                   "num_kv_heads": 1}}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_recurrentgemma_prefill_and_decode_match_jax(variant, dtype):
    jcfg, tcfg = _configs(compute_dtype=dtype, **VARIANTS[variant])
    assert tcfg == get_config(ARCH).reduced().replace(
        compute_dtype=dtype, **VARIANTS[variant])
    assert tcfg.window == 32 and tcfg.block_pattern == ("rec", "rec", "attn")
    np_params = jax_params(jcfg)
    tails = sorted(k for k in np_params if k.startswith("tail"))
    assert tails == (["tail0_rec", "tail1_rec"] if variant == "5 layers"
                     else ["tail0_rec"])
    toks = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (2, 72)).astype(np.int32)
    assert_close(run_both(jcfg, tcfg, np_params, toks, 64, 8), dtype)


def test_params_carry_over_and_init_in_the_compute_dtype():
    """The ``groups/{i}_{kind}`` and ``tail{j}_{kind}`` tree is the
    reference's, leaf for leaf; drawing the matrices straight into bf16
    gives the cast tree bit for bit, and the conv filter, its bias, the
    decay ``lam`` and the norm scales stay float32."""
    jcfg, tcfg = _configs(num_layers=5)
    np_params = jax_params(jcfg)
    model = get_model(tcfg)
    own = model.init(tcfg, torch.Generator().manual_seed(0))
    assert jax.tree.structure(jax.tree.map(lambda _: 0, own)) \
        == jax.tree.structure(jax.tree.map(lambda _: 0, np_params))
    for path, arr in jax.tree_util.tree_flatten_with_path(np_params)[0]:
        leaf = own
        for key in (p.key for p in path):
            leaf = leaf[key]
        assert tuple(leaf.shape) == arr.shape
    cast = cast_params(model.init(tcfg, torch.Generator().manual_seed(3)),
                       tcfg)
    direct = model.init(tcfg, torch.Generator().manual_seed(3),
                        dtype=torch.bfloat16)
    got = dict(jax.tree_util.tree_flatten_with_path(direct)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(cast)[0]:
        assert torch.equal(got[path], leaf), path
        want = torch.bfloat16 if path[-1].key in MATRICES else torch.float32
        assert leaf.dtype == want, path
    rec = cast["groups"]["0_rec"]
    assert {n for n in rec if n in MATRICES} \
        == {"wx", "wy", "wa", "wi", "wo", "wg", "wu", "wd"}
    assert model.cache_shapes(tcfg, 2, 64) == jax.tree.map(
        tuple, jax_hybrid.hybrid_cache_shapes(jcfg, 2, 64),
        is_leaf=lambda x: isinstance(x, tuple))
