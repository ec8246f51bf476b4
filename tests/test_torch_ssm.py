"""The port's Mamba2 (SSD) family against the JAX package.

``models.layers.causal_conv1d`` / ``conv1d_step``, ``models.ssm.
ssd_chunked`` (S below, equal to and not a multiple of the chunk) and
``mamba_block`` in each mode, each against ``repro.models`` on the same
seeded numpy inputs and the same JAX weights; then the reduced
mamba2-130m (4 layers, d_model 64, state 16, SSD chunk 16) through both
models: a 40-token prefill (two chunks and a padded third) and 8
teacher-forced decode steps, the caches compared leaf for leaf.
max|Δ|/max|ref| within 1e-4 in float32 and 3e-2 in bfloat16
(``torch_model_parity.REL_TOL``: the two frameworks round bf16 products
at other places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import get_model, layers, ssm  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import MATRICES, cast_params  # noqa
from torch_model_parity import (REL_TOL, assert_close,  # noqa: E402
                                jax_params, rel_err, run_both)

ARCH = "mamba2-130m"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _configs(**kw):
    """The reduced mamba2-130m in both packages, field for field."""
    jcfg = jax_get_config(ARCH).reduced().replace(**kw)
    return jcfg, ArchConfig(**{f: getattr(jcfg, f)
                               for f in jcfg.__dataclass_fields__})


def _layer0(np_params: dict) -> dict:
    return {k: v[0] for k, v in np_params["layers"].items()}


@pytest.mark.parametrize("s", [1, 3, 17])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_and_step_match_reference(s, dtype):
    r = np.random.default_rng(s)
    jx, tx = _pair(r.normal(size=(2, s, 24)).astype(np.float32), dtype)
    w = r.normal(size=(24, 4)).astype(np.float32)
    b = r.normal(size=(24,)).astype(np.float32)
    want = jax_layers.causal_conv1d(jx, jnp.asarray(w), jnp.asarray(b))
    got = layers.causal_conv1d(tx, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert rel_err(got, want) <= REL_TOL[dtype]
    (jxt, txt), (jst, tst) = (
        _pair(r.normal(size=shape).astype(np.float32), dtype)
        for shape in ((2, 24), (2, 3, 24)))
    jy, jnew = jax_layers.conv1d_step(jxt, jst, jnp.asarray(w),
                                      jnp.asarray(b))
    ty, tnew = layers.conv1d_step(txt, tst, torch.from_numpy(w),
                                  torch.from_numpy(b))
    assert ty.dtype == txt.dtype and rel_err(ty, jy) <= REL_TOL[dtype]
    assert tnew.dtype == tst.dtype
    np.testing.assert_array_equal(tnew.float().numpy(),
                                  np.asarray(jnew, np.float32))


@pytest.mark.parametrize("s", [5, 16, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_reference(s, dtype):
    """S below, equal to and not a multiple of the chunk of 16; y and the
    final state come out float32 in both (the reference promotes its bf16
    operands against the float32 decays)."""
    r = np.random.default_rng(100 + s)
    jx, tx = _pair(r.normal(size=(2, s, 3, 8)).astype(np.float32), dtype)
    a = -np.abs(r.normal(size=(2, s, 3))).astype(np.float32) * 0.3
    jb, tb = _pair(r.normal(size=(2, s, 16)).astype(np.float32), dtype)
    jc, tc = _pair(r.normal(size=(2, s, 16)).astype(np.float32), dtype)
    jy, jst = jax_ssm.ssd_chunked(jx, jnp.asarray(a), jb, jc, 16)
    ty, tst = ssm.ssd_chunked(tx, torch.from_numpy(a), tb, tc, 16)
    assert ty.dtype == tst.dtype == torch.float32
    assert ty.shape == jy.shape and tst.shape == jst.shape
    assert rel_err(ty, jy) <= 1e-5 and rel_err(tst, jst) <= 1e-5


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_matches_reference(mode, dtype):
    jcfg, tcfg = _configs(compute_dtype=dtype)
    np_params = jax_params(jcfg)
    p = _layer0(np_params)
    r = np.random.default_rng(7)
    s = 1 if mode == "decode" else 21
    jx, tx = _pair(r.normal(size=(2, s, tcfg.d_model)).astype(np.float32),
                   dtype)
    jcache = tcache = None
    if mode == "decode":
        shapes = ssm.ssm_cache_shapes(tcfg, 2, 1)
        pairs = {k: _pair(r.normal(size=shape[1:]).astype(np.float32),
                          dtype) for k, shape in shapes.items()}
        jcache = {k: j for k, (j, _) in pairs.items()}
        tcache = {k: t for k, (_, t) in pairs.items()}
    jy, jnew = jax_ssm.mamba_block(jax.tree.map(jnp.asarray, p), jx, jcfg,
                                   mode=mode, cache=jcache)
    ty, tnew = ssm.mamba_block(params_from_numpy(p, "cpu"), tx, tcfg,
                               mode=mode, cache=tcache)
    assert ty.dtype == tx.dtype and rel_err(ty, jy) <= REL_TOL[dtype]
    if mode == "train":
        assert tnew is None and jnew is None
        return
    assert sorted(tnew) == sorted(jnew) == ["conv", "state"]
    for k in tnew:
        assert tnew[k].dtype == tx.dtype and tnew[k].shape == jnew[k].shape
        assert rel_err(tnew[k], jnew[k]) <= REL_TOL[dtype], k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_mamba2_prefill_and_decode_match_jax(dtype):
    jcfg, tcfg = _configs(compute_dtype=dtype)
    assert tcfg == get_config(ARCH).reduced().replace(compute_dtype=dtype)
    assert (tcfg.num_layers, tcfg.ssd_chunk, tcfg.ssm_state) == (4, 16, 16)
    toks = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 48)).astype(np.int32)
    assert_close(run_both(jcfg, tcfg, jax_params(jcfg), toks, 40, 8), dtype)


def test_params_carry_over_and_init_in_the_compute_dtype():
    """The port's tree is the reference's, leaf for leaf; drawing the
    projections straight into bf16 gives the cast tree bit for bit, and
    the conv filter, decays and biases stay float32 (the reference uses
    them so)."""
    jcfg, tcfg = _configs()
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
    for name, leaf in cast["layers"].items():
        assert torch.equal(direct["layers"][name], leaf), name
        want = torch.bfloat16 if name in MATRICES else torch.float32
        assert leaf.dtype == want, name
    assert {n for n in cast["layers"] if n in MATRICES} \
        == {"wz", "wxbc", "wdt", "out_proj"}
    assert model.cache_shapes(tcfg, 2, 64) == jax_ssm.ssm_cache_shapes(
        jcfg, 2, 64)
