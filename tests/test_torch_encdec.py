"""The port's Whisper-style encoder-decoder against the JAX package.

The layers it brings: ``sinusoid_positions`` (the encoder's position
table), and ``layer_norm`` and ``gelu_mlp``, which the reference's
``layers.py`` has and whisper's blocks do not call (they use
``rms_norm`` and ``swiglu``, as the reference's ``attn_block`` and
``dense_ffn_block`` do).  Then the reduced whisper-medium (two encoder
and four decoder layers, ``enc_seq`` 16, GQA 4:2) through both models on
the same weights (the JAX initialisation carried over by
``params_from_numpy``), the same frames [B, 16, 1024] and tokens: the
encoder's output, the prefill's logits, its self-attention caches and its
cross-attention caches (``cross_k``/``cross_v`` leaves of the tree) and 8
teacher-forced decode steps, max|Δ|/max|ref| 1e-4 in float32 and 3e-2 in
bfloat16 (``tests/torch_model_parity.py``).  The reduced ``enc_seq`` 16
is its own key chunk (``kv_chunk = min(32, 16)``); at full width 1,500
frames are not a multiple of 1,024, where the reference's attention reads
a clamped chunk (ROADMAP, Reference caveats).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import cpu_mesh_ctx  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import get_model, layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from torch_model_parity import (REL_TOL, assert_close,  # noqa: E402
                                jax_params, rel_err, run_both)

ARCH = "whisper-medium"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(**kw):
    jcfg = jax_get_config(ARCH).reduced().replace(**kw)
    return jcfg, ArchConfig(**{f: getattr(jcfg, f)
                               for f in jcfg.__dataclass_fields__})


def _frames(cfg, b: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_seq, tfm.VIT_STUB_DIM)).astype(np.float32)


@pytest.mark.parametrize("seq,dim", [(1500, 1024), (16, 64), (7, 2),
                                     (5, 3)])
def test_sinusoid_positions_match_reference(seq, dim):
    want = np.asarray(jax_layers.sinusoid_positions(seq, dim))
    got = layers.sinusoid_positions(seq, dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    # angles up to 1,499 rad: sin/cos of float32 arguments, a few ulps of
    # the argument apart between the two libraries
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    r = np.random.default_rng(8)
    x = (r.normal(size=(2, 5, 64)) * 3 + 1).astype(np.float32)
    scale, bias = (r.normal(size=64).astype(np.float32) for _ in range(2))
    jdt, tdt = DTYPES[dtype]
    want = jax_layers.layer_norm(jnp.asarray(x, jdt), jnp.asarray(scale),
                                 jnp.asarray(bias))
    got = layers.layer_norm(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == tdt
    assert rel_err(got, want) <= {"float32": 1e-5, "bfloat16": 1e-2}[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(dtype):
    r = np.random.default_rng(9)
    x = r.normal(size=(2, 6, 64)).astype(np.float32)
    w = {"wi": r.normal(size=(64, 128)) * 0.1, "bi": r.normal(size=128),
         "wo": r.normal(size=(128, 64)) * 0.1, "bo": r.normal(size=64)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    jdt, tdt = DTYPES[dtype]
    want = jax_layers.gelu_mlp(jnp.asarray(x, jdt),
                               *(jnp.asarray(w[k]) for k in w))
    got = layers.gelu_mlp(torch.from_numpy(x).to(tdt),
                          *(torch.from_numpy(w[k]) for k in w))
    assert got.dtype == tdt
    assert rel_err(got, want) <= REL_TOL[dtype]


def test_trees_match_reference():
    """The parameter tree and the cache tree, key for key and shape for
    shape; the reduced config is the reference's."""
    jcfg, tcfg = _configs()
    assert tcfg == get_config(ARCH).reduced()
    assert (tcfg.enc_layers, tcfg.enc_seq, tcfg.head_dim) == (2, 16, 16)
    np_params = jax_params(jcfg)
    shapes = get_model(tcfg).param_shapes(tcfg)
    flat = dict(jax.tree_util.tree_flatten_with_path(
        shapes, is_leaf=lambda x: isinstance(x, tuple))[0])
    want = {path: arr.shape for path, arr in
            jax.tree_util.tree_flatten_with_path(np_params)[0]}
    assert {p: tuple(s) for p, s in flat.items()} == want
    assert get_model(tcfg).cache_shapes(tcfg, 2, 40) == \
        jax_tfm.encdec_cache_shapes(jcfg, 2, 40)


def test_init_in_the_compute_dtype_casts_the_cross_weights():
    """Drawing straight into bf16 gives the tree ``cast_params`` makes
    from the float32 one, bit for bit; the cross-attention and frame
    projections are cast with the layer matrices, norms stay float32."""
    cfg = get_config(ARCH).reduced()
    model = get_model(cfg)
    cast = tfm.cast_params(model.init(cfg, torch.Generator().manual_seed(3)),
                           cfg)
    direct = model.init(cfg, torch.Generator().manual_seed(3),
                        dtype=torch.bfloat16)
    got = dict(jax.tree_util.tree_flatten_with_path(direct)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(cast)[0]:
        assert got[path].dtype == leaf.dtype and torch.equal(got[path], leaf)
    for name in ("x_wq", "x_wk", "x_wv", "x_wo", "wq"):
        assert cast["dec_layers"][name].dtype == torch.bfloat16
    assert cast["frame_proj"].dtype == torch.bfloat16
    assert cast["dec_layers"]["x_ln1"].dtype == torch.float32
    assert cast["ln_enc"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_output_matches_jax(dtype):
    jcfg, tcfg = _configs(compute_dtype=dtype)
    np_params = jax_params(jcfg)
    frames = _frames(tcfg, 2, 5)
    want = jax_tfm._encode(jax.tree.map(jnp.asarray, np_params),
                           jnp.asarray(frames), jcfg, cpu_mesh_ctx())
    got = tfm._encode(tfm.cast_params(params_from_numpy(np_params, "cpu"),
                                      tcfg), torch.from_numpy(frames), tcfg)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == want.shape
    assert rel_err(got, want) <= REL_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_whisper_prefill_and_decode_match_jax(dtype):
    jcfg, tcfg = _configs(compute_dtype=dtype)
    toks = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 40)).astype(np.int32)
    results = run_both(jcfg, tcfg, jax_params(jcfg), toks, 32, 8,
                       extra={"frames": _frames(tcfg, 2, 6)})
    labels = [label for label, _, _ in results]
    assert {"cache self.k", "cache self.v", "cache cross_k",
            "cache cross_v"} <= set(labels)
    cross = dict((label, got) for label, got, _ in results)["cache cross_k"]
    assert cross.shape == (tcfg.num_layers, 2, tcfg.num_kv_heads,
                           tcfg.enc_seq, tcfg.head_dim)
    assert labels[-1] == "decode t=39"
    assert_close(results, dtype)


def test_decode_matches_prefill_over_one_more_token():
    """The port alone, in float32: a decode step at t = S after a prefill
    of S tokens equals the last logits of a prefill over S + 1 on the same
    frames; the cross caches are not grown by ``pad_kv``."""
    cfg = get_config(ARCH).reduced().replace(compute_dtype="float32")
    model = get_model(cfg)
    params = tfm.cast_params(model.init(cfg,
                                        torch.Generator().manual_seed(0)),
                             cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 21),
                         generator=torch.Generator().manual_seed(1))
    frames = torch.from_numpy(_frames(cfg, 2, 3))
    _, caches = model.prefill(params, {"tokens": toks[:, :20],
                                       "frames": frames}, cfg)
    grown = serve_mod.pad_kv(caches, 1)
    assert grown["self"]["k"].shape[-2] == 21
    assert grown["cross_k"] is caches["cross_k"]
    got, _ = model.decode(params, grown, toks[:, 20:], 20, cfg)
    want, _ = model.prefill(params, {"tokens": toks, "frames": frames}, cfg)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_serve_reduced_whisper_on_cpu():
    res = serve_mod.serve(ARCH, requests=2, prompt_len=12, decode=3,
                          device="cpu", verbose=False)
    assert res["generated"] == 4 and len(res["sample"]) == 4
    assert all(0 <= t < get_config(ARCH).vocab_size for t in res["sample"])
