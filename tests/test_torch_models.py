"""The port's dense decoder against the JAX package's, on the reduced
llama3.2-3b config (4 layers, d_model 64, 4 heads, 2 KV heads, vocab
256).

Both packages get the same weights (the JAX initialisation carried over
as numpy by ``params_from_numpy``) and the same tokens; prefill logits
and caches and 8 teacher-forced decode steps must agree within
max|Δ|/max|ref| 1e-4 at ``compute_dtype="float32"`` and 3e-2 in bfloat16
(the two frameworks round bf16 products at other places).  The prompt
is 64 tokens, a multiple of the reduced config's 32-key attention chunk
(the reference's ``chunked_attention`` reads a clamped last chunk under
wrong positions otherwise).  On the CPU the port's attention runs the
kernels' plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from jax.tree_util import DictKey, tree_map_with_path  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import cpu_mesh_ctx  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import get_model, layers  # noqa: E402
from repro_torch.models.convert import (caches_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.models.transformer import cast_params  # noqa: E402

ARCH = "llama3.2-3b"
REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
PROMPT, STEPS, BATCH = 64, 8, 2


def _rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / (np.abs(want).max() + 1e-9))


def test_rms_norm_rotary_swiglu_match_jax():
    r = np.random.default_rng(0)
    x = r.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = r.normal(size=(16,)).astype(np.float32)
    pos = np.arange(5)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        tol = 1e-5 if tdt == torch.float32 else 2e-2
        jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
        np.testing.assert_allclose(
            layers.rms_norm(tx, torch.from_numpy(scale)).float().numpy(),
            np.asarray(jax_layers.rms_norm(jx, jnp.asarray(scale)),
                       np.float32), atol=tol, rtol=tol)
        np.testing.assert_allclose(
            layers.rotary(tx, torch.from_numpy(pos), 500_000.0)
            .float().numpy(),
            np.asarray(jax_layers.rotary(jx, jnp.asarray(pos), 500_000.0),
                       np.float32), atol=tol, rtol=tol)
    w = [r.normal(size=s).astype(np.float32) * 0.2
         for s in ((16, 32), (16, 32), (32, 16))]
    h = r.normal(size=(2, 5, 16)).astype(np.float32)
    np.testing.assert_allclose(
        layers.swiglu(torch.from_numpy(h), *map(torch.from_numpy, w)).numpy(),
        np.asarray(jax_layers.swiglu(jnp.asarray(h), *map(jnp.asarray, w))),
        atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_get_config(ARCH).reduced()
    params = jax_get_model(cfg).init(cfg, jax.random.key(0))
    return jax.tree.map(np.asarray, params)


def _tree_items(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _tree_items(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def test_params_carry_over_with_an_identical_tree(jax_params):
    cfg = get_config(ARCH).reduced()
    tparams = params_from_numpy(jax_params, "cpu")
    own = get_model(cfg).init(cfg, torch.Generator().manual_seed(0))
    got, mine = dict(_tree_items(tparams)), dict(_tree_items(own))
    want = dict(_tree_items(jax_params))
    assert got.keys() == want.keys() == mine.keys()
    assert ("layers", "dense0", "wq") in got
    for path, arr in want.items():
        assert tuple(got[path].shape) == arr.shape == tuple(mine[path].shape)
        assert got[path].dtype == mine[path].dtype == torch.float32
        np.testing.assert_array_equal(got[path].numpy(), arr)
    # the reference's rule: >= 2-D leaves drawn (stacked norms too), 1-D ones
    assert torch.equal(mine["ln_f",], torch.ones(cfg.d_model))
    assert 0.015 < float(mine["layers", "dense0", "wq"].std()) < 0.025


def _pad_jax(caches, n):
    def f(path, x):
        keys = [p.key for p in path if isinstance(p, DictKey)]
        if keys and keys[-1] in ("k", "v"):
            pad = [(0, 0)] * x.ndim
            pad[-2] = (0, n)
            return jnp.pad(x, pad)
        return x
    return tree_map_with_path(f, caches)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(jax_params, dtype):
    jcfg = jax_get_config(ARCH).reduced().replace(compute_dtype=dtype)
    tcfg = get_config(ARCH).reduced().replace(compute_dtype=dtype)
    jmodel, tmodel, mctx = jax_get_model(jcfg), get_model(tcfg), \
        cpu_mesh_ctx()
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (BATCH, PROMPT + STEPS)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, jax_params)
    tp = cast_params(params_from_numpy(jax_params, "cpu"), tcfg)
    tol = REL_TOL[dtype]

    jl, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                            jcfg, mctx)
    tl, tc = tmodel.prefill(tp, {"tokens": torch.from_numpy(
        toks[:, :PROMPT])}, tcfg)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    assert _rel_err(tl, jl) <= tol
    for kv in ("k", "v"):
        want = np.asarray(jc["dense0"][kv], np.float32)
        assert tuple(tc["dense0"][kv].shape) == want.shape
        assert _rel_err(tc["dense0"][kv], want) <= tol
    # the caches carry across too: the JAX cache drives the port's decode
    assert caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu")[
        "dense0"]["k"].dtype == tc["dense0"]["k"].dtype

    jc = _pad_jax(jc, STEPS)
    tc = {g: {kv: F.pad(c, (0, 0, 0, STEPS)) for kv, c in d.items()}
          for g, d in tc.items()}
    for i in range(STEPS):
        t = PROMPT + i
        jl, jc = jmodel.decode(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                               jnp.int32(t), jcfg, mctx)
        tl, tc = tmodel.decode(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                               t, tcfg)
        assert _rel_err(tl, jl) <= tol, f"decode step {i}"


def test_window_config_raises_not_computed_another_way():
    """A sliding window, the chunked local window (``chunk_attn``) and
    every family are ported (``test_torch_window.py``,
    ``test_torch_chunk.py``, ``test_torch_vlm.py``,
    ``test_torch_encdec.py``, ``test_torch_ssm.py``,
    ``test_torch_hybrid.py``): each family resolves to its own entry
    points, and a family handed to another family's entry points raises
    rather than computing something else."""
    from repro_torch.models import hybrid, ssm
    cfg = get_config(ARCH).reduced()
    params = cast_params(get_model(cfg).init(cfg, torch.Generator()), cfg)
    for family, prefill in (("ssm", ssm.ssm_prefill),
                            ("hybrid", hybrid.hybrid_prefill)):
        assert get_model(cfg.replace(family=family)).prefill is prefill
    with pytest.raises(NotImplementedError, match="does not run on these"):
        get_model(cfg).prefill(
            params, {"tokens": torch.zeros((1, 8), dtype=torch.long)},
            cfg.replace(family="encdec"))
    for family in ("vlm", "encdec"):
        assert get_model(cfg.replace(family=family)) is not None


def test_serve_reduced_on_cpu_has_the_reference_keys():
    res = serve(ARCH, requests=2, prompt_len=32, decode=3, device="cpu",
                verbose=False)
    assert {"arch", "requests", "generated", "tokens_per_s", "wall_s",
            "sample"} <= res.keys()
    assert res["generated"] == 4 and len(res["sample"]) == 4
    assert res["launches"] == {"flash_attention": 0, "decode_attention": 0}
    assert res["prefill_s"] > 0 and res["peak_mem_gb"] is None


def test_serve_without_device_raises_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(ARCH, requests=1, prompt_len=8, decode=1, verbose=False)
