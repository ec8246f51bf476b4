"""Shared by the port's model parity tests (``test_torch_window.py``,
``test_torch_moe.py``, ``test_torch_chunk.py``, ``test_torch_vlm.py``,
``test_torch_encdec.py``, ``test_torch_ssm.py``, ``test_torch_hybrid.py``): one configuration's prefill and teacher-forced
decode steps through the JAX model and the port on the same weights (the
JAX initialisation carried over as numpy by ``params_from_numpy``), the
same tokens and the same extra batch inputs (a VLM's image embeddings,
an enc-dec's frames), and the relative error the tests bound,
max|Δ| / max|ref|."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.tree_util import DictKey, tree_flatten_with_path, tree_map_with_path

from repro.models import cpu_mesh_ctx
from repro.models import get_model as jax_get_model
from repro_torch.launch.serve import pad_kv, prefix_len
from repro_torch.models import get_model
from repro_torch.models.convert import caches_from_numpy, params_from_numpy
from repro_torch.models.transformer import cast_params

REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / (np.abs(want).max() + 1e-9))


def jax_params(cfg) -> dict:
    """The JAX initialisation of ``cfg`` (key 0) as a numpy tree; one
    draw per configuration, whatever its compute dtype."""
    return _jax_params(cfg.replace(compute_dtype="float32"))


@functools.cache
def _jax_params(cfg) -> dict:
    params = jax_get_model(cfg).init(cfg, jax.random.key(0))
    return jax.tree.map(np.asarray, params)


def _pad_jax(caches, n):
    def f(path, x):
        keys = [p.key for p in path if isinstance(p, DictKey)]
        if keys and keys[-1] in ("k", "v"):
            pad = [(0, 0)] * x.ndim
            pad[-2] = (0, n)
            return jnp.pad(x, pad)
        return x
    return tree_map_with_path(f, caches)


def _leaf(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def run_both(jcfg, tcfg, np_params, toks: np.ndarray, prompt: int,
             steps: int, extra: dict | None = None) -> list:
    """Prefill ``toks[:, :prompt]`` in both packages, with the numpy batch
    inputs ``extra`` beside the tokens (``img_emb``, ``frames``), then
    ``steps`` decode steps fed ``toks`` (teacher forcing) at equal
    positions ``t``: a VLM's count its image tokens (``prefix_len``).
    Returns [(label, the port's output, the reference's)] for the
    prefill, every leaf of its cache tree, each step, and the first step
    again run from the JAX caches carried over by ``caches_from_numpy``.
    The self-attention caches grow by ``steps`` slots (leaves keyed "k"
    or "v", the reference's ``pad_kv``), the cross caches stay."""
    jmodel, tmodel, mctx = jax_get_model(jcfg), get_model(tcfg), \
        cpu_mesh_ctx()
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = cast_params(params_from_numpy(np_params, "cpu"), tcfg)
    extra = extra or {}
    out = []
    jl, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :prompt]),
                                 **{k: jnp.asarray(v)
                                    for k, v in extra.items()}}, jcfg, mctx)
    tl, tc = tmodel.prefill(tp, {"tokens": torch.from_numpy(
        toks[:, :prompt]), **{k: torch.from_numpy(v)
                              for k, v in extra.items()}}, tcfg)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    out.append(("prefill", tl, jl))
    assert sorted(tc) == sorted(jc)
    carried = caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    assert sorted(carried) == sorted(jc)
    for path, leaf in tree_flatten_with_path(jc)[0]:
        keys = tuple(p.key for p in path)
        want = np.asarray(leaf, np.float32)
        assert tuple(_leaf(tc, keys).shape) == want.shape
        assert _leaf(carried, keys).dtype == _leaf(tc, keys).dtype
        # a copy: decode writes the recurrent states in place
        out.append((f"cache {'.'.join(keys)}", _leaf(tc, keys).clone(),
                    want))
    jc = _pad_jax(jc, steps)
    carried = pad_kv(carried, steps)
    jdecode = jax.jit(lambda p, c, tok, t: jmodel.decode(p, c, tok, t, jcfg,
                                                         mctx))
    tc = pad_kv(tc, steps)
    for i in range(steps):
        j = prompt + i                   # the token fed
        t = prefix_len(tcfg) + j         # and its position
        jl, jc = jdecode(jp, jc, jnp.asarray(toks[:, j:j + 1]), jnp.int32(t))
        tl, tc = tmodel.decode(tp, tc, torch.from_numpy(toks[:, j:j + 1]),
                               t, tcfg)
        out.append((f"decode t={t}", tl, jl))
        if i == 0:
            tl, _ = tmodel.decode(tp, carried, torch.from_numpy(
                toks[:, j:j + 1]), t, tcfg)
            out.append((f"decode t={t} from the carried caches", tl, jl))
    return out


def assert_close(results: list, dtype: str) -> None:
    for label, got, want in results:
        err = rel_err(got, want)
        assert err <= REL_TOL[dtype], f"{label}: {err}"
