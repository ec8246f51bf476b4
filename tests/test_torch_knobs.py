"""The reference's attention and remat knobs on one device, against the
JAX package at the reduced size:

* ``pad_heads_to``: group-major head padding (``wq`` with
  ``padded_heads`` heads, the pad heads' outputs dropped before ``wo``):
  the prefill, decode steps and the loss with every gradient leaf equal
  the reference's on the reference's own weights, whose pad columns of
  ``wq`` are drawn like the others (not zero);
* ``attn_f32_scores=False``: the probabilities enter the P V product in
  the compute dtype; the plain attention against the reference's
  ``chunked_attention(..., f32_stats=False)`` and the bf16 loss against
  the reference's;
* ``remat="dots"``: the decoder stack keeps the outputs of its products
  without a batch dimension; the loss and every gradient leaf equal
  "full"'s bit for bit, and the backward pass runs no product of a layer
  again (``aten.mm`` counted under ``chip_smoke.count_mm``, the
  dispatch mode that counts the same products on the card).
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.tree_util import tree_flatten_with_path  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import cpu_mesh_ctx  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models.layers import chunked_attention as jax_attention  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attn.ref import flash_attention_ref  # noqa
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from torch_model_parity import (assert_close, jax_params,  # noqa: E402
                                rel_err, run_both)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parent.parent
    / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
count_mm = chip_smoke.count_mm

REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# (arch, replacements): 6 q heads on 2 KV heads padded to 8 (3 real and
# one pad head a group), and the hybrid's 4 q heads on its one KV head
# padded to 6 (the pad heads after the real ones)
PADDED = {"llama3.2-3b": {"num_heads": 6, "pad_heads_to": 8},
          "recurrentgemma-2b": {"pad_heads_to": 6}}


def _batch(cfg, b=2, s=64, seed=0) -> dict:
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _port_loss_and_grads(tcfg, np_params, batch):
    tp = {}

    def leaves(t):
        if isinstance(t, dict):
            return {k: leaves(v) for k, v in t.items()}
        return t.requires_grad_(True)
    tp = leaves(params_from_numpy(np_params, "cpu"))
    loss = get_model(tcfg).loss(
        tp, {"tokens": torch.from_numpy(batch["tokens"]).long()}, tcfg)
    loss.backward()
    return loss, tp


def _check_grads(jg, tp, tol) -> int:
    checked = 0
    for path, want in tree_flatten_with_path(jg)[0]:
        got = tp
        for p in path:
            got = got[p.key]
        err = rel_err(got.grad, want)
        assert err <= tol, ([p.key for p in path], err)
        checked += 1
    return checked


@pytest.mark.parametrize("arch", list(PADDED))
def test_padded_heads_serve_as_the_reference(arch):
    """A 24-token prefill, its caches and 4 decode steps on the
    reference's weights (float32)."""
    jcfg = jax_get_config(arch).reduced().replace(
        compute_dtype="float32", **PADDED[arch])
    tcfg = get_config(arch).reduced().replace(compute_dtype="float32",
                                              **PADDED[arch])
    np_params = jax_params(jcfg)
    wq = np_params["layers"]["dense0"]["wq"] if "layers" in np_params \
        else np_params["groups"]["2_attn"]["wq"]
    assert wq.shape[-1] == tcfg.padded_heads * tcfg.head_dim
    # the reference draws the pad heads' columns too
    pad = [j for j in range(tcfg.padded_heads)
           if tfm._real_index(tcfg, j) is None]
    assert pad and all(np.abs(wq[..., j * 16:(j + 1) * 16]).max() > 0
                       for j in pad)
    toks = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 28)).astype(np.int32)
    assert_close(run_both(jcfg, tcfg, np_params, toks, 24, 4), "float32")


def test_padded_heads_loss_and_gradients_match_reference():
    arch = "llama3.2-3b"
    jcfg = jax_get_config(arch).reduced().replace(
        compute_dtype="float32", **PADDED[arch])
    tcfg = get_config(arch).reduced().replace(compute_dtype="float32",
                                              **PADDED[arch])
    np_params = jax_params(jcfg)
    batch = _batch(jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    jl, jg = jax.value_and_grad(lambda p: jax_get_model(jcfg).loss(
        p, {"tokens": jnp.asarray(batch["tokens"])}, jcfg,
        cpu_mesh_ctx()))(jp)
    loss, tp = _port_loss_and_grads(tcfg, np_params, batch)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    assert _check_grads(jg, tp, REL_TOL["float32"]) >= 9
    # the pad heads' wq columns take no gradient in either package
    g = tp["layers"]["dense0"]["wq"].grad.reshape(4, 64, 8, 16)
    assert torch.all(g[:, :, [3, 7]] == 0)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_bf16_probabilities_attention_matches_reference(causal, window):
    """bf16 q, k, v [2, 4, 40, 16] on 2 KV heads over 40 keys in one key
    chunk (the reference's online softmax then takes one row maximum): the
    plain version under each ``f32_stats`` against the reference's under
    the same setting, and closer to it than the reference's two settings
    are to each other.  The settings differ by a bf16 ulp of the output
    in about a fifth of its elements; the port differs from the
    reference's same setting in at most 0.1 % of them and by a tenth of
    that mean gap (a port that rounds P elsewhere fails)."""
    r = np.random.default_rng(7)
    q, k, v = (r.standard_normal(s).astype(np.float32) for s in
               ((2, 4, 40, 16), (2, 2, 40, 16), (2, 2, 40, 16)))
    q *= 3.0                                  # peaked rows
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    out, want = {}, {}
    for f32 in (True, False):
        want[f32] = np.asarray(jax_attention(
            *jb, causal=causal, window=window, q_chunk=40, kv_chunk=40,
            f32_stats=f32), np.float32)
        got = flash_attention_ref(*tb, causal=causal, window=window,
                                  f32_stats=f32)
        assert got.dtype == torch.bfloat16
        out[f32] = got.float().numpy()
        assert np.abs(out[f32] - want[f32]).max() <= 1.6e-2, f32
    gap = np.abs(want[True] - want[False])
    assert (gap > 0).mean() > 0.1 and np.abs(out[True] - out[False]).max(
        ) > 1e-3
    for f32 in (True, False):
        err = np.abs(out[f32] - want[f32])
        assert (err > 0).mean() <= 1e-3, f32
        assert err.mean() <= gap.mean() / 10, f32


def test_bf16_probabilities_loss_matches_reference():
    """The reduced llama in bf16 with ``attn_f32_scores=False``: the loss
    and every gradient leaf against the reference's, and the loss apart
    from the float32-statistics loss (the knob reaches the attention)."""
    arch = "llama3.2-3b"
    jcfg = jax_get_config(arch).reduced().replace(
        compute_dtype="bfloat16", attn_f32_scores=False)
    tcfg = get_config(arch).reduced().replace(compute_dtype="bfloat16",
                                              attn_f32_scores=False)
    np_params = jax_params(jcfg)
    batch = _batch(jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jax_get_model(jcfg).loss(
        p, {"tokens": jnp.asarray(batch["tokens"])}, jcfg,
        cpu_mesh_ctx())))(jp)
    loss, tp = _port_loss_and_grads(tcfg, np_params, batch)
    assert abs(float(loss.detach()) - float(jl)) <= REL_TOL["bfloat16"] * abs(
        float(jl))
    assert _check_grads(jg, tp, REL_TOL["bfloat16"]) >= 9
    with torch.no_grad():
        full = get_model(tcfg).loss(
            params_from_numpy(np_params, "cpu"),
            {"tokens": torch.from_numpy(batch["tokens"]).long()},
            tcfg.replace(attn_f32_scores=True))
    assert float(full) != float(loss.detach())


def _loss_grads_and_mm(cfg, np_params, batch):
    tp = {}

    def leaves(t):
        if isinstance(t, dict):
            return {k: leaves(v) for k, v in t.items()}
        return t.requires_grad_(True)
    tp = leaves(params_from_numpy(np_params, "cpu"))
    with count_mm(torch) as mm:
        loss = get_model(cfg).loss(
            tp, {"tokens": torch.from_numpy(batch["tokens"]).long()}, cfg)
        loss.backward()
    flat = {}

    def walk(t, path=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = v.grad
    walk(tp)
    return loss, flat, mm.fwd, mm.bwd


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mixtral-8x7b"])
def test_remat_dots_equals_full_bit_for_bit(arch):
    """The loss and every gradient leaf under "dots" equal "full"'s (and
    "none"'s) exactly, in bf16 compute.  The backward pass under "dots"
    runs the products' gradients (two ``mm`` each) and the loss chunks'
    own recomputation (one each) and no layer product again, as "none"
    does; "full" runs each layer's products again (a dense layer's all
    but its last, whose output its backward does not need)."""
    cfg = get_config(arch).reduced().replace(compute_dtype="bfloat16")
    np_params = jax_params(jax_get_config(arch).reduced())
    batch = _batch(cfg, s=64)
    chunks = 2 * 64 // cfg.loss_chunk
    got = {remat: _loss_grads_and_mm(cfg.replace(remat=remat), np_params,
                                     batch)
           for remat in ("none", "full", "dots")}
    loss, grads, fwd, bwd = got["dots"]
    for other in ("full", "none"):
        o_loss, o_grads, o_fwd, _ = got[other]
        assert torch.equal(loss, o_loss), other
        assert o_grads.keys() == grads.keys()
        for path, g in grads.items():
            assert torch.equal(g, o_grads[path]), (other, path)
        assert o_fwd == fwd
    assert bwd == 2 * fwd + chunks == got["none"][3]
    layers = tfm._layer_group_shapes(cfg)
    n_layers = sum(g["ln1"][0] for g in layers.values())
    assert fwd - chunks - n_layers <= got["full"][3] - bwd <= fwd - chunks


def test_remat_dots_is_full_outside_the_decoder_stack():
    """The enc-dec, SSM and hybrid stacks recompute everything under
    "dots", as the reference's ``jax.checkpoint`` without a policy does:
    the backward runs as many products as under "full"."""
    for arch in ("whisper-medium", "mamba2-130m", "recurrentgemma-2b"):
        cfg = get_config(arch).reduced().replace(compute_dtype="float32")
        model = get_model(cfg)
        params = model.init(cfg, torch.Generator().manual_seed(0))
        r = np.random.default_rng(1)
        batch = {"tokens": torch.from_numpy(r.integers(
            0, cfg.vocab_size, (2, 32))).long()}
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy(r.standard_normal(
                (2, cfg.enc_seq, 1024)).astype(np.float32))
        counts = {}
        for remat in ("full", "dots"):
            p = {k: v for k, v in params.items()}
            leaves = [t.requires_grad_(True) for t in _tensors(p)]
            loss = model.loss(p, batch, cfg.replace(remat=remat))
            with count_mm(torch) as mm:
                grads = torch.autograd.grad(loss, leaves)
            counts[remat] = (float(loss.detach()), mm.bwd,
                             [g.clone() for g in grads])
        assert counts["full"][:2] == counts["dots"][:2], arch
        assert all(torch.equal(a, b) for a, b in zip(counts["full"][2],
                                                     counts["dots"][2]))


def _tensors(tree):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v
