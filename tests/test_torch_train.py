"""The port's ``train/`` against the JAX package's ``repro.train`` on the
CPU.

AdamW, ``global_norm`` and the int8 compression run on the same numpy
trees in both packages: the compression's codes, scales and error buffers
must be equal (``==``), the optimizer's parameters and moments within
1e-6 of max|p| (float32 arithmetic in another order), with ``opt_dtype``
float32 and bfloat16 (a bfloat16 moment may round one step the other way:
the moments are held within ``MOMENT_TOL``, and the parameters get the
update's share of that step as slack).  ``make_train_step`` trains the reduced llama3.2-3b
for 3 steps from the reference's initialisation on the same numpy
batches: losses, gradient norms and every parameter within ``REL_TOL``
(max|Δ| / max|ref|: 1e-4 at compute dtype float32, 3e-2 in bfloat16).
Microbatching (2 parts) against one batch.  The parameters and moments
are updated in place in the port, so each test hands it copies.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.tree_util import tree_flatten_with_path  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import cpu_mesh_ctx  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.train import grad_compress as jgc  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.train_step import \
    make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.train import grad_compress as tgc  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.tree import leaves, tree_map  # noqa: E402

REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# the moments as stored: float32 arithmetic in another order, and in
# bfloat16 a value on a rounding edge may land one step away (2^-7 of
# itself, 7 stored mantissa bits)
MOMENT_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
# the train steps' learning rate, the training driver's default.  Adam's
# first step moves every element by lr * g / (|g| + eps), about lr times
# the gradient's sign, so an element whose bf16 gradient (near 0) rounds
# to the other sign in one framework lands 2 lr away: at lr 1e-3 that is
# under 3e-2 of max|p| (~0.09 for N(0, 0.02) matrices)
LR = 1e-3
ARCH = "llama3.2-3b"


def _tree(seed=0, scale=1.0):
    r = np.random.default_rng(seed)
    return {"embed": (r.standard_normal((64, 16)) * scale).astype(np.float32),
            "ln_f": (1 + r.standard_normal(16) * scale).astype(np.float32),
            "layers": {"dense0": {
                "wq": (r.standard_normal((2, 16, 32)) * scale
                       ).astype(np.float32),
                "ln1": (1 + r.standard_normal((2, 16)) * scale
                        ).astype(np.float32)}}}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in tree_flatten_with_path(tree)[0]}


def test_tree_paths_are_keystr_in_the_reference_order():
    tree = (_tree(), {"step": np.int32(3), "m": _tree(1)})
    want = [jax.tree_util.keystr(p)
            for p, _ in tree_flatten_with_path(tree)[0]]
    assert [p for p, _ in leaves(tree)] == want


def test_global_norm_matches():
    g = _tree(2)
    got = topt.global_norm(params_from_numpy(g, "cpu"))
    want = jopt.global_norm(jax.tree.map(jnp.asarray, g))
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
def test_adamw_matches_over_steps(opt_dtype):
    """Four updates from the same parameters and gradients, one of them
    clipped (grad norm above ``grad_clip``); decay on every leaf of two or
    more dimensions, the stacked norm scales [L, d] included."""
    ocfg_t = topt.AdamWConfig(lr=1e-2, opt_dtype=opt_dtype)
    ocfg_j = jopt.AdamWConfig(lr=1e-2, opt_dtype=opt_dtype)
    p_np = _tree(0)
    tp = params_from_numpy(p_np, "cpu")
    jp = jax.tree.map(jnp.asarray, p_np)
    to, jo = topt.init_opt_state(tp, ocfg_t), jopt.init_opt_state(jp, ocfg_j)
    assert to["m"]["embed"].dtype == getattr(torch, opt_dtype)
    for step in range(4):
        g_np = _tree(10 + step, scale=0.3 if step else 3.0)
        tp, to, tm = topt.adamw_update(tp, params_from_numpy(g_np, "cpu"),
                                       to, ocfg_t)
        jp, jo, jm = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g_np),
                                       jo, ocfg_j)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-6 * float(jm["grad_norm"])
        assert int(to["step"]) == int(jo["step"]) == step + 1
        assert to["step"].dtype == torch.int32
        scale = max(np.abs(x).max() for x in _flat(jp).values())
        for name in ("m", "v"):
            for (path, got), want in zip(leaves(to[name]),
                                         _flat(jo[name]).values()):
                assert np.abs(_np(got) - want).max() <= MOMENT_TOL[
                    opt_dtype] * np.abs(want).max(), (name, path)
        # bf16 moments: an element whose moment rounded one step the other
        # way (MOMENT_TOL) moves its update lr * m / sqrt(v) by up to
        # 2^-7 of it, once a step
        slack = 0.0 if opt_dtype == "float32" else \
            (step + 1) * ocfg_t.lr * MOMENT_TOL["bfloat16"]
        for (path, got), want in zip(leaves(tp), _flat(jp).values()):
            assert np.abs(_np(got) - want).max() <= 1e-6 * scale + slack, \
                path


def test_int8_compression_equals_reference():
    g_np, e_np = _tree(3, 0.05), _tree(4, 0.001)
    e_t = tree_map(lambda t: t.to(torch.bfloat16),
                   params_from_numpy(e_np, "cpu"))
    e_j = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), e_np)
    for _ in range(3):          # the error buffer carried over steps
        qt, st, e_t = tgc.compress_with_feedback(
            params_from_numpy(g_np, "cpu"), e_t)
        qj, sj, e_j = jgc.compress_with_feedback(
            jax.tree.map(jnp.asarray, g_np), e_j)
        for (path, a), b in zip(leaves(qt), jax.tree.leaves(qj)):
            assert a.dtype == torch.int8
            assert np.array_equal(a.numpy(), np.asarray(b)), path
        for (path, a), b in zip(leaves(st), jax.tree.leaves(sj)):
            assert float(a) == float(b), path
        for (path, a), b in zip(leaves(e_t), jax.tree.leaves(e_j)):
            assert a.dtype == torch.bfloat16
            assert np.array_equal(_np(a), np.asarray(b, np.float32)), path
        for (path, a), b in zip(leaves(tree_map(tgc.dequantize_int8, qt, st)),
                                jax.tree.leaves(jax.tree.map(
                                    jgc.dequantize_int8, qj, sj))):
            assert np.array_equal(a.numpy(), np.asarray(b)), path
    buf = tgc.init_error_buf(params_from_numpy(g_np, "cpu"))
    assert all(t.dtype == torch.bfloat16 and not bool(t.any())
               for _, t in leaves(buf))


def _batches(cfg, n, b=2, s=64, seed=0):
    r = np.random.default_rng(seed)
    return [{"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
            for _ in range(n)]


def _run_both(dtype: str, microbatch: int = 1, steps: int = 3, b: int = 2):
    jcfg = jax_get_config(ARCH).reduced().replace(compute_dtype=dtype)
    tcfg = get_config(ARCH).reduced().replace(compute_dtype=dtype)
    jp = jax_get_model(jcfg).init(jcfg, jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(np_params, "cpu")
    ocfg_j = jopt.AdamWConfig(lr=LR)
    ocfg_t = topt.AdamWConfig(lr=LR)
    jo, to = jopt.init_opt_state(jp, ocfg_j), topt.init_opt_state(tp, ocfg_t)
    jstep = jax.jit(jax_make_train_step(jcfg, cpu_mesh_ctx(), ocfg_j,
                                        microbatch))
    tstep = make_train_step(tcfg, ocfg_t, microbatch)
    out = []
    for bt in _batches(jcfg, steps, b=b):
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(bt["tokens"])})
        tp, to, tm = tstep(tp, to, {"tokens": torch.from_numpy(
            bt["tokens"]).long()})
        # a copy: the next step updates tp in place
        out.append((tm, jm, tree_map(torch.clone, tp), jp))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_tracks_reference_over_three_steps(dtype):
    tol = REL_TOL[dtype]
    for i, (tm, jm, tp, jp) in enumerate(_run_both(dtype)):
        for key in ("loss", "grad_norm"):
            got, want = float(tm[key]), float(jm[key])
            assert abs(got - want) <= tol * abs(want), (i, key, got, want)
        for (path, got), want in zip(leaves(tp), _flat(jp).values()):
            err = np.abs(_np(got) - want).max() / (np.abs(want).max() + 1e-30)
            assert err <= tol, (i, path, err)


def test_microbatch_two_matches_one():
    """Two parts of 2 sequences, float32 sums divided by 2, against one
    batch of 4 (float32 compute: only summation order differs), both
    tracking the reference's microbatched step."""
    one = _run_both("float32", microbatch=1, b=4)
    two = _run_both("float32", microbatch=2, b=4)
    for (t1, _, p1, _), (t2, j2, p2, _) in zip(one, two):
        assert abs(float(t1["loss"]) - float(t2["loss"])) <= 1e-5
        assert abs(float(t2["loss"]) - float(j2["loss"])) \
            <= 1e-4 * abs(float(j2["loss"]))
        for (path, a), (_, b) in zip(leaves(p1), leaves(p2)):
            assert float((a - b).abs().max()) <= 1e-4 * float(
                b.abs().max()), path
