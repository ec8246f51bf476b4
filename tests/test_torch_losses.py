"""Every family's training loss and its gradient, the port's
``ModelFns.loss`` against ``jax.value_and_grad`` of the reference's
``model.loss``, on the ten reduced configurations.

Both packages get the reference's initialisation (carried over as numpy)
and the same numpy batch: 2 sequences of 64 tokens (a VLM's 8 image
embeddings and 56 text tokens, an enc-dec's 16 frames), 64 a multiple of
the reduced ``attn_kv_chunk`` of 32 (the reference's clamped last chunk
reads keys under wrong positions otherwise).  The loss and every gradient
leaf must agree within ``REL_TOL`` (max|Δ| / max|ref|): 1e-4 where both
the compute dtype and the leaf are float32, 3e-2 where either is bf16 (a
bf16 gradient holds 8 bits; llama4's parameters are bf16).

In bf16 the two MoE configurations (mixtral, llama4) are compared on the
loss and on every leaf but the expert block's (``ln2``, the router, the
experts and the shared expert): the bf16 activations differ by rounding
between the frameworks and the top-k routing of random weights has near
ties, so a few tokens go to other experts on each side, and those leaves
differ by 0.1-0.24 of max|ref| (with or without the capacity bound)
while the loss agrees to ~1e-6; in float32 every leaf is compared.  The
one exception is llama4's router (top-1 routing): its renormalised gate is
identically 1, so the router's gradient is 0 but for rounding (~1e-15;
the reference's own jitted and eager gradients differ by 0.22 of it)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.tree_util import tree_flatten_with_path  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import cpu_mesh_ctx  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models.layers import \
    chunked_softmax_xent as jax_xent  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import chunked_softmax_xent  # noqa: E402
from torch_model_parity import jax_params  # noqa: E402

REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
ARCHS = ["llama3.2-3b", "internlm2-20b", "minitron-4b", "h2o-danube-1.8b",
         "mixtral-8x7b", "llama4-maverick-400b-a17b", "internvl2-26b",
         "whisper-medium", "mamba2-130m", "recurrentgemma-2b"]
MOE_BLOCK = ("ln2", "router", "wg", "wu", "wo", "sh_wg", "sh_wu", "sh_wo")


def _batch(cfg, b=2, s=64, seed=0) -> dict:
    r = np.random.default_rng(seed)
    out = {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["tokens"] = out["tokens"][:, :s - cfg.img_tokens]
        out["img_emb"] = r.standard_normal((b, cfg.img_tokens, 1024),
                                           dtype=np.float32)
    if cfg.family == "encdec":
        out["frames"] = r.standard_normal((b, cfg.enc_seq, 1024),
                                          dtype=np.float32)
    return out


def _leaf(tree: dict, keys: list):
    for k in keys:
        tree = tree[k]
    return tree


def test_every_arch_is_covered():
    from repro_torch.configs import list_archs
    assert sorted(ARCHS) == sorted(list_archs())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_reference(arch, dtype):
    jcfg = jax_get_config(arch).reduced().replace(compute_dtype=dtype)
    tcfg = get_config(arch).reduced().replace(compute_dtype=dtype)
    np_params = jax_params(jcfg)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jcfg.param_dtype), np_params)
    batch = _batch(jcfg)
    jmodel = jax_get_model(jcfg)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b, jcfg, cpu_mesh_ctx())))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})

    tp = params_from_numpy(np_params, "cpu")

    def leaves_of(t):
        if isinstance(t, dict):
            return {k: leaves_of(v) for k, v in t.items()}
        return t.to(getattr(torch, tcfg.param_dtype)).requires_grad_(True)
    tp = leaves_of(tp)
    tb = {k: torch.from_numpy(v).long() if k == "tokens"
          else torch.from_numpy(v) for k, v in batch.items()}
    loss = get_model(tcfg).loss(tp, tb, tcfg)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - float(jl)) <= REL_TOL[dtype] * abs(float(jl))
    loss.backward()

    skip_moe = dtype == "bfloat16" and tcfg.family == "moe"
    checked = 0
    for path, want in tree_flatten_with_path(jg)[0]:
        keys = [p.key for p in path]
        if skip_moe and keys[-1] in MOE_BLOCK or (
                keys[-1] == "router" and tcfg.top_k == 1):
            continue
        got = _leaf(tp, keys).grad
        assert got is not None and got.dtype == _leaf(tp, keys).dtype
        tol = REL_TOL["bfloat16" if got.dtype == torch.bfloat16 else dtype]
        want = np.asarray(want, np.float32)
        err = float(np.abs(got.float().numpy() - want).max()
                    / (np.abs(want).max() + 1e-30))
        assert err <= tol, (".".join(keys), err)
        checked += 1
    assert checked >= 5


@pytest.mark.parametrize("n,chunk", [(100, 32), (64, 64), (7, 32)])
def test_chunked_softmax_xent_matches_reference(n, chunk):
    """N not a multiple of the chunk (padded with zero weights), equal to
    it, and below it; the value and its gradients in h and the unembed,
    in float32 and with h in bf16 (the product in bf16, cast to float32)."""
    r = np.random.default_rng(n)
    h = r.standard_normal((n, 16)).astype(np.float32)
    u = (r.standard_normal((16, 50)) * 0.3).astype(np.float32)
    y = r.integers(0, 50, n).astype(np.int32)
    w = (r.random(n) > 0.2).astype(np.float32)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                         (torch.bfloat16, jnp.bfloat16, 3e-2)):
        jv, jgrads = jax.value_and_grad(
            lambda h, u: jax_xent(h.astype(jdt), u, jnp.asarray(y),
                                  jnp.asarray(w), chunk), argnums=(0, 1))(
            jnp.asarray(h), jnp.asarray(u))
        th = torch.from_numpy(h).requires_grad_(True)
        tu = torch.from_numpy(u).requires_grad_(True)
        tv = chunked_softmax_xent(th.to(dt), tu, torch.from_numpy(y).long(),
                                  torch.from_numpy(w), chunk)
        assert tv.dtype == torch.float32
        assert abs(float(tv) - float(jv)) <= tol * abs(float(jv))
        tv.backward()
        for got, want in ((th.grad, jgrads[0]), (tu.grad, jgrads[1])):
            want = np.asarray(want, np.float32)
            assert np.abs(got.numpy() - want).max() \
                <= tol * np.abs(want).max()
