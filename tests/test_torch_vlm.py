"""The port's VLM (internvl2-26b's image-token prefix) against the JAX
package.

The reduced internvl2 (four layers, GQA 4:2, 8 image tokens) through both
models on the same weights (the JAX initialisation carried over by
``params_from_numpy``), the same 24 text tokens and the same image
embeddings ``img_emb`` [B, 8, 1024]: the prefill's logits and caches
(8 + 24 slots) and 8 teacher-forced decode steps at equal positions
``t = 8 + 24 + i``, max|Δ|/max|ref| 1e-4 in float32 and 3e-2 in bfloat16
(``tests/torch_model_parity.py``).  Both packages' decode entry points
take ``t``, so parity is held there: the reference's ``launch/serve.py``
decodes a VLM at ``prompt_len + i``, inside the image-and-prompt prefix
(ROADMAP, Reference caveats), and the port's ``serve`` decodes where its
prefill stopped, which is checked here too.
"""
import dataclasses
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.models.transformer import (VIT_STUB_DIM,  # noqa: E402
                                            cast_params)
from torch_model_parity import (assert_close, jax_params,  # noqa: E402
                                run_both)

ARCH = "internvl2-26b"


def _configs(**kw):
    jcfg = jax_get_config(ARCH).reduced().replace(**kw)
    return jcfg, ArchConfig(**{f: getattr(jcfg, f)
                               for f in jcfg.__dataclass_fields__})


def _img(cfg, b: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.img_tokens, VIT_STUB_DIM)).astype(np.float32)


def test_reduced_config_and_tree_match_reference():
    jcfg, tcfg = _configs()
    assert tcfg == get_config(ARCH).reduced()
    assert (tcfg.family, tcfg.img_tokens, tcfg.q_per_kv) == ("vlm", 8, 2)
    assert get_config(ARCH).q_per_kv == 6
    np_params = jax_params(jcfg)
    assert np_params["img_proj"].shape == (VIT_STUB_DIM, tcfg.d_model)
    shapes = get_model(tcfg).param_shapes(tcfg)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, np_params)) \
        == jax.tree.structure(jax.tree.map(lambda _: 0, shapes,
                                           is_leaf=lambda x: isinstance(
                                               x, tuple)))
    for path, arr in jax.tree_util.tree_flatten_with_path(np_params)[0]:
        leaf = shapes
        for key in (p.key for p in path):
            leaf = leaf[key]
        assert tuple(leaf) == arr.shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_internvl2_prefill_and_decode_match_jax(dtype):
    jcfg, tcfg = _configs(compute_dtype=dtype)
    toks = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (2, 32)).astype(np.int32)
    results = run_both(jcfg, tcfg, jax_params(jcfg), toks, 24, 8,
                       extra={"img_emb": _img(tcfg, 2, 2)})
    caches = [got for label, got, _ in results
              if label.startswith("cache")]
    assert caches and all(c.shape[-2] == 8 + 24 for c in caches)
    assert [label for label, _, _ in results][-1] == "decode t=39"
    assert_close(results, dtype)


def test_decode_after_images_matches_prefill_over_one_more_token():
    """The port alone, in float32: a decode step at ``t = img_tokens + S``
    after a prefill of S text tokens equals the last logits of a prefill
    over S + 1 with the same images (the decode-vs-prefill check of the
    serve path, at the reduced config)."""
    cfg = get_config(ARCH).reduced().replace(compute_dtype="float32")
    model = get_model(cfg)
    params = cast_params(model.init(cfg, torch.Generator().manual_seed(0)),
                         cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 25),
                         generator=torch.Generator().manual_seed(1))
    img = torch.from_numpy(_img(cfg, 2, 3))
    _, caches = model.prefill(params, {"tokens": toks[:, :24],
                                       "img_emb": img}, cfg)
    got, _ = model.decode(params, serve_mod.pad_kv(caches, 1),
                          toks[:, 24:], cfg.img_tokens + 24, cfg)
    want, _ = model.prefill(params, {"tokens": toks, "img_emb": img}, cfg)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_serve_decodes_where_the_prefill_stopped(monkeypatch):
    """``serve`` draws the images from its seed and decodes a VLM from
    ``t = img_tokens + prompt_len``, one position a step."""
    seen = []
    real = serve_mod.get_model

    def recording(cfg):
        fns = real(cfg)

        def decode(params, caches, tokens, t, cfg):
            seen.append((t, caches["dense0"]["k"].shape[-2]))
            return fns.decode(params, caches, tokens, t, cfg)
        return dataclasses.replace(fns, decode=decode)
    monkeypatch.setattr(serve_mod, "get_model", recording)
    res = serve_mod.serve(ARCH, requests=2, prompt_len=16, decode=3,
                          device="cpu", verbose=False)
    assert res["generated"] == 4
    assert seen == [(8 + 16 + i, 8 + 16 + 3) for i in range(3)]
    cfg = get_config(ARCH).reduced()
    batch = serve_mod.make_batch(cfg, torch.zeros((2, 16), dtype=torch.long),
                                 0)
    assert batch["img_emb"].shape == (2, 8, VIT_STUB_DIM)
    assert batch["img_emb"].dtype == torch.float32
