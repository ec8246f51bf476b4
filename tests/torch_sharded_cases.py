"""The inputs of the sharded-step pins (``tests/data/torch_sharded.json``),
from numpy seeds: the JAX package writes the pins from them on 8 forced
host devices (``test_torch_pins.py --write-sharded``), the port is held
to them on 8 gloo ranks (``test_torch_sharded.py``, and on the card
``chip_smoke.py``'s phase 14 (a)).  numpy only: both packages import it.

Each case is a reduced decoder (d_model 64, 4 q heads and 2 KV heads of
16, vocab 256, float32; the MoE configs at 8 experts) run as the
reference runs it on a
mesh: every parameter placed under ``param_specs``, the tokens under
``P(dp, None)`` (replicated where dp does not divide the batch), a
prefill over ``[batch, 16]`` tokens, the caches carried as numpy, grown
to ``slots`` slots and placed under ``cache_specs`` (``drop_dp_axes``
where dp does not divide the batch), then 4 decode steps.  The cases
reach all three branches of ``kv_spec``: on 2x4 the 2 KV heads do not
divide ``model`` = 4, so 20 slots are split over ``model`` and 18 are
replicated; on 2x2x2 the heads are split.  Every matrix is drawn
N(0, 1 / fan_in) and the embedding N(0, 1 / d_model), so activations and
logits are of order 1.
"""
from __future__ import annotations

import sys

import numpy as np

from torch_mesh_cases import MESHES, WORLD, decode, encode  # noqa: F401

REPLACE = {"compute_dtype": "float32"}
PROMPT, STEPS = 16, 4
VIT_STUB_DIM = 1024

# name -> (arch, moe_shard or None, mesh, batch, slots)
CASES = {
    "llama/2x4/slots": ("llama3.2-3b", None, "2x4", 4, 20),
    "llama/2x4/replicated": ("llama3.2-3b", None, "2x4", 4, 18),
    "llama/2x2x2/heads": ("llama3.2-3b", None, "2x2x2", 4, 20),
    "llama/2x4/batch1": ("llama3.2-3b", None, "2x4", 1, 20),
    "h2o/2x4/slots": ("h2o-danube-1.8b", None, "2x4", 4, 20),
    "h2o/2x2x2/heads": ("h2o-danube-1.8b", None, "2x2x2", 4, 20),
    "mixtral-ffn/2x4/slots": ("mixtral-8x7b", "ffn", "2x4", 4, 20),
    "mixtral-ffn/2x2x2/heads": ("mixtral-8x7b", "ffn", "2x2x2", 4, 20),
    "mixtral-2d/2x4/slots": ("mixtral-8x7b", "2d", "2x4", 4, 20),
    "llama4-expert/2x4/slots": ("llama4-maverick-400b-a17b", "expert",
                                "2x4", 4, 20),
    "internvl2/2x4/slots": ("internvl2-26b", None, "2x4", 4, 28),
}


def steps() -> tuple[str, ...]:
    return ("prefill", *(f"decode{i}" for i in range(STEPS)))


def replace(mode) -> dict:
    """A case's config replacements: a MoE mode at 8 experts (a dense
    config keeps its dense FFN)."""
    return REPLACE if mode is None else {**REPLACE, "num_experts": 8,
                                         "moe_shard": mode}


def inputs(name: str, shapes: dict, vocab: int, d_model: int,
           img_tokens: int) -> dict:
    """``{"params", "tokens"[, "img_emb"]}`` of case ``name``: the decoder
    tree of ``shapes`` (nested dicts of shape tuples, leaves drawn in
    sorted-path order), tokens ``[batch, PROMPT + STEPS]`` and a VLM's
    image embeddings ``[batch, img_tokens, 1024]``, from seed
    ``20 + the case's index``."""
    batch = CASES[name][3]
    rng = np.random.default_rng(20 + list(CASES).index(name))

    def tree(node, path=()):
        out = {}
        for key in sorted(node):
            val = node[key]
            if isinstance(val, dict):
                out[key] = tree(val, path + (key,))
            elif len(val) == 1:
                out[key] = np.ones(val, np.float32)
            elif path == () and key == "embed":
                out[key] = (rng.standard_normal(val)
                            / np.sqrt(d_model)).astype(np.float32)
            else:
                out[key] = (rng.standard_normal(val)
                            / np.sqrt(val[-2])).astype(np.float32)
        return out

    out = {"params": tree(shapes),
           "tokens": rng.integers(0, vocab, (batch, PROMPT + STEPS)
                                  ).astype(np.int32)}
    if img_tokens:
        out["img_emb"] = rng.standard_normal(
            (batch, img_tokens, VIT_STUB_DIM)).astype(np.float32)
    return out


def case_keys() -> list[str]:
    """Every pinned logits array: ``<case>/<step>`` (each case also pins
    ``<case>/cache/<group>/<k|v>``, its caches after the last step)."""
    return [f"{c}/{s}" for c in CASES for s in steps()]


def cache_paths(caches: dict) -> dict:
    """A cache tree as ``{"cache/<group>/<k|v>": array}``."""
    return {f"cache/{g}/{kv}": caches[g][kv] for g in sorted(caches)
            for kv in ("k", "v")}


def case_replace(name: str) -> dict:
    """Case ``name``'s config replacements (its reduced config's)."""
    return replace(CASES[name][1])


def port_config(name: str):
    from repro_torch.configs import get_config
    return get_config(CASES[name][0]).reduced().replace(
        **case_replace(name))


def _meta(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _log(mesh) -> dict:
    """A mesh's collective log as ``{"<kind> <axes>": [calls, bytes]}``."""
    return {f"{kind} {','.join(axes)}": [rec["calls"], rec["bytes"]]
            for (kind, axes), rec in sorted(mesh.collective_log.items())}


def run_case(name: str, mctx, device: str, counting=None,
             cases=None) -> dict:
    """Case ``name`` of the cases module ``cases`` (this one by default:
    any module with ``CASES`` of ``(arch, _, mesh, batch, slots)``,
    ``port_config`` and ``inputs``, whose tokens are the prompt and then
    ``STEPS`` decoded ones) on this rank of ``mctx`` (a mesh over the 8
    ranks):
    ``{"<step>": global logits, "cache/...": global caches after the
    last step, "log/<step>": the rank's collective log of the step,
    "count/<step>": a ``CountingMesh``'s log of the same step on meta
    copies of its inputs (when ``counting`` is given: a mesh of the same
    shape at this rank's coordinates), "param_bytes": the bytes of the
    rank's parameter blocks}``."""
    import torch
    from repro_torch.launch.serve import pad_kv
    from repro_torch.models import get_model
    from repro_torch.models.convert import blocks, gathered, params_from_numpy
    from repro_torch.models.model import drop_dp_axes
    from repro_torch.models.sharding import MeshCtx, P
    cases = cases or sys.modules[__name__]
    cfg = cases.port_config(name)
    batch, slots = cases.CASES[name][3:]
    model = get_model(cfg)
    inp = cases.inputs(name, model.param_shapes(cfg), cfg.vocab_size,
                       cfg.d_model,
                       cfg.img_tokens if cfg.family == "vlm" else 0)
    mesh = mctx.mesh
    dp = mctx.dp if batch % mctx.dp_size == 0 else None
    params = params_from_numpy(blocks(inp["params"], model.param_specs(
        cfg, mctx), mctx), device)
    toks = torch.from_numpy(blocks(inp["tokens"], P(dp, None), mctx)).to(
        device)
    prompt = toks.shape[1] - STEPS
    feed = {"tokens": toks[:, :prompt]}
    if "img_emb" in inp:
        feed["img_emb"] = torch.from_numpy(blocks(
            inp["img_emb"], P(dp, None, None), mctx)).to(device)
    out = {"param_bytes": sum(
        v.numel() * v.element_size() for v in _leaves(params))}

    def cache_specs(n: int) -> dict:
        specs = model.cache_specs(cfg, mctx, n)
        return specs if dp else drop_dp_axes(specs, mctx)

    def step(key: str, fn, *args, **kw):
        mesh.reset_collectives()
        logits, caches = fn(*args, cfg, mctx, global_batch=batch, **kw)
        out[f"log/{key}"] = _log(mesh)
        out[key] = gathered(logits, P(dp, "model"), mctx).cpu().numpy()
        if counting is not None:
            meta = [_meta(a) if isinstance(a, dict) else
                    (a.to("meta") if isinstance(a, torch.Tensor) else a)
                    for a in args]
            fn(*meta, cfg, MeshCtx(counting), global_batch=batch, **kw)
            out[f"count/{key}"] = _log(counting)
            counting.reset_collectives()
        return caches

    s0 = prompt + (cfg.img_tokens if cfg.family == "vlm" else 0)
    with torch.no_grad():
        caches = step("prefill", model.prefill, params, feed)
        whole = pad_kv(gathered(caches, cache_specs(s0), mctx), slots - s0)
        caches = blocks(whole, cache_specs(slots), mctx)
        for i in range(STEPS):
            t = s0 + i
            tok = toks[:, prompt + i:prompt + i + 1]
            caches = step(f"decode{i}", model.decode, params, caches, tok, t,
                          n_slots=slots)
    final = gathered(caches, cache_specs(slots), mctx)
    out |= {k: v.cpu().numpy() for k, v in cache_paths(final).items()}
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def rank_cases(rank: int, device: str, cases=None) -> dict:
    """Every case of the cases module ``cases`` (this one by default)
    through the port on this rank of an 8-rank process group
    (``repro_torch.launch.mesh.run_ranks``): ``{case: run_case's
    record}``, each with its counting mesh's logs, plus ``"_coords"``."""
    import torch
    from repro_torch.launch.mesh import rank_mesh_ctx
    from repro_torch.models.sharding import CountingMesh
    torch.set_num_threads(1)
    meshes = {m: rank_mesh_ctx(shape, names, device)
              for m, (shape, names) in MESHES.items()}
    out = {"_coords": {m: mctx.mesh.coords for m, mctx in meshes.items()}}
    for name, (_, _, m, _, _) in (cases or sys.modules[__name__]
                                  ).CASES.items():
        shape, names = MESHES[m]
        counting = CountingMesh(shape, names, meshes[m].mesh.coords)
        out[name] = run_case(name, meshes[m], device, counting, cases)
    return out
