"""The inputs of the other families' sharded-step pins
(``tests/data/torch_sharded_families.json``), from numpy seeds: the JAX
package writes the pins from them on 8 forced host devices
(``test_torch_pins.py --write-sharded-families``), the port is held to
them on 8 gloo ranks (``test_torch_sharded_families.py``, and on the card
``chip_smoke.py``'s phase 16 (a)).  numpy only: both packages import it.

Each case is a reduced config of the enc-dec (whisper), SSM (mamba2) or
hybrid (recurrentgemma) family in float32 run as the reference runs it on
a mesh: every parameter placed under ``param_specs``, the tokens (and
whisper's frames) under ``P(dp, ...)`` (replicated where dp does not
divide the batch), a prefill over ``[batch, 16]`` tokens, the caches
carried as numpy, the self-attention ``k``/``v`` leaves grown to
``slots`` slots, placed under ``cache_specs`` (``drop_dp_axes`` where dp
does not divide the batch), then 4 decode steps.  The cases reach every
layout branch the steps take:

* whisper's self and cross caches in ``kv_spec``'s "slots" (2 KV heads
  over ``model`` 4, 20 slots and 16 frames), "replicated" (18 slots, 18
  frames) and "heads" (2x2x2) branches;
* mamba2's conv state and SSM state split over ``model`` (conv_dim 160,
  ssm_state 16), the state replicated (ssm_state 14 on 2x4, 15 on
  2x2x2), and heads that ``model`` cuts through (head dim 64: 2 heads
  over 4 ranks);
* recurrentgemma's RG-LRU width split over ``model`` and its one-KV-head
  attention caches in "slots" (prefill and decode) and "replicated"
  (the decode's 18 slots; the prefill's 16 are split), with 4 and 10 q
  heads (10 over 4 ranks: the uneven q-head span);
* a batch of 1 in each family, which the data axes do not divide.

Every matrix is drawn N(0, 1 / fan_in), the conv filters N(0, 1 / width),
the embedding N(0, 1 / d_model), whisper's frames N(0, 1).
"""
from __future__ import annotations

import numpy as np

from torch_mesh_cases import MESHES, WORLD, decode, encode  # noqa: F401

REPLACE = {"compute_dtype": "float32"}
PROMPT, STEPS = 16, 4
VIT_STUB_DIM = 1024

# name -> (arch, config replacements, mesh, batch, slots)
CASES = {
    "whisper/2x4/slots": ("whisper-medium", {}, "2x4", 4, 20),
    "whisper/2x4/replicated": ("whisper-medium", {"enc_seq": 18}, "2x4", 4,
                               18),
    "whisper/2x2x2/heads": ("whisper-medium", {}, "2x2x2", 4, 20),
    "whisper/2x4/batch1": ("whisper-medium", {}, "2x4", 1, 20),
    "mamba2/2x4/split": ("mamba2-130m", {}, "2x4", 4, 20),
    "mamba2/2x4/state-replicated": ("mamba2-130m", {"ssm_state": 14}, "2x4",
                                    4, 20),
    "mamba2/2x2x2/odd-state": ("mamba2-130m", {"ssm_state": 15}, "2x2x2", 4,
                               20),
    "mamba2/2x4/cut-heads": ("mamba2-130m", {"ssm_headdim": 64}, "2x4", 4,
                             20),
    "mamba2/2x4/batch1": ("mamba2-130m", {}, "2x4", 1, 20),
    "recurrentgemma/2x4/slots": ("recurrentgemma-2b", {}, "2x4", 4, 20),
    "recurrentgemma/2x4/replicated": ("recurrentgemma-2b", {}, "2x4", 4,
                                      18),
    "recurrentgemma/2x2x2/slots": ("recurrentgemma-2b", {}, "2x2x2", 4, 20),
    "recurrentgemma/2x4/10-heads": ("recurrentgemma-2b", {"num_heads": 10},
                                    "2x4", 4, 20),
    "recurrentgemma/2x4/batch1": ("recurrentgemma-2b", {}, "2x4", 1, 20),
}


def steps() -> tuple[str, ...]:
    return ("prefill", *(f"decode{i}" for i in range(STEPS)))


def replace(name: str) -> dict:
    return {**REPLACE, **CASES[name][1]}


def inputs(name: str, shapes: dict, vocab: int, d_model: int,
           enc_seq: int) -> dict:
    """``{"params", "tokens"[, "frames"]}`` of case ``name``: the tree of
    ``shapes`` (nested dicts of shape tuples, leaves drawn in sorted-path
    order), tokens ``[batch, PROMPT + STEPS]`` and an enc-dec's frames
    ``[batch, enc_seq, 1024]``, from seed ``40 + the case's index``."""
    batch = CASES[name][3]
    rng = np.random.default_rng(40 + list(CASES).index(name))

    def tree(node, path=()):
        out = {}
        for key in sorted(node):
            val = node[key]
            if isinstance(val, dict):
                out[key] = tree(val, path + (key,))
            elif len(val) == 1:
                out[key] = np.ones(val, np.float32)
            else:
                fan = (d_model if path == () and key == "embed" else
                       val[-1] if key == "conv_w" else val[-2])
                out[key] = (rng.standard_normal(val)
                            / np.sqrt(fan)).astype(np.float32)
        return out

    out = {"params": tree(shapes),
           "tokens": rng.integers(0, vocab, (batch, PROMPT + STEPS)
                                  ).astype(np.int32)}
    if enc_seq:
        out["frames"] = rng.standard_normal(
            (batch, enc_seq, VIT_STUB_DIM)).astype(np.float32)
    return out


def cache_paths(caches: dict, prefix: str = "cache") -> dict:
    """A cache tree as ``{"cache/<key>/.../<leaf>": array}``."""
    out = {}
    for key in sorted(caches):
        val = caches[key]
        if isinstance(val, dict):
            out |= cache_paths(val, f"{prefix}/{key}")
        else:
            out[f"{prefix}/{key}"] = val
    return out


def port_config(name: str):
    from repro_torch.configs import get_config
    return get_config(CASES[name][0]).reduced().replace(**replace(name))


def _meta(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _log(mesh) -> dict:
    """A mesh's collective log as ``{"<kind> <axes>": [calls, bytes]}``."""
    return {f"{kind} {','.join(axes)}": [rec["calls"], rec["bytes"]]
            for (kind, axes), rec in sorted(mesh.collective_log.items())}


def run_case(name: str, mctx, device: str, counting=None) -> dict:
    """Case ``name`` on this rank of ``mctx`` (a mesh over the 8 ranks):
    ``{"<step>": global logits, "cache/...": global caches after the
    last step, "log/<step>": the rank's collective log of the step,
    "count/<step>": a ``CountingMesh``'s log of the same step on meta
    copies of its inputs (when ``counting`` is given: a mesh of the same
    shape at this rank's coordinates)}``."""
    import torch
    from repro_torch.launch.serve import pad_kv
    from repro_torch.models import get_model
    from repro_torch.models.convert import blocks, gathered, params_from_numpy
    from repro_torch.models.model import drop_dp_axes
    from repro_torch.models.sharding import MeshCtx, P
    cfg = port_config(name)
    batch, slots = CASES[name][3:]
    model = get_model(cfg)
    enc_seq = cfg.enc_seq if cfg.family == "encdec" else 0
    inp = inputs(name, model.param_shapes(cfg), cfg.vocab_size, cfg.d_model,
                 enc_seq)
    mesh = mctx.mesh
    dp = mctx.dp if batch % mctx.dp_size == 0 else None
    params = params_from_numpy(blocks(inp["params"], model.param_specs(
        cfg, mctx), mctx), device)
    toks = torch.from_numpy(blocks(inp["tokens"], P(dp, None), mctx)).to(
        device)
    feed = {"tokens": toks[:, :PROMPT]}
    if enc_seq:
        feed["frames"] = torch.from_numpy(blocks(
            inp["frames"], P(dp, None, None), mctx)).to(device)
    out = {}

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

    with torch.no_grad():
        caches = step("prefill", model.prefill, params, feed)
        whole = pad_kv(gathered(caches, cache_specs(PROMPT), mctx),
                       slots - PROMPT)
        caches = blocks(whole, cache_specs(slots), mctx)
        for i in range(STEPS):
            t = PROMPT + i
            tok = toks[:, t:t + 1]
            caches = step(f"decode{i}", model.decode, params, caches, tok, t,
                          n_slots=slots)
    final = gathered(caches, cache_specs(slots), mctx)
    out |= {k: v.cpu().numpy() for k, v in cache_paths(final).items()}
    return out


def rank_cases(rank: int, device: str) -> dict:
    """Every case through the port on this rank of an 8-rank process
    group (``repro_torch.launch.mesh.run_ranks``): ``{case: run_case's
    record}``, each with its counting mesh's logs, plus ``"_coords"``."""
    import torch
    from repro_torch.launch.mesh import rank_mesh_ctx
    from repro_torch.models.sharding import CountingMesh
    torch.set_num_threads(1)
    meshes = {m: rank_mesh_ctx(shape, names, device)
              for m, (shape, names) in MESHES.items()}
    out = {"_coords": {m: mctx.mesh.coords for m, mctx in meshes.items()}}
    for name, (_, _, m, _, _) in CASES.items():
        shape, names = MESHES[m]
        counting = CountingMesh(shape, names, meshes[m].mesh.coords)
        out[name] = run_case(name, meshes[m], device, counting)
    return out
