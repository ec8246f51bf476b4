"""The inputs of the mesh pins (``tests/data/torch_mesh.json``), from
numpy seeds: the JAX package writes the pins from them on 8 forced host
devices (``test_torch_pins.py --write-mesh``), the port is held to them
on 8 gloo ranks (``test_torch_mesh.py``, and on the card
``chip_smoke.py``'s phase 13 (a)).  numpy only: both packages import it.

Two reduced MoE configurations at 8 experts (d_model 64, d_ff 128):
llama4-maverick (top-1, a shared expert, every second layer MoE) and
mixtral (top-2), each in the three sharded modes, on a 2x4
``("data", "model")`` mesh and a 2x2x2 ``("pod", "data", "model")`` one.
Every matrix is drawn N(0, 1 / fan_in) (the embedding N(0, 1), norm scales
ones), so activations and logits are of order 1 and the routing is not
near uniform.
"""
from __future__ import annotations

import base64

import numpy as np

ARCHS = ("llama4-maverick-400b-a17b", "mixtral-8x7b")
MODES = ("expert", "ffn", "2d")
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
REPLACE = {"num_experts": 8, "compute_dtype": "float32"}
WORLD = 8
X_BATCHES = (4, 1)          # dp divides 4; 1 runs replicated
SEQ = 8
PROMPT, STEPS, BATCH = 16, 2, 4     # the decoder: prefill, decode steps
DECODER_MESH = "2x4"


def _draw(rng, shape) -> np.ndarray:
    if len(shape) == 1:
        return np.ones(shape, np.float32)
    return (rng.standard_normal(shape)
            / np.sqrt(shape[-2])).astype(np.float32)


def moe_inputs(arch: str, d: int, f: int, e: int, shared: bool) -> dict:
    """``{"params", "x4", "x1"}``: one MoE block's weights and inputs
    ``[4, 8, d]`` and ``[1, 8, d]``, from seed ``ARCHS.index(arch)``."""
    rng = np.random.default_rng(ARCHS.index(arch))
    shapes = {"router": (d, e), "wg": (e, d, f), "wu": (e, d, f),
              "wo": (e, f, d)}
    if shared:
        shapes |= {"sh_wg": (d, f), "sh_wu": (d, f), "sh_wo": (f, d)}
    params = {k: _draw(rng, shapes[k]) for k in sorted(shapes)}
    xs = {f"x{b}": rng.standard_normal((b, SEQ, d)).astype(np.float32)
          for b in X_BATCHES}
    return {"params": params, **xs}


def decoder_inputs(arch: str, shapes: dict, vocab: int) -> dict:
    """``{"params", "tokens"}``: the decoder tree of ``shapes`` (nested
    dicts of shape tuples, leaves drawn in sorted-path order; the
    embedding N(0, 1)) and tokens ``[BATCH, PROMPT + STEPS]``, from seed
    ``10 + ARCHS.index(arch)``."""
    rng = np.random.default_rng(10 + ARCHS.index(arch))

    def tree(node, path=()):
        out = {}
        for key in sorted(node):
            val = node[key]
            if isinstance(val, dict):
                out[key] = tree(val, path + (key,))
            elif path == () and key == "embed":
                out[key] = rng.standard_normal(val).astype(np.float32)
            else:
                out[key] = _draw(rng, tuple(val))
        return out

    params = tree(shapes)
    tokens = rng.integers(0, vocab, (BATCH, PROMPT + STEPS)).astype(np.int32)
    return {"params": params, "tokens": tokens}


def case_keys() -> list[str]:
    """Every pinned case: ``moe/<mesh>/<arch>/<mode>/x<b>`` and
    ``decoder/<mesh>/<arch>/<mode>/<prefill|decode0|decode1>``."""
    keys = [f"moe/{m}/{a}/{mode}/x{b}" for m in MESHES for a in ARCHS
            for mode in MODES for b in X_BATCHES]
    keys += [f"decoder/{DECODER_MESH}/{a}/{mode}/{step}" for a in ARCHS
             for mode in MODES
             for step in ("prefill", *(f"decode{i}" for i in range(STEPS)))]
    return keys


def encode(arr) -> dict:
    """A float32 array as JSON: its shape and its little-endian bytes in
    base64 (exact on the way back)."""
    arr = np.ascontiguousarray(arr, "<f4")
    return {"shape": list(arr.shape),
            "f32": base64.b64encode(arr.tobytes()).decode()}


def decode(rec: dict) -> np.ndarray:
    return np.frombuffer(base64.b64decode(rec["f32"]), "<f4").reshape(
        rec["shape"]).copy()


def port_config(arch: str, mode: str):
    from repro_torch.configs import get_config
    return get_config(arch).reduced().replace(**REPLACE, moe_shard=mode)


def rank_cases(rank: int, device: str) -> dict:
    """Every pinned case through the port on this rank of an 8-rank
    process group (``repro_torch.launch.mesh.run_ranks``), with its
    inputs and outputs on ``device``: ``{key: float32 array}``, plus
    ``"_collectives"``, the calls each mesh issued.  ``moe_ffn`` takes
    this rank's block of x (``P(dp, None, None)``; all of it where dp does
    not divide the batch) and returns its block of the output, gathered
    here; the decoders take every parameter, cache and token as this
    rank's block (``convert.blocks``) and their logits are gathered."""
    import torch
    from repro_torch.launch.mesh import rank_mesh_ctx
    from repro_torch.launch.serve import pad_kv
    from repro_torch.models import get_model
    from repro_torch.models.convert import (blocks, gathered, moe_blocks,
                                            params_from_numpy)
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.sharding import P
    torch.set_num_threads(1)
    out: dict = {"_collectives": {}}
    for mname, (shape, names) in MESHES.items():
        mctx = rank_mesh_ctx(shape, names, device)
        for arch in ARCHS:
            for mode in MODES:
                cfg = port_config(arch, mode)
                inp = moe_inputs(arch, cfg.d_model, cfg.d_ff,
                                 cfg.num_experts, cfg.shared_expert)
                for b in X_BATCHES:
                    rows = P(mctx.dp if b % mctx.dp_size == 0 else None)
                    params = params_from_numpy(
                        moe_blocks(inp["params"], cfg, mctx, b), device)
                    x = torch.from_numpy(blocks(inp[f"x{b}"], rows, mctx))
                    y = moe_ffn(params, x.to(device), cfg, mctx,
                                global_batch=b)
                    out[f"moe/{mname}/{arch}/{mode}/x{b}"] = gathered(
                        y, rows, mctx).cpu().numpy()
                if mname != DECODER_MESH:
                    continue
                model = get_model(cfg)
                dec = decoder_inputs(arch, model.param_shapes(cfg),
                                     cfg.vocab_size)
                params = params_from_numpy(blocks(
                    dec["params"], model.param_specs(cfg, mctx), mctx),
                    device)
                toks = torch.from_numpy(blocks(
                    dec["tokens"], P(mctx.dp, None), mctx)).to(device)
                key = f"decoder/{mname}/{arch}/{mode}"
                layout = {"global_batch": BATCH}
                logits, caches = model.prefill(
                    params, {"tokens": toks[:, :PROMPT]}, cfg, mctx,
                    **layout)
                out[f"{key}/prefill"] = gathered(
                    logits, P(mctx.dp, "model"), mctx).cpu().numpy()
                caches = blocks(pad_kv(gathered(caches, model.cache_specs(
                    cfg, mctx, PROMPT), mctx), STEPS), model.cache_specs(
                    cfg, mctx, PROMPT + STEPS), mctx)
                for i in range(STEPS):
                    t = PROMPT + i
                    logits, caches = model.decode(
                        params, caches, toks[:, t:t + 1], t, cfg, mctx,
                        n_slots=PROMPT + STEPS, **layout)
                    out[f"{key}/decode{i}"] = gathered(
                        logits, P(mctx.dp, "model"), mctx).cpu().numpy()
        out["_collectives"][mname] = dict(mctx.mesh.collectives)
    out["_checks"] = rank_checks(device)
    return out


def rank_checks(device: str) -> dict:
    """What a rank sees of its meshes, for the tests to assert: its
    coordinates and indices, gathers and sums over axes in every order,
    the block a spec gives it, that global MoE weights are refused, and
    that drawing only this rank's blocks (``init_decoder_params(...,
    blocks=)``) gives the blocks of the global draw, bit for bit."""
    import torch
    from repro_torch.launch.mesh import rank_mesh_ctx
    from repro_torch.models import get_model
    from repro_torch.models.convert import moe_blocks, moe_shardings
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.sharding import P
    out: dict = {}
    mctx = rank_mesh_ctx((2, 2, 2), device=device)
    mesh = mctx.mesh
    rank = torch.tensor([[float(mesh.device_mesh.get_rank())]],
                        device=device)
    out["coords"] = mesh.coords
    out["index_dp"] = mesh.axis_index(mctx.dp)
    out["index_model_pod"] = mesh.axis_index(("model", "pod"))
    for axes in (("pod", "data"), ("data", "pod"), ("model",),
                 ("pod", "data", "model")):
        out[f"gather {axes}"] = mesh.all_gather(rank, axes).reshape(
            -1).tolist()
        out[f"psum {axes}"] = float(mesh.psum(rank, axes))
    glob = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    out["block"] = mctx.sharding(P(mctx.dp, "model")).block(glob).tolist()
    cfg = port_config(ARCHS[0], "expert")
    inp = moe_inputs(ARCHS[0], cfg.d_model, cfg.d_ff, cfg.num_experts,
                     cfg.shared_expert)
    try:
        moe_ffn({k: torch.from_numpy(v).to(device)
                 for k, v in inp["params"].items()},
                mctx.sharding(P(mctx.dp)).block(torch.from_numpy(
                    inp["x4"])).to(device), cfg, mctx, global_batch=4)
        out["global_weights"] = "taken"
    except ValueError as e:
        out["global_weights"] = str(e)
    for arch in ARCHS:
        for mode in MODES:
            cfg = port_config(arch, mode)
            model = get_model(cfg)
            shapes = model.param_shapes(cfg)
            draw = lambda **kw: model.init(
                cfg, torch.Generator(device).manual_seed(5), device, **kw)
            full = draw()
            blocks = moe_shardings(shapes, cfg, mctx, BATCH)
            own = draw(blocks=blocks)
            cut = moe_blocks(full, cfg, mctx, BATCH)
            out[f"init {arch} {mode}"] = {
                "leaves": len(blocks),
                "cut": sum(_leaf(own, p).numel() < _leaf(full, p).numel()
                           for p in blocks),
                "blocks_equal": all(torch.equal(_leaf(cut, p), _leaf(own, p))
                                    for p in blocks),
                "rest_equal": all(
                    torch.equal(_leaf(full, p), _leaf(own, p))
                    for p in _paths(full) if p not in blocks)}
    return out


def _paths(tree: dict, prefix: tuple = ()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _paths(val, prefix + (key,))
        else:
            yield prefix + (key,)


def _leaf(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def raise_on_rank(rank: int, bad: int) -> int:
    """A rank function for the launcher's test: rank ``bad`` raises."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank


def rank_process(rank: int) -> tuple:
    """A rank function for the launcher's test: the rank, its process id,
    the process group's size and a collective's answer (the ranks'
    sum)."""
    import os

    import torch
    import torch.distributed as dist
    x = torch.tensor([float(rank)])
    dist.all_reduce(x)
    return rank, os.getpid(), dist.get_world_size(), float(x)
