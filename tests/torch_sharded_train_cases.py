"""The inputs of the sharded-training pins
(``tests/data/torch_sharded_train.json``), from numpy seeds: the JAX
package writes the pins from them on 8 forced host devices with its
jitted ``make_train_step`` (``test_torch_pins.py --write-sharded-train``),
the port is held to them on 8 gloo ranks (``test_torch_sharded_train.py``,
and on the card ``chip_smoke.py``'s phase 15 (a)).  numpy only: both
packages import it.

Each case is a reduced decoder (d_model 64, 4 q heads and 2 KV heads of
16, vocab 256, cut to 2 layers; the MoE configs at 8 experts), float32
parameters, compute and moments, ``remat="full"``, trained by AdamW (the
default ``AdamWConfig``) for ``STEPS`` steps on one batch of ``[batch,
SEQ]`` tokens (and a VLM's image embeddings), every parameter and moment
placed under ``param_specs`` / ``opt_state_specs`` and the batch under
``P(dp, None)`` (replicated where dp does not divide it).  The cases: the
dense llama on 2x4 (2 KV heads on 4 model ranks: every rank computes both
and keeps one), on 2x2x2 (the pod axis; heads split), with a batch of 1
(dp does not divide it), with 2 microbatches, with 6 q heads on 2x4 and
with 6 q heads on 3 KV heads on 2x2x2; h2o-danube with its
window cut to 8 so that it binds; mixtral in each ``moe_shard`` mode;
llama4 ("expert", every second layer MoE, a shared expert, its chunk cut
to 8); internvl2 (8 image tokens).  Every matrix is drawn N(0, 1 /
fan_in) and the embedding N(0, 1 / d_model).

The pins of a case: each step's loss and gradient norm, and for the
first step's gradients and the last step's parameters each leaf's sum of
squares and its values at ``SAMPLES`` positions fixed by the case and
the leaf (``sample_positions``): whole trees of every case would not fit
the file's ~2 MB.
"""
from __future__ import annotations

import sys
import zlib

import numpy as np

from torch_mesh_cases import MESHES, WORLD, decode, encode  # noqa: F401

PIN_FILE = "torch_sharded_train.json"       # under tests/data
STEPS, SEQ = 2, 16
SAMPLES = 256
VIT_STUB_DIM = 1024
REPLACE = {"num_layers": 2, "compute_dtype": "float32",
           "param_dtype": "float32", "opt_dtype": "float32", "remat": "full"}

# name -> (arch, moe_shard or None, mesh, batch, microbatch)
CASES = {
    "llama/2x4": ("llama3.2-3b", None, "2x4", 4, 1),
    "llama/2x2x2": ("llama3.2-3b", None, "2x2x2", 4, 1),
    "llama/2x4/batch1": ("llama3.2-3b", None, "2x4", 1, 1),
    "llama/2x4/micro2": ("llama3.2-3b", None, "2x4", 4, 2),
    "llama/2x4/heads6": ("llama3.2-3b", None, "2x4", 4, 1),
    "llama/2x2x2/groups3": ("llama3.2-3b", None, "2x2x2", 4, 1),
    "h2o/2x4": ("h2o-danube-1.8b", None, "2x4", 4, 1),
    "mixtral-expert/2x4": ("mixtral-8x7b", "expert", "2x4", 4, 1),
    "mixtral-ffn/2x4": ("mixtral-8x7b", "ffn", "2x4", 4, 1),
    "mixtral-2d/2x4": ("mixtral-8x7b", "2d", "2x4", 4, 1),
    "llama4-expert/2x4": ("llama4-maverick-400b-a17b", "expert", "2x4", 4,
                          1),
    "internvl2/2x4": ("internvl2-26b", None, "2x4", 4, 1),
}
# per case, beyond REPLACE: the MoE modes at 8 experts, the window and the
# chunk cut so that they bind at SEQ; 6 q heads that 4 model ranks do not
# divide (a rank's heads by wo's rows, two ranks sharing a head), and 6 q
# heads on 3 KV heads over 2 model ranks (each rank computes the 3 KV
# heads and picks [0, 0, 1] or [1, 2, 2] for its q heads: index_select)
EXTRA = {"h2o/2x4": {"window": 8}, "llama4-expert/2x4": {"chunk_attn": 8},
         "llama/2x4/heads6": {"num_heads": 6},
         "llama/2x2x2/groups3": {"num_heads": 6, "num_kv_heads": 3}}


# the bounds of a rank's answers against the pins (float32 on both sides;
# the port lands within ~1e-7 of them on the CPU): each step's loss and
# gradient norm (relative), the first gradient's sampled elements and the
# leaves' sums of squares over the distinct blocks, the parameters after
# the last step.  Where the pinned first gradient is itself within
# GRAD_ATOL of 0 (rounding noise: llama4's top-1 router, whose
# renormalised gate is 1, has a gradient of 0 in exact arithmetic), Adam's
# first steps, nearly lr * sign(g), may move the element up to 2 * lr a
# step either way: ADAM_SIGN_TOL in all, for those elements only, counted.
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-6, 1e-4
SUMSQ_RTOL = 1e-4
PARAM_ATOL = 1e-6
LR = 3e-4                          # AdamWConfig's default
ADAM_SIGN_TOL = 2 * LR * STEPS + PARAM_ATOL


def replace(name: str) -> dict:
    """The config replacements of case ``name`` (its reduced config's)."""
    mode = CASES[name][1]
    out = dict(REPLACE, **EXTRA.get(name, {}))
    if mode is not None:
        out |= {"num_experts": 8, "moe_shard": mode}
    return out


def inputs(name: str, shapes: dict, vocab: int, d_model: int,
           img_tokens: int) -> dict:
    """``{"params", "tokens"[, "img_emb"]}`` of case ``name``: the decoder
    tree of ``shapes`` (nested dicts of shape tuples, leaves drawn in
    sorted-path order), tokens ``[batch, SEQ]`` and a VLM's image
    embeddings ``[batch, img_tokens, 1024]``, from a seed of the case's
    name (a case's inputs do not move when cases are added)."""
    batch = CASES[name][3]
    rng = np.random.default_rng(zlib.crc32(name.encode()))

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
           "tokens": rng.integers(0, vocab, (batch, SEQ)).astype(np.int32)}
    if img_tokens:
        out["img_emb"] = rng.standard_normal(
            (batch, img_tokens, VIT_STUB_DIM)).astype(np.float32)
    return out


def case_inputs(name: str, shapes: dict, cfg) -> dict:
    """``inputs`` of case ``name`` for its config ``cfg`` (either
    package's): ``{"params", and the batch's arrays by key}``."""
    return inputs(name, shapes, cfg.vocab_size, cfg.d_model,
                  cfg.img_tokens if cfg.family == "vlm" else 0)


def paths(tree, prefix: tuple = ()) -> list[tuple[str, ...]]:
    """The leaves' key paths in sorted-key order."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out += paths(val, prefix + (key,))
        else:
            out.append(prefix + (key,))
    return out


def leaf(tree, path: tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def sample_positions(name: str, path: tuple[str, ...], size: int
                     ) -> np.ndarray:
    """The sorted flat positions of a leaf of ``size`` elements that the
    pins keep: ``SAMPLES`` of them (all for a smaller leaf), fixed by the
    case and the leaf's path."""
    rng = np.random.default_rng(zlib.crc32(f"{name}/{'/'.join(path)}"
                                           .encode()))
    return np.sort(rng.choice(size, min(SAMPLES, size), replace=False))


def summarise(name: str, tree) -> dict:
    """``{"<path>": the values at the sample positions, "sumsq": each
    leaf's sum of squares in path order}`` of a global tree (numpy)."""
    out = {}
    sumsq = []
    for path in paths(tree):
        arr = np.asarray(leaf(tree, path), np.float32)
        out["/".join(path)] = arr.reshape(-1)[sample_positions(
            name, path, arr.size)]
        sumsq.append(np.sum(np.square(arr.astype(np.float64))))
    out["sumsq"] = np.asarray(sumsq, np.float32)
    return out


def pin_keys(name: str, leaf_paths: list[tuple[str, ...]]) -> list[str]:
    """Every pinned array of case ``name``: ``<case>/loss``,
    ``<case>/grad_norm`` (one value a step), ``<case>/grad/<path>`` and
    ``<case>/param/<path>`` (the samples), ``<case>/grad/sumsq`` and
    ``<case>/param/sumsq``."""
    keys = [f"{name}/loss", f"{name}/grad_norm"]
    for tree in ("grad", "param"):
        keys += [f"{name}/{tree}/{'/'.join(p)}" for p in leaf_paths]
        keys.append(f"{name}/{tree}/sumsq")
    return keys


def port_config(name: str):
    from repro_torch.configs import get_config
    return get_config(CASES[name][0]).reduced().replace(**replace(name))


def _log(mesh) -> dict:
    """A mesh's collective log as ``{"<kind> <axes>": [calls, bytes]}``."""
    return {f"{kind} {','.join(axes)}": [rec["calls"], rec["bytes"]]
            for (kind, axes), rec in sorted(mesh.collective_log.items())}


def _meta(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def block_summary(name: str, tree, specs, shapes: dict, mctx) -> dict:
    """This rank's view of a tree of its blocks (global shapes
    ``shapes``): per leaf path, the block's place in the global leaf
    (``[start, stop]`` a dim), its sum of squares and its values at the
    leaf's sample positions that fall in it (NaN at the others)."""
    import torch
    out = {}
    for path in paths(tree):
        block = leaf(tree, path).detach().float().cpu()
        shape = leaf(shapes, path)
        index = mctx.sharding(leaf(specs, path)).index(shape)
        pos = sample_positions(name, path, int(np.prod(shape)))
        coords = np.unravel_index(pos, shape)
        inside = np.ones(len(pos), bool)
        local = []
        for c, sl in zip(coords, index):
            inside &= (c >= sl.start) & (c < sl.stop)
            local.append(c - sl.start)
        vals = np.full(len(pos), np.nan, np.float32)
        if inside.any():
            vals[inside] = block.numpy()[tuple(lc[inside] for lc in local)]
        out["/".join(path)] = {
            "index": [[sl.start, sl.stop] for sl in index],
            "sumsq": float(torch.sum(torch.square(block.double()))),
            "samples": vals}
    return out


def run_case(name: str, mctx, device: str, counting=None,
             cases=None) -> dict:
    """Case ``name`` of the cases module ``cases`` (this one by default:
    any module with ``CASES``, ``port_config`` and ``case_inputs``) on
    this rank of ``mctx`` (a mesh over the 8 ranks):
    ``{"loss": [...], "grad_norm": [...], "grad": block_summary of the
    first step's gradients, "param": of the last step's parameters,
    "log/<step>": the rank's collective log of each train step,
    "count": a ``CountingMesh``'s log of the first step on meta copies of
    its inputs (when ``counting`` is given: a mesh of the same shape at
    this rank's coordinates), "launches": the flash forward and backward
    launches of one step}``."""
    import torch
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.models import get_model
    from repro_torch.models.convert import blocks, params_from_numpy
    from repro_torch.models.sharding import MeshCtx, P
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import (make_loss_fn,
                                              make_train_step,
                                              value_and_grad)
    cases = cases or sys.modules[__name__]
    cfg = cases.port_config(name)
    _, _, _, batch, micro = cases.CASES[name]
    model = get_model(cfg)
    shapes = model.param_shapes(cfg)
    inp = cases.case_inputs(name, shapes, cfg)
    mesh = mctx.mesh
    dp = mctx.dp if batch % mctx.dp_size == 0 else None
    specs = model.param_specs(cfg, mctx)
    params = params_from_numpy(blocks(inp["params"], specs, mctx), device)
    feed = {k: torch.from_numpy(blocks(v, P(dp, *(None,) * (v.ndim - 1)),
                                       mctx)).to(device)
            for k, v in inp.items() if k != "params"}
    ocfg = AdamWConfig(opt_dtype=cfg.opt_dtype)
    opt = init_opt_state(params, ocfg)
    _, grads = value_and_grad(make_loss_fn(cfg, mctx), params, feed, micro,
                              mctx=mctx, specs=specs, global_batch=batch)
    out = {"grad": block_summary(name, grads, specs, shapes, mctx),
           "loss": [],
           "grad_norm": []}
    del grads
    step = make_train_step(cfg, ocfg, micro, mctx)
    for i in range(STEPS):
        mesh.reset_collectives()
        before = (flash_ops.launches, flash_ops.bwd_launches)
        params, opt, metrics = step(params, opt, feed, global_batch=batch)
        out[f"log/{i}"] = _log(mesh)
        out["launches"] = {
            "flash_attention": flash_ops.launches - before[0],
            "flash_attention_bwd": flash_ops.bwd_launches - before[1]}
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
        if counting is not None and i == 0:
            counted = make_train_step(cfg, ocfg, micro, MeshCtx(counting))
            counted(_meta(params), _meta(opt), _meta(feed),
                    global_batch=batch)
            out["count"] = _log(counting)
            counting.reset_collectives()
    out["param"] = block_summary(name, params, specs, shapes, mctx)
    return out


def rank_cases(rank: int, device: str, names=None, cases=None) -> dict:
    """Every case of the cases module ``cases`` (this one by default; or
    those of ``names``) through the port on this rank of an 8-rank
    process group (``repro_torch.launch.mesh.run_ranks``): ``{case:
    run_case's record}``, each with its counting mesh's logs, plus
    ``"_coords"`` and, for this module's cases, ``"_collective_grads"``
    (``collective_grads``)."""
    import torch
    from repro_torch.launch.mesh import rank_mesh_ctx
    from repro_torch.models.sharding import CountingMesh
    torch.set_num_threads(1)
    meshes = {m: rank_mesh_ctx(shape, axes, device)
              for m, (shape, axes) in MESHES.items()}
    out = {"_coords": {m: mctx.mesh.coords for m, mctx in meshes.items()}}
    if cases is None:
        out["_collective_grads"] = collective_grads(meshes["2x2x2"], device)
    all_cases = (cases or sys.modules[__name__]).CASES
    for name in names or all_cases:
        m = all_cases[name][2]
        shape, axes = MESHES[m]
        counting = CountingMesh(shape, axes, meshes[m].mesh.coords)
        out[name] = run_case(name, meshes[m], device, counting, cases)
    return out


def collective_grads(mctx, device: str) -> dict:
    """Each collective alone under autograd on this rank, its gradient
    against its transpose written out: x is the rank's row of a global
    ``[8, 6]`` array ``X`` (row r = r * 10 + its six indices), the
    cotangent of every output this rank's own ``c`` (rank + 1 times
    ones).  Returns per collective the output and x's gradient."""
    import torch
    mesh = mctx.mesh
    rank = mesh.device_mesh.get_rank()
    x = (rank * 10.0 + torch.arange(6.0, device=device))[None]
    out = {}
    for label, fn in (
            ("psum pod,data", lambda t: mesh.psum(t, ("pod", "data"))),
            ("pvary model", lambda t: mesh.pvary(t, "model")),
            ("all_gather pod,data dim0",
             lambda t: mesh.all_gather(t, ("pod", "data"), dim=0)),
            ("all_gather model dim1",
             lambda t: mesh.all_gather(t, "model", dim=1)),
            ("reduce_scatter pod,data,model dim1",
             lambda t: mesh.reduce_scatter(
                 t.repeat(1, 4), ("pod", "data", "model"), dim=1)),
            ("reduce_scatter model dim1 bf16",
             lambda t: mesh.reduce_scatter(t.bfloat16(), "model", dim=1))):
        leaf_x = x.clone().requires_grad_(True)
        y = fn(leaf_x)
        c = torch.full_like(y, rank + 1.0)
        (g,) = torch.autograd.grad(y, leaf_x, c)
        out[label] = {"y": y.detach().float().cpu().numpy(),
                      "grad": g.float().cpu().numpy()}
    return out


def _check_tree(name: str, tree: str, records: list, pins: dict,
                leaf_paths: list, atol: float, rtol: float = 0.0) -> dict:
    """Every rank's sampled elements of its blocks (``records``: each
    rank's ``run_case`` record) against the pins (the parameters' wider
    bound where the pinned gradient is noise), and each leaf's sum of
    squares over the distinct blocks; raises AssertionError past a bound,
    returns the worst error and how many samples took the wider bound."""
    def pin(key):
        return decode(pins[f"{name}/{key}"])
    sumsq_pin = pin(f"{tree}/sumsq")
    worst, n_wide, n_samples = 0.0, 0, 0
    for i, path in enumerate(leaf_paths):
        key = "/".join(path)
        want = pin(f"{tree}/{key}")
        bound = atol + rtol * np.abs(want)
        if tree == "param":
            noise = np.abs(pin(f"grad/{key}")) <= GRAD_ATOL
            bound = np.where(noise, ADAM_SIGN_TOL, bound)
        seen = np.zeros(len(want), bool)
        wide = np.zeros(len(want), bool)
        blocks = {}
        for rank, rec in enumerate(r[tree][key] for r in records):
            mine = ~np.isnan(rec["samples"])
            seen |= mine
            err = np.abs(rec["samples"][mine] - want[mine])
            if not (err <= bound[mine]).all():
                raise AssertionError(f"{name} {tree} {key} rank {rank}: "
                                     f"{float(err.max())}")
            wide[np.flatnonzero(mine)[err > atol]] = True
            worst = max(worst, float(err.max(initial=0.0)))
            blocks[tuple(map(tuple, rec["index"]))] = rec["sumsq"]
        if not seen.all():
            raise AssertionError(f"{name} {tree} {key}: samples no rank "
                                 f"holds")
        n_samples += len(want)
        n_wide += int(wide.sum())
        total = sum(blocks.values())
        if abs(total - sumsq_pin[i]) > SUMSQ_RTOL * sumsq_pin[i] + 1e-12:
            raise AssertionError(f"{name} {tree} {key}: sum of squares "
                                 f"{total}, pinned {sumsq_pin[i]}")
    return {"worst": worst, "wide": n_wide, "samples": n_samples}


def check_case(name: str, records: list, pins: dict,
               leaf_paths: list) -> dict:
    """Case ``name`` of every rank (``records``) held to the pins within
    the bounds above; raises AssertionError past one.  Returns the worst
    errors: ``loss_rel``, ``grad_abs``, ``param_abs`` and ``adam_sign``,
    the parameter samples that took ``ADAM_SIGN_TOL``, of ``samples``."""
    out = {"loss_rel": 0.0}
    for key in ("loss", "grad_norm"):
        want = decode(pins[f"{name}/{key}"])
        if want.shape != (STEPS,):
            raise AssertionError(f"{name} {key}: pinned {want.shape}")
        for r in records:
            rel = np.abs(np.asarray(r[key]) - want) / np.abs(want)
            if not (rel <= LOSS_RTOL).all():
                raise AssertionError(f"{name} {key}: {r[key]} against "
                                     f"{want}")
            out["loss_rel"] = max(out["loss_rel"], float(rel.max()))
    grad = _check_tree(name, "grad", records, pins, leaf_paths, GRAD_ATOL,
                       GRAD_RTOL)
    param = _check_tree(name, "param", records, pins, leaf_paths,
                        PARAM_ATOL)
    return out | {"grad_abs": grad["worst"], "param_abs": param["worst"],
                  "adam_sign": param["wide"], "samples": param["samples"]}
