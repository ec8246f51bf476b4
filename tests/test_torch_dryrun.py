"""The dry-run's inputs and counts against the reference.

* ``abstract_params`` / ``abstract_cache`` / ``abstract_batch`` give the
  reference's shapes and dtypes for every configuration and applicable
  shape, as ShapeDtypeStructs (nothing allocated);
* every cell's per-device argument and output bytes
  (``lower_cell(...).memory_analysis()``) equal the sums over the
  reference's trees on the 1x1, 16x16 and 2x16x16 meshes, pinned in
  ``tests/data/torch_specs.json`` (the 1x1 sums too: the reference's
  prefill outputs come from ``jax.eval_shape``, seconds a cell);
* the reduced llama3.2-3b's train, prefill and decode flops equal a count
  by hand; every reduced family's step runs on the meta device and
  returns the abstract outputs;
* ``elastic_restart_plan`` and ``derive_mesh`` equal the reference's;
  ``scan_or_unroll`` equals a plain loop.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402
import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import elastic as jax_elastic  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch.configs import (applicable_shapes, get_config,  # noqa
                                 get_shape, list_archs)
from repro_torch.kernels.decode_attn import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (attended_keys,  # noqa
                                                attention_mask)
from repro_torch.launch import dryrun, elastic  # noqa: E402
from repro_torch.launch.mesh import production_mesh_ctx  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.sharding import (ShapeDtypeStruct,  # noqa: E402
                                         cpu_mesh_ctx)
from repro_torch.models.transformer import scan_or_unroll  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PINS = json.loads((ROOT / "tests" / "data" / "torch_specs.json").read_text())
ARCHS = list_archs()


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in flat(tree[k], f"{prefix}[{k!r}]").items()}
    return {prefix: tree}


def described(tree) -> dict:
    """{path: (shape, dtype name)} of either package's abstract tree."""
    return {p: (tuple(s.shape), str(s.dtype).removeprefix("torch."))
            for p, s in flat(tree).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_inputs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    params = port_model.abstract_params(cfg)
    assert all(isinstance(s, ShapeDtypeStruct)
               for s in flat(params).values())
    assert described(params) == described(jax_model.abstract_params(jcfg))
    for sh in applicable_shapes(cfg):
        shape = get_shape(sh)
        for port_fn, jax_fn in (
                (port_model.abstract_cache, jax_model.abstract_cache),
                (port_model.abstract_batch, jax_model.abstract_batch)):
            got = port_fn(cfg, shape)
            assert all(isinstance(s, ShapeDtypeStruct)
                       for s in flat(got).values())
            assert described(got) == described(jax_fn(jcfg, shape)), sh


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "whisper-medium",
                                  "mamba2-130m", "recurrentgemma-2b"])
def test_abstract_params_are_what_the_init_makes(arch):
    """Leaf for leaf the shapes and dtypes the port's own init gives."""
    cfg = get_config(arch).reduced()
    params = port_model.get_model(cfg).init(
        cfg, torch.Generator().manual_seed(0))
    assert described(port_model.abstract_params(cfg)) == {
        p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
        for p, t in flat(params).items()}


def _mesh(name: str):
    if name == "1x1":
        return cpu_mesh_ctx()
    return production_mesh_ctx(multi_pod=name == "2x16x16")


@pytest.mark.parametrize("mesh", ["1x1", "16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_bytes_equal_the_reference_trees(arch, mesh):
    cfg, mctx = get_config(arch), _mesh(mesh)
    for sh in applicable_shapes(cfg):
        lowered, step = dryrun.lower_cell(cfg, get_shape(sh), mctx)
        mem = lowered.memory_analysis()
        assert [mem.argument_size_in_bytes, mem.output_size_in_bytes] == \
            PINS[arch]["bytes"][mesh][sh], (sh, step)
        assert mem.temp_size_in_bytes is None
        assert mem.peak_memory_in_bytes is None


# ------------------------------------------------------------------ flops
SMALL = {"train": ShapeConfig("t", "train", 32, 2),
         "prefill": ShapeConfig("p", "prefill", 32, 2),
         "decode": ShapeConfig("d", "decode", 32, 2)}


def llama_hand_count(kind: str) -> int:
    """The reduced llama3.2-3b's products, 2 operations a multiply-add:
    per token and layer q, k, v, o and the SwiGLU's three; attention over
    the causal mask's keys (QK^T and PV; 5 products for the gradient);
    the logits of the last position (prefill, decode) or the chunked
    cross-entropy over every token (train: forward, its recomputation
    under the chunk's checkpoint, and two products for the gradient).
    Training: each layer product forward and twice backward (remat is
    "none" in the reduced config)."""
    cfg = get_config("llama3.2-3b").reduced()
    shape = SMALL[kind]
    b, s = shape.global_batch, shape.seq_len
    d, hd, v = cfg.d_model, cfg.head_dim, cfg.padded_vocab
    hq, hk, f, n = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.num_layers
    per_token = 2 * d * (hq * hd + 2 * hk * hd) + 2 * hq * hd * d \
        + 3 * 2 * d * f
    causal_keys = s * (s + 1) // 2
    attn = 2 * 2 * b * hq * hd                   # QK^T and PV, per key
    if kind == "decode":
        return n * (b * per_token + attn * s) + 2 * b * d * v
    if kind == "prefill":
        return n * (b * s * per_token + attn * causal_keys) + 2 * b * d * v
    tokens = b * s
    return (n * (3 * tokens * per_token + attn * causal_keys * 7 // 2)
            + 4 * 2 * tokens * d * v)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_reduced_llama_flops_equal_a_hand_count(kind):
    cfg = get_config("llama3.2-3b").reduced()
    assert cfg.remat == "none" and cfg.tie_embeddings
    lowered, _ = dryrun.lower_cell(cfg, SMALL[kind], cpu_mesh_ctx())
    cost = lowered.cost_analysis()
    assert cost["flops"] == llama_hand_count(kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_traces_on_meta(arch):
    """Each reduced configuration's three steps run on the meta device
    (the trace checks the outputs against the abstract ones) and launch
    no kernel; windowed and chunked attention is counted from the mask's
    keys, never the full product."""
    cfg = get_config(arch).reduced()
    before = (flash_ops.launches, flash_ops.bwd_launches,
              decode_ops.launches)
    for shape in SMALL.values():
        cost = dryrun.lower_cell(cfg, shape, cpu_mesh_ctx())[0] \
            .cost_analysis()
        assert cost["flops"] > cost["attention_flops"] >= 0
        assert (cost["attention_flops"] > 0) == (cfg.family != "ssm")
    assert (flash_ops.launches, flash_ops.bwd_launches,
            decode_ops.launches) == before


def test_windowed_attention_counted_from_attended_keys():
    cfg = get_config("h2o-danube-1.8b").reduced()         # window 32
    shape = ShapeConfig("p", "prefill", 96, 2)
    cost = dryrun.lower_cell(cfg, shape, cpu_mesh_ctx())[0].cost_analysis()
    keys = attended_keys(96, 96, window=cfg.window)
    assert keys < 96 * 97 // 2
    assert cost["attention_flops"] == cfg.num_layers * 4 * 2 \
        * cfg.num_heads * cfg.head_dim * keys


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv,window,chunk", [
    (1, 1, None, None), (17, 17, None, None), (40, 64, 8, None),
    (64, 40, None, None), (96, 96, None, 32), (50, 130, 20, 64),
    (7, 200, 300, 16)])
def test_attended_keys_counts_the_mask(sq, skv, window, chunk, causal):
    mask = attention_mask(sq, skv, "cpu", causal=causal, window=window,
                          chunk_attn=chunk)
    assert attended_keys(sq, skv, causal=causal, window=window,
                         chunk_attn=chunk) == int(mask.sum())


def test_meta_attention_gives_shapes_and_gradients():
    q = torch.empty((2, 4, 8, 16), device="meta", requires_grad=True)
    k = torch.empty((2, 2, 8, 16), device="meta", requires_grad=True)
    v = torch.empty((2, 2, 8, 16), device="meta", requires_grad=True)
    with FlopCounterMode(display=False) as counter:
        out = flash_ops.attention(q, k, v)
    assert out.shape == q.shape and out.is_meta
    product = 2 * 2 * 4 * 16 * 36
    assert counter.get_total_flops() == 2 * product
    with FlopCounterMode(display=False) as counter:
        dq, dk, dv = torch.autograd.grad(out.sum(), (q, k, v))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert counter.get_total_flops() == 5 * product
    with pytest.raises(ValueError, match="span"):
        decode_ops.decode(q[:, :, 0].detach(), k.detach(), v.detach(), None)


def test_run_cell_record_keys():
    rec = dryrun.run_cell("mamba2-130m", "long_500k", multi_pod=False,
                          verbose=False)
    assert rec["ok"], rec.get("error")
    ref_keys = {"arch", "shape", "mesh", "step", "ok", "lower_s",
                "compile_s", "flops", "bytes_accessed", "argument_bytes",
                "output_bytes", "temp_bytes", "peak_bytes_per_device",
                "collective_bytes", "collective_bytes_total", "n_devices"}
    assert ref_keys <= set(rec)
    assert rec["collective_bytes"] is None and rec["n_devices"] == 256
    assert [rec["argument_bytes"], rec["output_bytes"]] == \
        PINS["mamba2-130m"]["bytes"]["16x16"]["long_500k"]


# --------------------------------------------------------------- elastic
@pytest.mark.parametrize("old", [8, 16, 256, 512])
def test_elastic_restart_plan_equals_the_reference(old):
    for surviving in range(1, old + 1):
        for mp in (1, 2, 4, 8, 16):
            assert elastic.elastic_restart_plan(
                old, surviving, model_parallel=mp) == \
                jax_elastic.elastic_restart_plan(
                    old, surviving, model_parallel=mp)


def test_derive_mesh_shape_equals_the_reference():
    jdev = jax.devices()[0]
    for n in [*range(1, 41), 96, 250, 256, 500, 512]:
        for mp in (1, 2, 4, 8, 16):
            got = elastic.derive_mesh(n, model_parallel=mp,
                                      devices=[torch.device("cpu")] * n)
            want = jax_elastic.derive_mesh(n, model_parallel=mp,
                                           devices=[jdev] * n)
            assert got.mesh.devices.shape == want.mesh.devices.shape
            assert got.mesh.axis_names == tuple(want.mesh.axis_names)
            assert (got.dp_size, got.tp_size) == (want.dp_size,
                                                 want.tp_size)


# --------------------------------------------------------- scan_or_unroll
def test_scan_or_unroll_equals_a_plain_loop():
    cfg = get_config("whisper-medium").reduced()
    rng = np.random.default_rng(0)
    xs = {"a": torch.tensor(rng.standard_normal((5, 3))),
          "b": (torch.tensor(rng.standard_normal((5, 3))),)}

    def fn(x, xi):
        return x * 0.5 + xi["a"] * xi["b"][0], {"y": x + xi["a"]}

    x, ys = scan_or_unroll(cfg, fn, torch.ones(3), xs)
    want_x, want_y = torch.ones(3), []
    for i in range(5):
        want_y.append(want_x + xs["a"][i])
        want_x = want_x * 0.5 + xs["a"][i] * xs["b"][0][i]
    assert torch.equal(x, want_x)
    assert torch.equal(ys["y"], torch.stack(want_y))
    want_x = x
    for i in range(5):
        want_x = want_x + xs["a"][i]
    for scan in (True, False):
        got = scan_or_unroll(cfg.replace(scan_layers=scan),
                             lambda c, xi: (c + xi["a"], None), x, xs)
        assert got[1] is None and torch.equal(got[0], want_x)
    # a write into a step's view writes the stacked tree
    cache = {"k": torch.zeros((5, 2))}

    def write(c, xi):
        xi["k"].fill_(c)
        return c + 1, None

    scan_or_unroll(cfg, write, 1, cache)
    assert cache["k"][:, 0].tolist() == [1, 2, 3, 4, 5]


def test_sweep_in_worker_processes_keeps_the_order():
    cells = [("mamba2-130m", "long_500k"), ("h2o-danube-1.8b", "long_500k")]
    records = dryrun.sweep(cells, (False, True), verbose=False, workers=2)
    assert [(r["arch"], r["shape"], r["mesh"]) for r in records] == [
        (a, s, m) for a, s in cells for m in ("16x16", "2x16x16")]
    assert all(r["ok"] for r in records)
    for r in records:
        assert [r["argument_bytes"], r["output_bytes"]] == \
            PINS[r["arch"]]["bytes"][r["mesh"]][r["shape"]]
