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
  ``scan_or_unroll`` equals a plain loop;
* every configuration of the reference's tuning plan
  (``benchmarks/perf_hillclimb.py``, copied as data in
  ``torch_hillclimb_cases``) lowers and counts its collectives on the
  production mesh, the padded and TP-only cells' bytes equal to the
  reference's (pinned under ``"_hillclimb"``).
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
from repro_torch.models.sharding import (Mesh, MeshCtx,  # noqa: E402
                                         ShapeDtypeStruct,
                                         cpu_mesh_ctx)
from repro_torch.models.transformer import scan_or_unroll  # noqa: E402
import torch_hillclimb_cases as HC  # noqa: E402

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
    assert rec["n_devices"] == 256
    # mamba2's decode runs across ranks: the rank's own collectives
    coll = dryrun.count_collectives(get_config("mamba2-130m"),
                                    get_shape("long_500k"),
                                    production_mesh_ctx())
    assert rec["collective_bytes"] == coll["bytes"]
    assert rec["collective_bytes_total"] == sum(coll["bytes"].values()) > 0
    assert [rec["argument_bytes"], rec["output_bytes"]] == \
        PINS["mamba2-130m"]["bytes"]["16x16"]["long_500k"]
    # and so does its training: the forward, recompute and backward's
    train = dryrun.run_cell("mamba2-130m", "train_4k", multi_pod=False,
                            verbose=False)
    coll = dryrun.count_collectives(get_config("mamba2-130m"),
                                    get_shape("train_4k"),
                                    production_mesh_ctx())
    assert train["ok"] and train["collective_bytes"] == coll["bytes"]
    assert train["collectives"] == coll["by_axes"]


def test_collective_bytes_of_a_decode_cell_written_out():
    """llama3.2-3b ``decode_32k`` on 16x16, the rank at coordinates 0:
    128 rows over 16 data ranks, 24 q heads and 8 KV heads that 16 model
    ranks do not divide (``wq``/``wk``/``wv`` gathered over ``model`` too;
    the 32,768 slots split over ``model``, gathered back each layer), bf16.
    Per layer 7 FSDP gathers, 3 column gathers, 2 cache gathers and 2
    psums of [8, 1, 3,072]; one embedding psum."""
    cfg = get_config("llama3.2-3b")
    got = dryrun.count_collectives(cfg, get_shape("decode_32k"),
                                   production_mesh_ctx())
    d, f, hd, n = 3072, 8192, 128, 28
    q, kv = 24 * hd, 8 * hd
    dp = (d // 16 * q // 16 + 2 * d // 16 * kv // 16 + q // 16 * d // 16
          + 3 * d // 16 * f // 16) * 16
    model = d * q + 2 * d * kv
    cache = 2 * 8 * 8 * 32768 * hd
    assert got["calls"] == {"all-gather": n * 12, "all-reduce": 1 + 2 * n}
    assert got["bytes"] == {"all-reduce": 8 * d * 2 * (1 + 2 * n),
                            "all-gather": n * 2 * (dp + model + cache)}
    assert got["by_axes"]["all-gather data"][0] == 7 * n


def test_every_decoder_serving_cell_counts_its_collectives():
    """Non-null bytes for every decode and train cell of every family on
    both production meshes (a train step's backward adds the
    reduce-scatters; the RG-LRU's gates add one a layer), and for the
    prefill cells of llama3.2-3b and the three other families (the sweep,
    ``python -m repro_torch.launch.dryrun --all --both-meshes``, counts
    every prefill); the enc-dec, SSM and hybrid families' ``train_4k``
    cells move all-gather, all-reduce and reduce-scatter bytes."""
    others = ("whisper-medium", "mamba2-130m", "recurrentgemma-2b")
    trained = set()
    for arch, sh in dryrun.all_cells():
        cfg, shape = get_config(arch), get_shape(sh)
        if shape.kind == "prefill" and arch not in ("llama3.2-3b",
                                                    *others):
            continue
        for name in ("16x16", "2x16x16"):
            got = dryrun.count_collectives(cfg, shape, _mesh(name))
            kinds = {"all-gather", "all-reduce"} | (
                {"reduce-scatter"} if shape.kind == "train"
                or cfg.family == "hybrid" else set())
            assert set(got["bytes"]) == kinds
            assert min(got["bytes"].values()) > 0
            if arch in others and sh == "train_4k":
                trained.add((arch, name))
    assert trained == {(a, m) for a in others for m in ("16x16", "2x16x16")}


FAMILY_CELLS = [(arch, sh) for arch in ("whisper-medium", "mamba2-130m",
                                        "recurrentgemma-2b")
                for sh in applicable_shapes(get_config(arch))
                if sh != "train_4k"]


@pytest.mark.parametrize("arch,sh", FAMILY_CELLS)
def test_family_serving_cells_count_a_ranks_own_run(arch, sh):
    """The enc-dec, SSM and hybrid families' prefill and decode cells at
    the reduced size on 2x4: the dry-run's count (its step on meta
    tensors) equals the collectives the rank at coordinates 0 issues
    running the same step on CPU tensors of its blocks on a
    ``CountingMesh``."""
    from repro_torch.models.sharding import CountingMesh
    from repro_torch.models.transformer import kv_cache_len
    cfg, shape = get_config(arch).reduced(), get_shape(sh).reduced()
    mesh = MeshCtx(Mesh(np.arange(8).reshape(2, 4), ("data", "model")))
    want = dryrun.count_collectives(cfg, shape, mesh)
    cm = MeshCtx(CountingMesh((2, 4), ("data", "model")))
    g = torch.Generator().manual_seed(0)

    def blocks(tree):
        if isinstance(tree, dict):
            return {k: blocks(v) for k, v in tree.items()}
        block = tree.sharding.shard_shape(tree.shape)
        if tree.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, block, generator=g,
                                 dtype=torch.int32)
        return torch.randn(block, generator=g).to(tree.dtype)

    model = port_model.get_model(cfg)
    params = blocks(port_model.abstract_params(cfg, cm))
    batch = blocks(port_model.abstract_batch(cfg, shape, cm))
    b = shape.global_batch
    with torch.no_grad():
        if shape.kind == "prefill":
            logits, _ = model.prefill(params, batch, cfg, cm,
                                      global_batch=b)
        else:
            logits, _ = model.decode(
                params, blocks(port_model.abstract_cache(cfg, shape, cm)),
                batch["tokens"], shape.seq_len - 1, cfg, cm,
                global_batch=b, n_slots=kv_cache_len(cfg, shape.seq_len))
    assert logits.shape[1] == cfg.padded_vocab // 4
    by_axes = {f"{kind} {','.join(axes)}": [rec["calls"], rec["bytes"]]
               for (kind, axes), rec in sorted(
                   cm.mesh.collective_log.items())}
    assert want["by_axes"] == by_axes
    assert want["bytes"] == cm.mesh.collective_bytes()


@pytest.mark.parametrize("arch", ["whisper-medium", "mamba2-130m",
                                  "recurrentgemma-2b"])
def test_other_families_loss_across_ranks_raises(arch):
    """The enc-dec, SSM and hybrid losses run across ranks: on a mesh over
    ranks a loss without its global batch raises, and with it returns a
    float32 scalar on this rank's blocks (a ``CountingMesh``'s, whose
    collectives communicate nothing)."""
    from repro_torch.models.sharding import CountingMesh
    cfg = get_config(arch).reduced()
    cm = MeshCtx(CountingMesh((2, 4), ("data", "model")))
    loss = port_model.get_model(cfg).loss
    with pytest.raises(ValueError, match="global_batch"):
        loss({}, {"tokens": torch.zeros((2, 8), dtype=torch.int32)}, cfg,
             cm)
    g = torch.Generator().manual_seed(0)

    def blocks(tree):
        if isinstance(tree, dict):
            return {k: blocks(v) for k, v in tree.items()}
        block = tree.sharding.shard_shape(tree.shape)
        if tree.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, block, generator=g,
                                 dtype=torch.int32)
        return (0.02 * torch.randn(block, generator=g)).to(tree.dtype)

    shape = ShapeConfig("train", "train", 8, 4)
    got = loss(blocks(port_model.abstract_params(cfg, cm)),
               blocks(port_model.abstract_batch(cfg, shape, cm)), cfg, cm,
               global_batch=4)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert torch.isfinite(got)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_collectives_of_a_train_cell_written_out(remat):
    """The reduced llama3.2-3b ``train_4k`` cell (2 x 128 tokens) on 2x4,
    the rank at coordinates 0: one row, 4 layers of d 64, 4 q heads and 2
    KV heads of 16 (4 model ranks do not divide the KV heads: ``wk`` and
    ``wv`` gathered over ``model`` too), d_ff 128, 256 tied vocabulary
    rows, bf16 compute, loss chunks of 64.  Forward: the embedding's psum,
    per layer 7 FSDP gathers (bf16), 2 column gathers and 2 psums of
    [1, 128, 64] bf16, and per loss chunk a gather of the [64] float32
    log-sum-exps over ``model`` and one psum of [2, 64]; the loss's psum
    over ``data``.  Backward: the chunks recomputed, the final states'
    ``pvary`` psum, per layer 2 ``pvary`` psums and the gathers'
    reduce-scatters, summed in float32; the replicated leaves' gradients
    summed over ``data`` in one psum; the global norm's psums over
    ``model`` (the embedding) and over both axes (the layer matrices).
    Under ``remat="full"`` each layer's forward is recomputed up to its
    last product, so its gathers and its attention psum are issued
    again, not its FFN's psum."""
    cfg = get_config("llama3.2-3b").reduced().replace(remat=remat)
    mesh = MeshCtx(Mesh(np.arange(8).reshape(2, 4), ("data", "model")))
    got = dryrun.count_collectives(cfg, get_shape("train_4k").reduced(),
                                   mesh)
    n, chunks, act = 4, 2, 128 * 64 * 2
    # per layer, gathered over data in bf16: wq and wo [64, 16] / [16, 64],
    # wk and wv [64, 8], wg, wu and wd [64, 32] / [32, 64]; then wk and wv
    # over model to [64, 32]; the blocks' gradients half those, float32
    dp = 2 * (64 * 64 // 4 * 2 + 64 * 32 // 4 * 2 + 64 * 128 // 4 * 3)
    model = 2 * 64 * 32 * 2
    f32 = 4 * (64 * 64 // 8 * 2 + 64 * 32 // 8 * 2 + 64 * 128 // 8 * 3)
    again = 2 if remat == "full" else 1
    want = {
        "all-gather data": [7 * n * again, dp * n * again],
        "all-gather model": [2 * n * again + 2 * chunks,
                             model * n * again + 2 * chunks * 4 * 64 * 4],
        "all-reduce data": [2, 2 * 4 + (64 * 64 + 64 + 2 * n * 64) * 4],
        "all-reduce data,model": [1, 4],
        "all-reduce model": [
            1 + 2 * n + (again - 1) * n + 2 * chunks + 1 + 2 * n + 1,
            act * (1 + 2 * n + (again - 1) * n + 1 + 2 * n)
            + 2 * chunks * 2 * 64 * 4 + 4],
        "reduce-scatter data": [7 * n, f32 * n],
        "reduce-scatter model": [2 * n, 2 * n * 64 * 8 * 4],
    }
    assert got["by_axes"] == want


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


@pytest.mark.parametrize("arch", ["whisper-medium", "mamba2-130m",
                                  "recurrentgemma-2b"])
def test_family_train_cells_count_a_ranks_own_run(arch):
    """The enc-dec, SSM and hybrid families' ``train_4k`` cell at the
    reduced size on 2x4: the dry-run's count (its train step on meta
    tensors) equals the collectives the rank at coordinates 0 issues
    running the same train step (forward, recompute, backward, the
    replicated leaves' sums and the norm) on CPU tensors of its blocks
    on a ``CountingMesh``."""
    from repro_torch.models.sharding import CountingMesh
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    cfg = get_config(arch).reduced().replace(compute_dtype="float32",
                                             remat="full")
    shape = get_shape("train_4k").reduced()
    mesh = MeshCtx(Mesh(np.arange(8).reshape(2, 4), ("data", "model")))
    want = dryrun.count_collectives(cfg, shape, mesh)
    cm = MeshCtx(CountingMesh((2, 4), ("data", "model")))
    g = torch.Generator().manual_seed(0)

    def blocks(tree):
        if isinstance(tree, dict):
            return {k: blocks(v) for k, v in tree.items()}
        block = tree.sharding.shard_shape(tree.shape)
        if tree.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, block, generator=g,
                                 dtype=torch.int32)
        return (0.02 * torch.randn(block, generator=g)).to(tree.dtype)

    params = blocks(port_model.abstract_params(cfg, cm))
    batch = blocks(port_model.abstract_batch(cfg, shape, cm))
    ocfg = AdamWConfig(opt_dtype=cfg.opt_dtype)
    _, _, metrics = make_train_step(cfg, ocfg, mctx=cm)(
        params, init_opt_state(params, ocfg), batch,
        global_batch=shape.global_batch)
    assert np.isfinite(float(metrics["loss"]))
    by_axes = {f"{kind} {','.join(axes)}": [rec["calls"], rec["bytes"]]
               for (kind, axes), rec in sorted(
                   cm.mesh.collective_log.items())}
    assert want["by_axes"] == by_axes
    assert set(want["bytes"]) == {"all-gather", "all-reduce",
                                  "reduce-scatter"}


# ------------------------------------------------------------- the tuning plan
def test_the_tuning_plan_copy_is_the_plans():
    assert HC.same_as_the_plan(ROOT)
    assert set(PINS["_hillclimb"]) == set(HC.BYTE_PINNED)
    for name, arch, sh, ov in HC.ITERATIONS:
        if name in HC.BYTE_PINNED:
            pin = PINS["_hillclimb"][name]
            assert (pin["arch"], pin["shape"], pin["overrides"]) == (
                arch, sh, ov)


@pytest.mark.parametrize("name,arch,sh,overrides", HC.ITERATIONS,
                         ids=[it[0] for it in HC.ITERATIONS])
def test_every_tuning_plan_configuration_lowers(name, arch, sh, overrides):
    """Each iteration's cell (``cfg.replace(**overrides)``) lowers on the
    16x16 mesh and its step runs on meta tensors on a ``CountingMesh``
    (``count_collectives``) without a raise.  Its per-device argument and
    output bytes equal the reference's: the base cell's pins where the
    overrides leave the trees as they are (layout and numerics knobs),
    the iteration's own on every mesh where they change them (``wq``
    padded to ``padded_heads``, TP-only weights)."""
    cfg = get_config(arch).replace(**overrides)
    shape = get_shape(sh)
    meshes = ("1x1", "16x16", "2x16x16") if name in HC.BYTE_PINNED \
        else ("16x16",)
    for mesh in meshes:
        lowered, _ = dryrun.lower_cell(cfg, shape, _mesh(mesh))
        mem = lowered.memory_analysis()
        want = (PINS["_hillclimb"][name]["bytes"][mesh]
                if name in HC.BYTE_PINNED else PINS[arch]["bytes"][mesh][sh])
        assert [mem.argument_size_in_bytes, mem.output_size_in_bytes] == \
            want, mesh
    got = dryrun.count_collectives(cfg, shape, _mesh("16x16"))
    assert {"all-gather", "all-reduce"} <= set(got["calls"])
    assert min(got["bytes"].values()) > 0


def test_tuning_plan_collectives_follow_the_layouts():
    """On 16x16, per layer of llama3.2-3b's ``prefill_32k``: "seq" gathers
    ``wo`` over ``model`` too (``wq``, ``wk`` and ``wv`` are gathered whole
    under "auto" as well: 24 q and 8 KV heads over 16) and its rows of
    ``o @ wo`` once, and issues no attention psum; "heads" (24 heads over
    16: whole heads, two a rank) gathers ``wo`` whole; the padding to 32
    gathers ``wo`` whole and ``wq`` no more (its columns divide); "dots"
    issues what "full" does (the policy keeps products, the recompute
    gathers again)."""
    counts = {name: dryrun.count_collectives(
        get_config(arch).replace(**ov), get_shape(sh), _mesh("16x16"))
        for name, arch, sh, ov in HC.ITERATIONS
        if name[:2] in ("A0", "A1", "A2", "A6", "C1", "C2")}
    n = get_config("llama3.2-3b").num_layers

    def calls(name, key):
        return counts[name]["by_axes"].get(key, [0, 0])[0]
    base = calls("A0-baseline", "all-gather model")
    assert calls("A2-attn-seq", "all-gather model") - base == 2 * n
    assert calls("A0-baseline", "all-reduce model") - calls(
        "A2-attn-seq", "all-reduce model") == n
    assert calls("A1-attn-heads", "all-gather model") - base == n
    assert calls("A6-pad-heads", "all-gather model") - base == 0
    assert counts["C2-remat-dots"]["by_axes"] == \
        counts["C1-attn-heads"]["by_axes"]
