"""The port on a Hopper card: each CUDA kernel against its plain PyTorch
version, the CUDA store in lockstep with the reference numpy store, and a
golden episode on ``cuda``.  Every test here needs the card and skips
without one; run them there with ``python -m pytest -q -m gpu
tests/test_torch_cuda.py``.  Imports no JAX (the card's machine has
none)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a Hopper (sm_90) CUDA device")
    return torch.device("cuda")


def _probe_cases(dtype):
    hi = int(np.iinfo(dtype).max)
    r = np.random.default_rng(3)
    big = np.unique(r.integers(0, hi // 2, 50_000)).astype(dtype)
    return [
        (np.array([42], dtype), np.array([41, 42, 43, hi], dtype)),
        (np.array([5, 5, 5, 9, 9], dtype), np.array([5, 7, 9], dtype)),
        (np.array([0, 17, hi], dtype), np.array([0, 1, hi, hi - 1], dtype)),
        (np.array([0, 17], dtype), np.array([hi, hi, 0], dtype)),
        (big, np.concatenate([big[r.integers(0, len(big), 7_000)],
                              r.integers(0, hi // 2, 6_001).astype(dtype)])),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_cuda_probe_matches_plain_version(hopper, dtype):
    from repro_torch.kernels.sorted_probe.kernel import sorted_probe
    from repro_torch.kernels.sorted_probe.ref import sorted_probe_ref
    for table, queries in _probe_cases(dtype):
        t = torch.from_numpy(table).to(hopper)
        q = torch.from_numpy(queries).to(hopper)
        pos, found = sorted_probe(t, q)
        rpos, rfound = sorted_probe_ref(t, q)
        assert torch.equal(pos, rpos) and torch.equal(found, rfound)
        np.testing.assert_array_equal(pos.cpu().numpy(),
                                      np.searchsorted(table, queries))
    empty = torch.empty(0, dtype=t.dtype, device=hopper)
    pos, found = sorted_probe(empty, q)
    assert not bool(found.any()) and not bool(pos.any())
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_aggregate_matches_plain_version(hopper):
    from repro_torch.kernels.window_agg.kernel import window_agg
    from repro_torch.kernels.window_agg.ref import window_agg_ref
    g = torch.Generator(device="cpu").manual_seed(0)
    for v in (1, 4):
        seg = torch.randint(-1, 513, (1025,), generator=g,
                            dtype=torch.int32).to(hopper)
        vals = torch.randn((1025, v), generator=g).to(hopper)
        sums, counts = window_agg(seg, vals, 513)
        rsums, rcounts = window_agg_ref(seg, vals, 513)
        # f32 atomics add in another order than index_add_
        torch.testing.assert_close(sums, rsums, rtol=1e-5, atol=1e-4)
        assert torch.equal(counts, rcounts)
    w = torch.randint(-(1 << 40), 1 << 40, (50_000, 1),
                      generator=g).to(hopper)
    gid = torch.sort(torch.randint(0, 9_000, (50_000,), generator=g)
                     ).values.to(hopper)
    sums, counts = window_agg(gid, w, 9_000)
    rsums, rcounts = window_agg_ref(gid, w, 9_000)
    assert torch.equal(sums, rsums) and torch.equal(counts, rcounts)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_probe_every_route_matches_plain_version(hopper):
    """``chip_smoke.probe_cases`` (tables of P^m +- 1 entries for the parts
    P = 33 and 513 a step of each route cuts its range into, batches
    smaller than a warp, unsorted queries with repeats against a small and
    a large table, the dtype's min and max) through the wrapper, on the
    plan's route, and through the bare launch of each route: exact."""
    assert _smoke().probe_sweep(torch, hopper) > 0


@pytest.mark.gpu
def test_cuda_aggregate_sweep_matches_plain_version(hopper):
    """``chip_smoke.agg_cases`` (runs across lane, warp and block edges,
    one segment over all rows with int64 wrap, unsorted ids, ids of -1,
    >= S and past 2^32, int32 and int64 ids, f32 with V = 4): int64 and
    counts exact, f32 within ``F32_TOL``."""
    assert _smoke().agg_sweep(torch, hopper)[1] > 0


@pytest.mark.gpu
def test_cuda_aggregate_is_two_device_operations(hopper):
    """One ``aggregate`` call on the store's int64 ids runs the zero fill
    and the kernel, and nothing else on the card (no id cast, no second
    fill)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.window_agg.ops import aggregate
    first = torch.rand(5_000, generator=torch.Generator().manual_seed(4)) > 0.3
    gids = (torch.cumsum(first, 0) - 1).to(hopper)
    w = torch.ones((5_000, 1), dtype=torch.int64, device=hopper)
    s = int(first.sum())
    aggregate(gids, w, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sums, counts = aggregate(gids, w, s)
        torch.cuda.synchronize()
    ops = sum(e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA)
    assert 1 <= ops <= 2
    assert int(counts.sum()) == 5_000 and int(sums.sum()) == 5_000


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(8))
def test_cuda_store_matches_reference_in_lockstep(hopper, seed):
    from test_torch_lsm import run_lockstep
    run_lockstep(seed, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(4))
def test_cuda_legacy_store_matches_reference_in_lockstep(hopper, seed):
    """The legacy store on the card (every probe through the kernel)
    against the reference's legacy store, op for op: values, found
    masks, metrics, items and the CLOCK arrays."""
    from test_torch_legacy import run_lockstep
    run_lockstep(seed, device="cuda")


@pytest.mark.gpu
def test_cuda_golden_episode(hopper):
    from repro_torch.kernels.sorted_probe import ops as probe_ops
    from repro_torch.kernels.window_agg import ops as agg_ops
    from test_torch_golden import assert_matches_golden
    probe_ops.launches = agg_ops.launches = 0
    assert_matches_golden("q11_justin", "cuda")
    assert probe_ops.launches > 0 and agg_ops.launches > 0


@pytest.mark.gpu
def test_cuda_faulted_spike_scenario_matches_pin(hopper, tmp_path):
    """``chip_smoke``'s run (b) on the card: q11 under a spike with a
    straggler and a killed task, handoff-priced, traced; equal to the
    reference's pinned answer, launching both store kernels."""
    import json
    from repro_torch.kernels.sorted_probe import ops as probe_ops
    from repro_torch.kernels.window_agg import ops as agg_ops
    smoke = _smoke()
    pins = json.loads(smoke.PINS.read_text())
    probe_ops.launches = agg_ops.launches = 0
    got = smoke.run_faults(smoke.port_api(), {"device": "cuda"},
                           tmp_path / "b.jsonl")
    assert probe_ops.launches > 0 and agg_ops.launches > 0
    smoke.hold("b_faults", got, pins["b_faults"])
    assert (tmp_path / "b.jsonl").read_text().count("\n") == got["spans"] + 1


@pytest.mark.gpu
def test_cuda_fleet_32_both_drivers_match_pin(hopper):
    import json
    smoke = _smoke()
    pins = json.loads(smoke.PINS.read_text())
    api = smoke.port_api()
    for driver in ("vectorized", "scalar"):
        got, _ = smoke.run_fleet_case(api, {"device": "cuda"}, "d_fleet_32",
                                      driver)
        smoke.hold(f"d_fleet_32 ({driver})", got, pins["d_fleet_32"])


def _smoke():
    """``chip_smoke.py`` at the repo root: its attention sweeps and their
    tolerance are the ones these tests run."""
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


@pytest.mark.gpu
def test_cuda_flash_attention_matches_plain_version(hopper):
    _, n_cases = _smoke().flash_sweep(torch, hopper)
    assert n_cases > 0


@pytest.mark.gpu
def test_cuda_flash_attention_takes_strided_views(hopper):
    """A [B, S, H, D] buffer viewed as [B, H, S, D] is read through its
    strides, and the output keeps that layout."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    g = torch.Generator(device="cpu").manual_seed(5)
    q = torch.randn((2, 130, 6, 64), generator=g).to(hopper, torch.bfloat16)
    kv = torch.randn((2, 130, 2, 2, 64), generator=g).to(hopper,
                                                         torch.bfloat16)
    qt, kt, vt = (q.transpose(1, 2), kv[:, :, 0].transpose(1, 2),
                  kv[:, :, 1].transpose(1, 2))
    got = flash_attention(qt, kt, vt, causal=True)
    assert got.stride() == qt.stride()
    want = flash_attention_ref(qt.contiguous(), kt.contiguous(),
                               vt.contiguous(), causal=True)
    _smoke().attn_err(torch, got, want, "bfloat16", "strided views")


@pytest.mark.gpu
def test_cuda_decode_attention_matches_plain_version(hopper):
    _, n_cases = _smoke().decode_sweep(torch, hopper)
    assert n_cases > 0


@pytest.mark.gpu
def test_cuda_decode_attention_one_split_and_repeatable(hopper):
    """Enough (b, KV head) pairs to fill the card give one split, whose
    block writes the output itself; back-to-back calls are bit-identical,
    so no call left a ticket counter set for the next."""
    from repro_torch.kernels.decode_attn.kernel import (_sm_count,
                                                        decode_attention,
                                                        decode_plan)
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    g = torch.Generator(device="cpu").manual_seed(6)
    b, hk, s, d = 2 * _sm_count(hopper.index), 1, 700, 128
    assert decode_plan(torch.bfloat16, b, 3, hk, d, s,
                       _sm_count(hopper.index)).n_splits == 1
    q = torch.randn((b, 3, d), generator=g).to(hopper, torch.bfloat16)
    k, v = (torch.randn((b, hk, s, d), generator=g).to(hopper, torch.bfloat16)
            for _ in range(2))
    vl = torch.randint(0, s + 1, (b,), generator=g,
                       dtype=torch.int32).to(hopper)
    got = decode_attention(q, k, v, vl)
    _smoke().attn_err(torch, got, decode_attention_ref(q, k, v, vl),
                      "bfloat16", "one split")
    for _ in range(3):
        assert torch.equal(decode_attention(q, k, v, vl), got)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_decoder_matches_cpu_and_launches_the_kernels(hopper):
    """The reduced llama3.2-3b in float32 on the card (attention kernels)
    against the same weights and tokens on the CPU (plain versions)."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import ops as decode_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.models import get_model
    cfg = get_config("llama3.2-3b").reduced().replace(
        compute_dtype="float32")
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 69),
                         generator=torch.Generator().manual_seed(1))
    logits = {}
    for dev in ("cpu", "cuda"):
        p = {"embed": params["embed"].to(dev), "ln_f": params["ln_f"].to(dev),
             "layers": {"dense0": {k: v.to(dev) for k, v in
                                   params["layers"]["dense0"].items()}}}
        flash_ops.launches = decode_ops.launches = 0
        out, caches = model.prefill(p, {"tokens": toks[:, :64].to(dev)}, cfg)
        caches = {g: {kv: F.pad(c, (0, 0, 0, 5)) for kv, c in d.items()}
                  for g, d in caches.items()}
        steps = [out]
        for i in range(5):
            out, caches = model.decode(p, caches,
                                       toks[:, 64 + i:65 + i].to(dev),
                                       64 + i, cfg)
            steps.append(out)
        logits[dev] = torch.stack(steps).cpu()
        if dev == "cuda":
            assert flash_ops.launches == cfg.num_layers
            assert decode_ops.launches == cfg.num_layers * 5
    ref = logits["cpu"]
    assert float((logits["cuda"] - ref).abs().max() / ref.abs().max()) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("d", [80, 128])
def test_cuda_decode_window_span_matches_plain_version(hopper, d):
    """The first slot ``lo``: at 0 the same bits as without it; inside the
    first tile, on a tile edge, at valid_len - 1 and ragged within
    ``ATTN_TOL`` of the plain version; one range on every row with the
    plan cut over its span (the decoder's call), too short, or over S;
    garbage below lo never read."""
    from repro_torch.kernels.decode_attn.kernel import decode_attention
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    g = torch.Generator(device="cpu").manual_seed(d)
    b, hq, hk, s = 4, 32, 8, 2100
    q = torch.randn((b, hq, d), generator=g).to(hopper, torch.bfloat16)
    k, v = (torch.randn((b, hk, s, d), generator=g).to(hopper,
                                                       torch.bfloat16)
            for _ in range(2))
    vl = torch.tensor([s, 2000, 700, 65], dtype=torch.int32, device=hopper)
    base = decode_attention(q, k, v, vl)
    assert torch.equal(decode_attention(q, k, v, vl, torch.zeros_like(vl)),
                       base)
    for los in ([5, 1, 17, 63], [64, 128, 0, 64], [s - 1, 1999, 699, 64],
                [1000, 3, 650, 0]):
        lo = torch.tensor(los, dtype=torch.int32, device=hopper)
        got = decode_attention(q, k, v, vl, lo)
        _smoke().attn_err(torch, got, decode_attention_ref(q, k, v, vl, lo),
                          "bfloat16", f"lo={los} D={d}")
        below = (torch.arange(s, device=hopper)[None, :]
                 < lo[:, None].long())[:, None, :, None]
        assert torch.equal(decode_attention(
            q, k.masked_fill(below, float("nan")),
            v.masked_fill(below, float("nan")), vl, lo), got)
    # the serve path's launch: one range on every row, the plan cut over
    # its span (and a plan cut too short, which only lengthens the last
    # split)
    from repro_torch.models.layers import slot_bounds
    t, window = 2000, 1024
    bounds = slot_bounds(hopper, b, t - window + 1, t + 1)
    want = decode_attention_ref(q, k, v, t + 1, t - window + 1)
    for span in (window, 64, None):
        got = decode_attention(q, k, v, bounds[1], bounds[0], span)
        _smoke().attn_err(torch, got, want, "bfloat16", f"span={span}")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_flash_head_dim_80_with_window(hopper):
    from repro_torch.kernels.flash_attn.kernel import flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    n = 0
    for label, name, q, k, v, causal, window in \
            _smoke().flash_window_cases(torch, hopper):
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        _smoke().attn_err(torch, got, want, name, label)
        n += 1
    assert n > 0
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mixtral-8x7b"])
def test_cuda_window_and_moe_decoders_match_cpu(hopper, arch):
    """The reduced sliding-window (and MoE) decoder in float32 on the card
    against the same weights and tokens on the CPU, the decode steps past
    the window of 32; every layer launches the kernels."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import ops as decode_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.models import get_model
    cfg = get_config(arch).reduced().replace(compute_dtype="float32")
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 69),
                         generator=torch.Generator().manual_seed(1))
    logits = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        flash_ops.launches = decode_ops.launches = 0
        out, caches = model.prefill(p, {"tokens": toks[:, :64].to(dev)}, cfg)
        caches = {g: {kv: F.pad(c, (0, 0, 0, 5)) for kv, c in d.items()}
                  for g, d in caches.items()}
        steps = [out]
        for i in range(5):
            out, caches = model.decode(p, caches,
                                       toks[:, 64 + i:65 + i].to(dev),
                                       64 + i, cfg)
            steps.append(out)
        logits[dev] = torch.stack(steps).cpu()
        if dev == "cuda":
            assert flash_ops.launches == cfg.num_layers
            assert decode_ops.launches == cfg.num_layers * 5
    ref = logits["cpu"]
    assert float((logits["cuda"] - ref).abs().max() / ref.abs().max()) < 1e-4


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.gpu
def test_cuda_flash_chunk_mask_matches_plain_version(hopper):
    """llama4's chunk mask in both routes (bf16 wgmma, f32 CUDA cores):
    an edge inside a query tile, on tile edges, a chunk smaller than a
    tile, rows at negative positions, Sq < Skv, with a window, without
    the causal mask, GQA 5 and 6."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    names = set()
    for label, name, q, k, v, causal, window, chunk in \
            _smoke().flash_chunk_cases(torch, hopper):
        kw = dict(causal=causal, window=window, chunk_attn=chunk)
        _smoke().attn_err(torch, flash_attention(q, k, v, **kw),
                          flash_attention_ref(q, k, v, **kw), name, label)
        names.add(name)
    assert names == {"float32", "bfloat16"}
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "internvl2-26b", "whisper-medium"])
def test_cuda_chunk_vlm_encdec_decoders_match_cpu(hopper, arch):
    """The reduced llama4 (chunk 32), internvl2 (8 image tokens) and
    whisper (16 frames) in float32 on the card against the same weights
    and inputs on the CPU: a 64-token prefill and 5 decode steps, the
    first at a chunk start; every attention launches its kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import ops as decode_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.launch.serve import make_batch, pad_kv, prefix_len
    from repro_torch.models import get_model
    cfg = get_config(arch).reduced().replace(compute_dtype="float32")
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 69),
                         generator=torch.Generator().manual_seed(1))
    per_prefill, per_step = _smoke().attn_launches(cfg)
    logits = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        flash_ops.launches = decode_ops.launches = 0
        out, caches = model.prefill(p, make_batch(cfg, toks[:, :64].to(dev),
                                                  2), cfg)
        caches = pad_kv(caches, 5)
        steps = [out]
        for i in range(5):
            out, caches = model.decode(p, caches,
                                       toks[:, 64 + i:65 + i].to(dev),
                                       prefix_len(cfg) + 64 + i, cfg)
            steps.append(out)
        logits[dev] = torch.stack(steps).cpu()
        if dev == "cuda":
            assert flash_ops.launches == per_prefill
            assert decode_ops.launches == per_step * 5
    ref = logits["cpu"]
    assert float((logits["cuda"] - ref).abs().max() / ref.abs().max()) < 1e-4


@pytest.mark.gpu
def test_cuda_flash_head_dim_256_matches_plain_version(hopper):
    """Head dim 256 and 160 in both routes (bf16 64-key tiles in a
    two-stage ring, f32 32-row tiles): windows, ragged lengths, a chunk,
    GQA 10:1 and the [B, S, H, D] view at recurrentgemma's 4,096
    positions and 2,048 window."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    names = set()
    for label, name, q, k, v, causal, window, chunk in \
            _smoke().flash_d256_cases(torch, hopper):
        kw = dict(causal=causal, window=window, chunk_attn=chunk)
        _smoke().attn_err(torch, flash_attention(q, k, v, **kw),
                          flash_attention_ref(q, k, v, **kw), name, label)
        names.add(name)
    assert names == {"float32", "bfloat16"}
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_decode_groups_and_head_dim_256_match_plain_version(hopper):
    """Groups of 1, 5, 6, 10, 16 and 17 q-heads per KV head at head dim
    128 and 256 (float32: sub-groups of at most 8 and 4 heads; bf16: the
    whole group of up to 16 a block on the tensor cores), with and without
    a first slot; bf16 also at D 64 and 80, a batch of one over a
    4,096-slot span, a span off the tile, an empty span, valid_len 0, a
    [B, S, Hk, D] view and a cache that must be copied.  Every bf16 call
    is planned on the "mma" route, every float32 one on "cuda_core" (the
    bf16 entry point holds only the tensor cores' kernel); back-to-back
    calls are bit-identical (every ticket was left zeroed)."""
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    n = 0
    for label, name, q, k, v, vl, lo in \
            _smoke().decode_group_cases(torch, hopper):
        route = "mma" if name == "bfloat16" else "cuda_core"
        assert _smoke().decode_case_plan(dk, q, k).route == route, label
        got = dk.decode_attention(q, k, v, vl, lo)
        want = decode_attention_ref(q, k, v, vl, 0 if lo is None else lo)
        _smoke().attn_err(torch, got, want, name, label)
        assert torch.equal(dk.decode_attention(q, k, v, vl, lo), got), label
        n += 1
    assert n > 0
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_decode_blocks_per_sm_as_planned(hopper):
    """The bf16 plan's blocks an SM are what the card gives each
    instantiation (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), so
    no plan makes a wave it did not count."""
    from repro_torch.kernels.decode_attn.kernel import (MMA_BLOCKS_PER_SM,
                                                        blocks_per_sm)
    for md, planned in MMA_BLOCKS_PER_SM.items():
        for d in (md // 2 + 16, md):
            assert blocks_per_sm(d) == planned, d


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_cuda_state_space_and_hybrid_match_cpu(hopper, arch):
    """The reduced mamba2 and recurrentgemma (at its real attention
    geometry: head dim 256, 10 q-heads on one KV head) in float32 on the
    card against the same weights and tokens on the CPU: a 64-token
    prefill and 5 decode steps past the window of 32; the hybrid's
    attention layers launch the kernels, mamba2 launches none."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import ops as decode_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.launch.serve import pad_kv
    from repro_torch.models import get_model
    cfg = get_config(arch).reduced().replace(compute_dtype="float32")
    if cfg.family == "hybrid":
        cfg = cfg.replace(head_dim=256, num_heads=10, num_kv_heads=1)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 69),
                         generator=torch.Generator().manual_seed(1))
    per_prefill, per_step = _smoke().attn_launches(cfg)
    assert (per_prefill > 0) == (cfg.family == "hybrid")
    logits = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        flash_ops.launches = decode_ops.launches = 0
        out, caches = model.prefill(p, {"tokens": toks[:, :64].to(dev)}, cfg)
        caches = pad_kv(caches, 5)
        steps = [out]
        for i in range(5):
            out, caches = model.decode(p, caches,
                                       toks[:, 64 + i:65 + i].to(dev),
                                       64 + i, cfg)
            steps.append(out)
        logits[dev] = torch.stack(steps).cpu()
        if dev == "cuda":
            assert flash_ops.launches == per_prefill
            assert decode_ops.launches == per_step * 5
    ref = logits["cpu"]
    assert float((logits["cuda"] - ref).abs().max() / ref.abs().max()) < 1e-4


@pytest.mark.gpu
def test_cuda_flash_backward_matches_plain_version(hopper):
    """``chip_smoke.flash_bwd_sweep``: the forward's log-sum-exp and the
    backward kernel against their plain versions over every mask, group
    and head dim of the trainable families, each backward twice and equal
    bit for bit."""
    _, n_cases = _smoke().flash_bwd_sweep(torch, hopper)
    assert n_cases > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_attention_autograd_gives_plain_gradients(hopper, dtype):
    """A loss taken on the card through ``layers.chunked_attention`` has
    gradients for q, k and v, through the backward kernel (counted), equal
    to autograd's through the plain version on the same inputs; a call
    without a gradient launches the forward alone."""
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    from repro_torch.models import layers
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cpu").manual_seed(9)
    q, k, v = (torch.randn(s, generator=g).to(hopper, dt)
               for s in ((2, 6, 200, 64), (2, 2, 200, 64), (2, 2, 200, 64)))
    r = torch.randn((2, 6, 200, 64), generator=g).to(hopper)
    grads = {}
    for name, fn in (("kernel", layers.chunked_attention),
                     ("plain", flash_attention_ref)):
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        flash_ops.launches = flash_ops.bwd_launches = 0
        out = fn(*ins, causal=True, window=150)
        torch.sum(out.float() * r).backward()
        grads[name] = [t.grad for t in ins]
        if name == "kernel":
            assert (flash_ops.launches, flash_ops.bwd_launches) == (1, 1)
    tol = _smoke().BWD_TOL[dtype]
    for got, want in zip(grads["kernel"], grads["plain"]):
        assert got is not None and got.dtype == want.dtype
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        assert err <= tol
    flash_ops.launches = flash_ops.bwd_launches = 0
    with torch.no_grad():
        layers.chunked_attention(q, k, v, causal=True)
    assert (flash_ops.launches, flash_ops.bwd_launches) == (1, 0)


@pytest.mark.gpu
def test_cuda_reduced_training_matches_pins(hopper):
    """Every reduced configuration's pinned training steps on the card
    (``chip_smoke.run_train_pin``) against the reference's losses."""
    import json
    smoke = _smoke()
    pins = json.loads(smoke.TRAIN_PINS.read_text())
    from repro_torch.configs import list_archs
    for arch in list_archs():
        got = smoke.run_train_pin(torch, arch, "cuda")
        smoke.hold_losses(arch, got["losses"], pins[arch]["losses"])


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hk,s,d,window", [(2, 6, 2, 300, 128, None),
                                                (1, 8, 2, 700, 80, 256),
                                                (1, 10, 1, 500, 256, 128)])
def test_cuda_wgmma_backward_through_autograd(hopper, b, hq, hk, s, d,
                                              window):
    """bf16 at D 128 with GQA, at D 80 under a window and at D 256 with
    recurrentgemma's group of 10 on one KV head (the wgmma route of
    ``bwd_plan``): autograd through ``ops.attention`` gives the plain
    version's gradients within ``BWD_TOL``, a second backward gives the
    same bits, and each backward is one counted call."""
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.flash_attn.kernel import bwd_plan
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    sms = torch.cuda.get_device_properties(hopper).multi_processor_count
    assert bwd_plan(b, hq, hk, s, s, d, torch.bfloat16, sms).route == "wgmma"
    g = torch.Generator(device="cpu").manual_seed(21)
    q, k, v = (torch.randn(shape, generator=g).to(hopper, torch.bfloat16)
               for shape in ((b, hq, s, d), (b, hk, s, d), (b, hk, s, d)))
    r = torch.randn((b, hq, s, d), generator=g).to(hopper)
    runs = []
    for fn in (flash_ops.attention, flash_ops.attention,
               flash_attention_ref):
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        flash_ops.bwd_launches = 0
        out = fn(*ins, causal=True, window=window)
        torch.sum(out.float() * r).backward()
        runs.append([t.grad for t in ins])
        if fn is flash_ops.attention:
            assert flash_ops.bwd_launches == 1
    kernel, again, plain = runs
    tol = _smoke().BWD_TOL["bfloat16"]
    for got, rep, want in zip(kernel, again, plain):
        assert torch.equal(got, rep)
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        assert err <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("d,hq,hk,window", [(256, 10, 1, 128),
                                            (192, 4, 2, None)])
def test_cuda_wide_backward_matches_plain_version(hopper, d, hq, hk, window):
    """Above D 128 the bf16 backward runs the wide wgmma kernels (64-key
    dK/dV blocks, ``bwd_plan``'s key tile): dq, dk and dv within
    ``BWD_TOL`` of ``flash_attention_bwd_ref`` at lengths ragged against
    the tiles, as the plan cuts the group and walked whole, and a second
    call equal bit for bit."""
    from repro_torch.kernels.flash_attn.kernel import (bwd_plan,
                                                       flash_attention,
                                                       flash_attention_bwd)
    from repro_torch.kernels.flash_attn.ref import flash_attention_bwd_ref
    sms = torch.cuda.get_device_properties(hopper).multi_processor_count
    b, s = 1, 333
    plan = bwd_plan(b, hq, hk, s, s, d, torch.bfloat16, sms, window=window)
    assert (plan.route, plan.key_tile) == ("wgmma", 64)
    g = torch.Generator(device="cpu").manual_seed(23)
    q, k, v, do = (torch.randn(shape, generator=g).to(hopper, torch.bfloat16)
                   for shape in ((b, hq, s, d), (b, hk, s, d), (b, hk, s, d),
                                 (b, hq, s, d)))
    out, lse = flash_attention(q, k, v, window=window, lse=True)
    want = flash_attention_bwd_ref(q, k, v, out, do, lse, window=window)
    tol = _smoke().BWD_TOL["bfloat16"]
    for shares in (None, 1):
        got = flash_attention_bwd(q, k, v, out, do, lse, window=window,
                                  shares=shares)
        again = flash_attention_bwd(q, k, v, out, do, lse, window=window,
                                    shares=shares)
        for x, y, w in zip(got, again, want):
            assert torch.equal(x, y)
            err = float((x.float() - w.float()).abs().max()
                        / w.float().abs().max())
            assert err <= tol


@pytest.mark.gpu
def test_cuda_backward_entry_refuses_a_plan_it_does_not_fit(hopper):
    """The C entry points run the route the plan names and check its
    scratch: a Delta buffer one element short, a part buffer one short (at
    D 64 and on the wide kernels at D 256), a route that does not take the
    dtype (bf16 on mma_sync, float32 on wgmma), and an unknown route each
    return an error before any launch; the plan's own sizes succeed."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn.kernel import ROUTE_ID, bwd_plan
    b, hq, hk, s = 1, 4, 1, 200
    sms = torch.cuda.get_device_properties(hopper).multi_processor_count
    g = torch.Generator(device="cpu").manual_seed(22)

    def call(dtype, route, shares, delta_n, part_n, d=64):
        q, o, do = (torch.randn((b, hq, s, d), generator=g).to(hopper, dtype)
                    for _ in range(3))
        k, v = (torch.randn((b, hk, s, d), generator=g).to(hopper, dtype)
                for _ in range(2))
        lse = torch.zeros((b, hq, s), device=hopper)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty(max(delta_n, 1), device=hopper)
        part = torch.empty(part_n, device=hopper) if part_n else None
        strides = (ctypes.c_int64 * 24)(*(st for t in (q, k, v, o, do, dq,
                                                       dk, dv)
                                          for st in t.stride()[:3]))
        name = ("flash_attn_bwd_bf16" if dtype == torch.bfloat16
                else "flash_attn_bwd_f32")
        err = getattr(_build.library(), name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(), b, hq, hk, s, s, d,
            strides, 1, 0, 0, route, shares, delta_n, part_n,
            torch.cuda.current_stream(hopper).cuda_stream)
        torch.cuda.synchronize(hopper)
        return err

    wg = bwd_plan(b, hq, hk, s, s, 64, torch.bfloat16, sms, shares=2)
    ms = bwd_plan(b, hq, hk, s, s, 64, torch.float32, sms)
    bf16, f32 = torch.bfloat16, torch.float32
    wgmma, mma_sync = ROUTE_ID["wgmma"], ROUTE_ID["mma_sync"]
    assert call(bf16, wgmma, 2, wg.delta_elems, wg.part_elems) == 0
    assert call(f32, mma_sync, hq, ms.delta_elems, ms.part_elems) == 0
    assert call(bf16, wgmma, 2, wg.delta_elems - 1, wg.part_elems) != 0
    assert call(bf16, wgmma, 2, wg.delta_elems, wg.part_elems - 1) != 0
    assert call(f32, mma_sync, hq, ms.delta_elems - 1, ms.part_elems) != 0
    assert call(f32, mma_sync, hq, ms.delta_elems, ms.part_elems - 1) != 0
    assert call(bf16, mma_sync, hq, ms.delta_elems, ms.part_elems) != 0
    assert call(f32, wgmma, 2, wg.delta_elems, wg.part_elems) != 0
    assert call(bf16, 2, 2, wg.delta_elems, wg.part_elems) != 0
    wide = bwd_plan(b, hq, hk, s, s, 256, torch.bfloat16, sms, shares=2)
    assert call(bf16, wgmma, 2, wide.delta_elems, wide.part_elems, 256) == 0
    assert call(bf16, wgmma, 2, wide.delta_elems - 1, wide.part_elems,
                256) != 0
    assert call(bf16, wgmma, 2, wide.delta_elems, wide.part_elems - 1,
                256) != 0
    assert call(bf16, mma_sync, hq, ms.delta_elems, ms.part_elems, 256) != 0


@pytest.mark.gpu
def test_cuda_derive_mesh_is_the_card(hopper):
    from repro_torch.launch.elastic import derive_mesh
    mctx = derive_mesh(1)
    assert mctx.mesh.shape == {"data": 1, "model": 1}
    assert mctx.mesh.devices[0, 0] == torch.device("cuda", 0)
    assert (mctx.dp_size, mctx.tp_size) == (1, 1)


@pytest.mark.gpu
def test_cuda_decode_cell_allocates_the_dry_run_bytes(hopper):
    """mamba2-130m's decode_32k on the card: the bytes asked of the
    allocator for its arguments equal ``memory_analysis()``'s, and one
    serve step gives finite logits with no attention kernel."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import dryrun
    from repro_torch.launch.elastic import derive_mesh
    cfg, shape = get_config("mamba2-130m"), get_shape("decode_32k")
    lowered, _ = dryrun.lower_cell(cfg, shape, derive_mesh(1))
    rec = dryrun.execute_cell(cfg, shape)
    assert rec["requested_bytes"] == rec["argument_bytes"] \
        == lowered.memory_analysis().argument_size_in_bytes
    assert rec["launches"] == {"flash_attention": 0, "decode_attention": 0}
    assert 0 < rec["peak_bytes"] < torch.cuda.get_device_properties(
        0).total_memory


@pytest.mark.gpu
def test_cuda_meta_trace_launches_no_kernel(hopper):
    """The dry-run's trace of a training and a decode step (attention,
    its gradient, the in-place AdamW, all on the meta device) leaves every
    kernel's launch count as it was."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import ops as decode_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.elastic import derive_mesh
    from repro_torch.models.config import ShapeConfig
    cfg = get_config("h2o-danube-1.8b").reduced()
    before = (flash_ops.launches, flash_ops.bwd_launches,
              decode_ops.launches)
    for shape in (ShapeConfig("gpu-t", "train", 48, 2),
                  ShapeConfig("gpu-d", "decode", 48, 2)):
        cost = dryrun.lower_cell(cfg, shape, derive_mesh(1))[0] \
            .cost_analysis()
        assert cost["attention_flops"] > 0
    assert (flash_ops.launches, flash_ops.bwd_launches,
            decode_ops.launches) == before


@pytest.mark.gpu
def test_cuda_flash_family_rank_shapes_match_plain_version(hopper):
    """The flash kernel at the shapes each rank of ``chip_smoke.py``'s
    phase 16 (b) gives it: whisper-medium's encoder on 4 of 16 heads
    (1,500 frames, D 64, not causal) and recurrentgemma-2b's prefill on
    its span of 3 q heads over the one KV head (D 256, the 2,048 window)."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    keys = []
    for key, arch, q, k, v, mask in _smoke().family_rank_flash(torch,
                                                               hopper):
        _smoke().attn_err(torch, flash_attention(q, k, v, **mask),
                          flash_attention_ref(q, k, v, **mask), "bfloat16",
                          f"{arch} {key}")
        keys.append(key)
    assert keys == ["rank_encoder_shape", "rank_hybrid_shape"]
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-medium", "recurrentgemma-2b"])
def test_cuda_decode_family_rank_shapes_match_plain_version(hopper, arch):
    """The decode kernel at the shapes each rank of phase 16 (b) gives it:
    whisper-medium's cross decode on 4 of 16 heads over 1,500 slots, and
    recurrentgemma-2b's decode, 3 q heads on the one KV head at D 256
    over the 514 slots of its last step."""
    from repro_torch.kernels.decode_attn.kernel import decode_attention
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    smoke = _smoke()
    sv = smoke.FAMILY_RANK[arch]
    cfg = smoke.shape_cfg(arch, sv)
    q, k, v, lo, hi = smoke.decode_shape(torch, hopper, cfg, sv, 63,
                                         cross=cfg.family == "encdec")
    vl, lo = (torch.full((q.shape[0],), n, dtype=torch.int32,
                         device=hopper) for n in (hi, lo))
    smoke.attn_err(torch, decode_attention(q, k, v, vl, lo),
                   decode_attention_ref(q, k, v, vl, lo), "bfloat16", arch)
    torch.cuda.synchronize()
