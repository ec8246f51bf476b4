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
    block is also the last one; back-to-back calls are bit-identical, so
    each call left the ticket counter zeroed for the next."""
    from repro_torch.kernels.decode_attn.kernel import (_sm_count,
                                                        decode_attention,
                                                        split_plan)
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    g = torch.Generator(device="cpu").manual_seed(6)
    b, hk, s, d = 2 * _sm_count(hopper.index), 1, 700, 128
    assert split_plan(b, hk, s, _sm_count(hopper.index))[1] == 1
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
