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
