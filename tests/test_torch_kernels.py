"""The port's kernel ops against the JAX package's Pallas kernels.

On the CPU each port op runs its plain PyTorch version; the JAX side runs
the Pallas kernel in interpret mode (int64 inside ``jax.enable_x64``).
The shape sweep covers ``test_kernel_parity``'s edge cases plus tables
past one 2048-entry tile and query batches past one 512-query block.
The CUDA kernels themselves run only on a card (``test_torch_cuda``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.sorted_probe.ops import probe as jax_probe  # noqa: E402
from repro.kernels.window_agg.ops import aggregate as jax_aggregate  # noqa
from repro_torch.kernels.sorted_probe import ops as probe_ops  # noqa: E402
from repro_torch.kernels.window_agg import ops as agg_ops  # noqa: E402


def _probe_cases(dtype):
    hi = int(np.iinfo(dtype).max)
    r = np.random.default_rng(3)
    big = np.unique(r.integers(0, hi // 2, 5_000)).astype(dtype)
    return {
        "empty_table": (np.empty(0, dtype), np.array([1, 2, 3], dtype)),
        "empty_queries": (np.array([1, 2, 3], dtype), np.empty(0, dtype)),
        "single_key": (np.array([42], dtype), np.array([41, 42, 43], dtype)),
        "all_duplicate_queries": (np.arange(0, 1000, 7, dtype=dtype),
                                  np.full(2048, 700, dtype)),
        "duplicate_table": (np.array([5, 5, 5, 9, 9], dtype),
                            np.array([5, 7, 9], dtype)),
        "dtype_max_present": (np.array([0, 17, hi], dtype),
                              np.array([0, 1, hi, hi - 1], dtype)),
        "dtype_max_absent": (np.array([0, 17], dtype), np.array([hi], dtype)),
        "exact_tile_multiple": (np.arange(2048, dtype=dtype) * 3,
                                np.arange(512, dtype=dtype) * 3 + 1),
        "past_one_tile": (big, np.concatenate(
            [big[r.integers(0, len(big), 700)],
             r.integers(0, hi // 2, 600).astype(dtype),
             np.array([hi, 0], dtype)])),
    }


PROBE_CASES = sorted(_probe_cases(np.int32))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", PROBE_CASES)
def test_probe_matches_pallas_kernel(case, dtype):
    table, queries = _probe_cases(dtype)[case]
    with jax.enable_x64(True):
        jp, jf = jax_probe(jnp.asarray(table), jnp.asarray(queries),
                           impl="pallas", interpret=True)
        jp, jf = np.asarray(jp), np.asarray(jf)
    tp, tf = probe_ops.probe(torch.from_numpy(table),
                             torch.from_numpy(queries))
    assert tp.dtype == torch.int32 and tf.dtype == torch.bool
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tf.numpy(), jf)
    # and the numpy oracle: leftmost insertion point, exact membership
    np.testing.assert_array_equal(tp.numpy(),
                                  np.searchsorted(table, queries))
    np.testing.assert_array_equal(tf.numpy(), np.isin(queries, table))


def _agg_cases():
    r = np.random.default_rng(5)
    return {
        "empty_events": (np.empty(0, np.int32),
                         np.empty((0, 3), np.float32), 16),
        "zero_segments": (np.empty(0, np.int32),
                          np.empty((0, 2), np.float32), 0),
        "single_segment_duplicates": (np.zeros(1500, np.int32),
                                      np.ones((1500, 1), np.float32), 1),
        "off_tile_v2": (r.integers(0, 513, 1025).astype(np.int32),
                        r.normal(size=(1025, 2)).astype(np.float32), 513),
        "padding_ids_v4": (r.integers(-1, 300, 2100).astype(np.int32),
                           r.normal(size=(2100, 4)).astype(np.float32), 300),
        "sorted_ids_v1": (np.sort(r.integers(0, 700, 3000)).astype(np.int32),
                          r.normal(size=(3000, 1)).astype(np.float32), 700),
    }


@pytest.mark.parametrize("case", sorted(_agg_cases()))
def test_aggregate_f32_matches_pallas_kernel(case):
    seg, vals, s = _agg_cases()[case]
    js, jc = jax_aggregate(jnp.asarray(seg), jnp.asarray(vals), s,
                           impl="pallas", interpret=True)
    ts, tc = agg_ops.aggregate(torch.from_numpy(seg), torch.from_numpy(vals),
                               s)
    assert ts.dtype == torch.float32 and tc.dtype == torch.float32
    assert ts.shape == (s, vals.shape[1]) and tc.shape == (s,)
    # f32 sums in another order than the MXU's: rtol = atol = 1e-5
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("seed", range(4))
def test_aggregate_int64_equals_reduceat(seed):
    """The store's route: int64 weights over key-sorted group ids, exact
    (including sums far past float32's 2^24)."""
    r = np.random.default_rng(seed)
    keys = np.sort(r.integers(0, 400, 2_000 + 500 * seed))
    w = r.integers(-(1 << 40), 1 << 40, len(keys)).astype(np.int64)
    first = np.r_[True, keys[1:] != keys[:-1]]
    starts = np.flatnonzero(first)
    gids = np.cumsum(first) - 1
    sums, counts = agg_ops.aggregate(torch.from_numpy(gids),
                                     torch.from_numpy(w[:, None]),
                                     len(starts))
    assert sums.dtype == torch.int64 and counts.dtype == torch.int64
    np.testing.assert_array_equal(sums[:, 0].numpy(),
                                  np.add.reduceat(w, starts))
    np.testing.assert_array_equal(counts.numpy(), np.diff(
        np.r_[starts, len(keys)]))


def test_aggregate_skips_out_of_range_ids():
    seg = torch.tensor([-1, 0, 2, 3, 7, 2], dtype=torch.int32)
    vals = torch.arange(6, dtype=torch.int64)[:, None]
    sums, counts = agg_ops.aggregate(seg, vals, 3)
    assert sums[:, 0].tolist() == [1, 0, 2 + 5]
    assert counts.tolist() == [1, 0, 2]


def test_cpu_tensors_never_launch_kernels():
    before = (probe_ops.launches, agg_ops.launches)
    probe_ops.probe(torch.arange(10), torch.arange(5))
    agg_ops.aggregate(torch.zeros(4, dtype=torch.int32),
                      torch.ones((4, 1), dtype=torch.int64), 1)
    assert (probe_ops.launches, agg_ops.launches) == before
