"""Event batches and key hashing of the port against the reference.

The reference hashes in uint64 (wrapping multiply, logical shifts); the
port does it on int64 tensors with masked shifts.  Partition ids and
cache set ids must be identical for every key, including negative,
high-bit and near-2^63 keys.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.state.lsm import LSMStore as RefStore  # noqa: E402
from repro.streaming.events import hash_partition as ref_partition  # noqa
from repro_torch.state.lsm import LSMStore  # noqa: E402
from repro_torch.streaming.events import (EventBatch,  # noqa: E402
                                          hash_partition)


def _keys(seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    edge = np.array([0, 1, -1, 2**63 - 1, -2**63, 2**63 - 2, -2**63 + 1,
                     2**62, 2**45 - 1, 2**45, 2**47, 2**31, -2**31],
                    np.int64)
    return np.concatenate([
        edge,
        r.integers(-2**63, 2**63 - 1, 20_000, dtype=np.int64),
        r.integers(2**62, 2**63 - 1, 5_000, dtype=np.int64),      # high bit
        r.integers(-5_000, 5_000, 5_000).astype(np.int64),       # negative
        r.integers(0, 600_000, 5_000).astype(np.int64),          # nexmark
    ])


@pytest.mark.parametrize("p", [1, 2, 3, 7, 13, 64, 1 << 16])
def test_hash_partition_matches_reference(p):
    keys = _keys(p)
    got = hash_partition(torch.from_numpy(keys), p)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref_partition(keys, p))


@pytest.mark.parametrize("memory_mb", [0.25, 2.0, 158.0, 632.0])
def test_cache_set_hash_matches_reference(memory_mb):
    """``LSMStore._sets`` (the ``>> 29`` hash) on the same keys."""
    keys = _keys(int(memory_mb * 4))
    port = LSMStore(memory_mb, device="cpu")
    ref = RefStore(memory_mb)
    assert port.cache_sets == ref.cache_sets
    np.testing.assert_array_equal(
        port._sets(torch.from_numpy(keys)).numpy(), ref._sets(keys))


def _batch(n: int, seed: int = 0) -> EventBatch:
    r = np.random.default_rng(seed)
    return EventBatch(torch.from_numpy(r.integers(0, 100, n)),
                      torch.from_numpy(r.integers(0, 9, (n, 4))
                                       .astype(np.int32)),
                      torch.arange(n, dtype=torch.float64),
                      torch.zeros(n, dtype=torch.int8))


def test_batch_select_slice_split_concat():
    b = _batch(10)
    assert b.select(torch.ones(10, dtype=torch.bool)) is b
    sel = b.select(b.key % 2 == 0)
    assert torch.equal(sel.key, b.key[b.key % 2 == 0])
    head, rest = b.split(4)
    assert len(head) == 4 and len(rest) == 6
    assert torch.equal(EventBatch.concat([head, rest]).value, b.value)
    assert EventBatch.concat([head]) is head
    empty = EventBatch.concat([])
    assert len(empty) == 0 and empty.value.shape == (0, 4)
    idx = b.select(torch.tensor([3, 1]))
    assert idx.ts.tolist() == [3.0, 1.0]
