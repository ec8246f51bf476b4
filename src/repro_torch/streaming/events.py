"""Event batches: struct-of-arrays tensors, vector-processed end to end."""
from __future__ import annotations

from dataclasses import dataclass

import torch

PAYLOAD_WORDS = 4       # physical payload words (logical entry = 1000 B, §3)

# 0x9E3779B97F4A7C15 as the int64 with the same bits: an int64 multiply
# wraps to exactly the bits of the reference's uint64 multiply
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)


@dataclass
class EventBatch:
    key: torch.Tensor                # int64 [n]
    value: torch.Tensor              # int32 [n, PAYLOAD_WORDS]
    ts: torch.Tensor                 # float64 [n] event time, seconds
    kind: torch.Tensor               # int8  [n] event type tag

    def __len__(self) -> int:
        return self.key.shape[0]

    @property
    def device(self) -> torch.device:
        return self.key.device

    @classmethod
    def empty(cls, value_words: int = PAYLOAD_WORDS,
              device: torch.device | str = "cpu") -> "EventBatch":
        return cls(torch.empty(0, dtype=torch.int64, device=device),
                   torch.empty((0, value_words), dtype=torch.int32,
                               device=device),
                   torch.empty(0, dtype=torch.float64, device=device),
                   torch.empty(0, dtype=torch.int8, device=device))

    def to(self, device: torch.device | str) -> "EventBatch":
        return EventBatch(self.key.to(device), self.value.to(device),
                          self.ts.to(device), self.kind.to(device))

    def select(self, mask_or_idx) -> "EventBatch":
        m = mask_or_idx
        if m.dtype == torch.bool and bool(m.all()):
            return self        # batches are immutable (see ``slice``)
        return EventBatch(self.key[m], self.value[m], self.ts[m],
                          self.kind[m])

    def slice(self, lo: int, hi: int) -> "EventBatch":
        """Contiguous sub-batch as views (no copy).  Safe because
        operators never mutate batch tensors in place."""
        return EventBatch(self.key[lo:hi], self.value[lo:hi],
                          self.ts[lo:hi], self.kind[lo:hi])

    def split(self, n: int) -> tuple["EventBatch", "EventBatch"]:
        """(first n events, remainder) — both views."""
        return self.slice(0, n), self.slice(n, len(self))

    @staticmethod
    def concat(batches: list["EventBatch"]) -> "EventBatch":
        nonempty = [b for b in batches if len(b)]
        if not nonempty:
            dev = batches[0].device if batches else "cpu"
            return EventBatch.empty(device=dev)
        if len(nonempty) == 1:     # immutable batches: no defensive copy
            return nonempty[0]
        return EventBatch(torch.cat([b.key for b in nonempty]),
                          torch.cat([b.value for b in nonempty]),
                          torch.cat([b.ts for b in nonempty]),
                          torch.cat([b.kind for b in nonempty]))


def mix_hash(keys: torch.Tensor, shift: int) -> torch.Tensor:
    """The reference's uint64 hash ``h = k * golden; h ^= h >> shift;
    h >> 1`` on int64 tensors: the multiply wraps to the same bits, and
    each right shift is masked to make the arithmetic shift logical.
    The result is non-negative."""
    h = keys.to(torch.int64) * _GOLDEN
    h = h ^ ((h >> shift) & ((1 << (64 - shift)) - 1))
    return (h >> 1) & ((1 << 63) - 1)


def hash_partition(keys: torch.Tensor, p: int) -> torch.Tensor:
    """Flink-style murmur-ish key partitioning onto p tasks."""
    return mix_hash(keys, 31) % p
