"""Plain PyTorch version of the sorted-run probe."""
from __future__ import annotations

import torch


def sorted_probe_ref(table: torch.Tensor, queries: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """table: [T] sorted int keys (T >= 1); queries: [N] of the same dtype.

    Returns (pos [N] int32, found [N] bool): pos = number of table entries
    strictly less than the query (the leftmost insertion point, == index
    of the match when present)."""
    pos = torch.searchsorted(table, queries)
    pos_c = pos.clamp(max=table.shape[0] - 1)
    found = (table[pos_c] == queries) & (pos < table.shape[0])
    return pos.to(torch.int32), found
