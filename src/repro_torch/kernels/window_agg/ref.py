"""Plain PyTorch version of the keyed segment sum."""
from __future__ import annotations

import torch


def window_agg_ref(seg_ids: torch.Tensor, values: torch.Tensor,
                   n_segments: int) -> tuple[torch.Tensor, torch.Tensor]:
    """seg_ids: [N] int; values: [N, V] float32 or int64.  Ids outside
    [0, n_segments) are skipped.

    Returns (sums [n_segments, V], counts [n_segments]): counts are
    float32 for float32 values and int64 for int64 values."""
    cdt = torch.float32 if values.dtype == torch.float32 else torch.int64
    ok = (seg_ids >= 0) & (seg_ids < n_segments)
    seg = seg_ids[ok].long()
    sums = torch.zeros((n_segments, values.shape[1]), dtype=values.dtype,
                       device=values.device)
    sums.index_add_(0, seg, values[ok])
    counts = torch.zeros(n_segments, dtype=cdt, device=values.device)
    counts.index_add_(0, seg, torch.ones(seg.shape[0], dtype=cdt,
                                         device=values.device))
    return sums, counts
