"""Public wrapper for the keyed segment sum.

CUDA tensors go through the hand-written kernel, CPU tensors through the
plain PyTorch version; there is no other path and no fallback.
``launches`` counts kernel launches (reset it to 0 to count a run)."""
from __future__ import annotations

import torch

from repro_torch.kernels.window_agg.kernel import window_agg
from repro_torch.kernels.window_agg.ref import window_agg_ref

launches = 0


def aggregate(seg_ids: torch.Tensor, values: torch.Tensor, n_segments: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """seg_ids in [0, n_segments) (others skipped); values [N, V] float32
    or int64.  Returns (sums [S, V], counts [S]), float32 counts for
    float32 values and int64 counts for int64 values.  Degenerate shapes
    short-circuit to zeros."""
    global launches
    if int(values.shape[0]) == 0 or n_segments == 0:
        cdt = torch.float32 if values.dtype == torch.float32 else torch.int64
        return (torch.zeros((n_segments, int(values.shape[1])),
                            dtype=values.dtype, device=values.device),
                torch.zeros(n_segments, dtype=cdt, device=values.device))
    if values.is_cuda:
        out = window_agg(seg_ids, values, n_segments)
        launches += 1
        return out
    return window_agg_ref(seg_ids, values, n_segments)
