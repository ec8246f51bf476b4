"""Public wrapper for the sorted-run probe.

CUDA tensors go through the hand-written kernel, CPU tensors through the
plain PyTorch version; there is no other path and no fallback.
``launches`` counts kernel launches (reset it to 0 to count a run)."""
from __future__ import annotations

import torch

from repro_torch.kernels.sorted_probe.kernel import sorted_probe
from repro_torch.kernels.sorted_probe.ref import sorted_probe_ref

launches = 0


def probe(table: torch.Tensor, queries: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (pos [N] int32, found [N] bool); pos is the insertion point
    (== index of the match where found).  Degenerate shapes short-circuit:
    an empty table finds nothing at rank 0, an empty query batch returns
    empties."""
    global launches
    n = int(queries.shape[0])
    if int(table.shape[0]) == 0 or n == 0:
        return (torch.zeros(n, dtype=torch.int32, device=queries.device),
                torch.zeros(n, dtype=torch.bool, device=queries.device))
    if queries.is_cuda:
        out = sorted_probe(table, queries)
        launches += 1
        return out
    return sorted_probe_ref(table, queries)
