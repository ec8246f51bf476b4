"""ctypes binding of the CUDA sorted-run probe (``csrc/sorted_probe.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_FN = {torch.int32: "sorted_probe_i32", torch.int64: "sorted_probe_i64"}


def sorted_probe(table: torch.Tensor, queries: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the probe kernel on CUDA tensors; returns (pos int32, found
    bool).  Raises on anything the kernel does not take."""
    if not (table.is_cuda and queries.is_cuda):
        raise ValueError("sorted_probe kernel needs CUDA tensors")
    if table.device != queries.device:
        raise ValueError("table and queries on different devices")
    if table.dtype != queries.dtype or table.dtype not in _FN:
        raise ValueError(f"sorted_probe takes int32/int64 table and queries "
                         f"of one dtype, got {table.dtype}/{queries.dtype}")
    if table.dim() != 1 or queries.dim() != 1:
        raise ValueError("sorted_probe takes 1-D table and queries")
    if table.shape[0] >= 2**31:
        raise ValueError("table too long for int32 positions")
    table = table.contiguous()
    queries = queries.contiguous()
    n = queries.shape[0]
    pos = torch.empty(n, dtype=torch.int32, device=queries.device)
    found = torch.empty(n, dtype=torch.bool, device=queries.device)
    name = _FN[table.dtype]
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_build.library(), name)(
            table.data_ptr(), table.shape[0], queries.data_ptr(), n,
            pos.data_ptr(), found.data_ptr(), stream)
    _build.check(err, name)
    return pos, found
