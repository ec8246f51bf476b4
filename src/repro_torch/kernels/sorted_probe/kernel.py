"""ctypes binding of the CUDA sorted-run probe (``csrc/sorted_probe.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_FN = {torch.int32: "sorted_probe_i32", torch.int64: "sorted_probe_i64"}
THREADS = 256              # threads per block, both routes
INDEXED_QUERIES = 4_096    # the smallest batch the indexed route takes


def probe_plan(n: int, t: int) -> tuple[int, int]:
    """(lanes per query, blocks) for N queries into a T-entry table.  A
    batch of at least ``INDEXED_QUERIES`` takes one thread a query behind
    a splitter index (the cooperative route's 32 loads a step per query
    cost more there than the latency they save); a smaller one, or an
    empty table, takes a warp a query.  Pure host arithmetic, no device
    synchronisation."""
    lanes = 1 if n >= INDEXED_QUERIES and t > 0 else 32
    return lanes, probe_blocks(n, lanes)


def probe_blocks(n: int, lanes: int) -> int:
    """The fewest blocks that give each of N queries its lanes."""
    return -(-n * lanes // THREADS)


def sorted_probe(table: torch.Tensor, queries: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the probe kernel on CUDA tensors, on the route
    ``probe_plan`` picks; returns (pos int32, found bool).  Raises on
    anything the kernel does not take."""
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
    n, t = queries.shape[0], table.shape[0]
    pos = torch.empty(n, dtype=torch.int32, device=queries.device)
    found = torch.empty(n, dtype=torch.bool, device=queries.device)
    lanes, blocks = probe_plan(n, t)
    name = _FN[table.dtype]
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_build.library(), name)(
            table.data_ptr(), t, queries.data_ptr(), n, pos.data_ptr(),
            found.data_ptr(), lanes, blocks, stream)
    _build.check(err, name)
    return pos, found
