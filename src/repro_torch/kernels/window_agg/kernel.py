"""ctypes binding of the CUDA segment sum (``csrc/window_agg.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_FN = {torch.float32: "window_agg_f32", torch.int64: "window_agg_i64"}


def window_agg(seg_ids: torch.Tensor, values: torch.Tensor,
               n_segments: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the segment-sum kernel on CUDA tensors; returns (sums [S, V],
    counts [S]) in the value dtype.  Raises on anything the kernel does
    not take."""
    if not (seg_ids.is_cuda and values.is_cuda):
        raise ValueError("window_agg kernel needs CUDA tensors")
    if seg_ids.device != values.device:
        raise ValueError("seg_ids and values on different devices")
    if values.dtype not in _FN:
        raise ValueError(f"window_agg takes float32/int64 values, "
                         f"got {values.dtype}")
    if seg_ids.dim() != 1 or values.dim() != 2 \
            or values.shape[0] != seg_ids.shape[0]:
        raise ValueError("window_agg takes seg_ids [N] and values [N, V]")
    seg = seg_ids.to(torch.int32).contiguous()
    values = values.contiguous()
    n, v = values.shape
    sums = torch.zeros((n_segments, v), dtype=values.dtype,
                       device=values.device)
    counts = torch.zeros(n_segments, dtype=values.dtype, device=values.device)
    name = _FN[values.dtype]
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_build.library(), name)(
            seg.data_ptr(), values.data_ptr(), n, v, n_segments,
            sums.data_ptr(), counts.data_ptr(), stream)
    _build.check(err, name)
    return sums, counts
