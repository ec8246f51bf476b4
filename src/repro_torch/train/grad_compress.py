"""Int8 gradient compression with error feedback (the reference's
``repro.train.grad_compress``).

Per-tensor symmetric int8 quantization; the quantization residual is
carried in an error-feedback buffer (bf16) so the compression bias
vanishes over steps.  The reference brackets its cross-pod all-reduce
with it; on one device the train loop applies it to the gradients before
the update, as the reference's training driver does.  The arithmetic is
the reference's, in float32, rounding half to even, so the int8 codes and
scales equal the reference's bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.train.tree import leaves, tree_map, unflatten


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale float32 0-d): scale = max|x| / 127 + 1e-12, q the
    rounded x / scale clipped to [-127, 127]."""
    x32 = x.float()
    scale = torch.max(torch.abs(x32)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(grads, error_buf):
    """Returns (quantized tree, scales tree, new error buffer): each leaf
    quantized after adding its carried error, the new error the residual
    in the buffer's dtype."""
    out = []
    flat_e = dict(leaves(error_buf))
    for path, g in leaves(grads):
        e = flat_e[path]
        g32 = g.float() + e.float()
        q, s = quantize_int8(g32)
        out.append((q, s, (g32 - dequantize_int8(q, s)).to(e.dtype)))
    return tuple(unflatten(grads, [o[i] for o in out]) for i in range(3))


def init_error_buf(params):
    """bf16 zeros of each parameter's shape."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                          device=p.device), params)
