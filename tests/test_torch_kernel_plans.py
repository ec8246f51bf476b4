"""Host-side plans of the port's CUDA kernels, on the CPU: the decode
kernel's split plan, the flash and decode wrappers' decisions to copy an
operand the copies cannot read in place, and the kernel build's hash and
compiler report.  No GPU needed: the kernels themselves run only on a card
(``test_torch_cuda``)."""
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attn.kernel import (  # noqa: E402
    BLOCKS_PER_SM, TILE, rows_aligned, split_plan)
from repro_torch.kernels.flash_attn.kernel import tma_ready  # noqa: E402


@settings(max_examples=300, deadline=None)
@given(batch=st.integers(1, 64), kv_heads=st.integers(1, 16),
       slots=st.integers(1, 40_000), sms=st.integers(1, 200))
def test_split_plan_cuts_the_cache_once(batch, kv_heads, slots, sms):
    chunk, n_splits = split_plan(batch, kv_heads, slots, sms)
    assert chunk % TILE == 0 and chunk > 0 and n_splits >= 1
    assert n_splits * chunk >= slots
    # split i is the slots [i * chunk, min((i + 1) * chunk, slots)): they
    # follow each other, none is empty, and together they hold every slot
    bounds = [(i * chunk, min((i + 1) * chunk, slots))
              for i in range(n_splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == slots
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    # one wave: the blocks fit on the card at once, unless the (b, KV
    # head) pairs alone do not
    assert batch * kv_heads * n_splits <= max(BLOCKS_PER_SM * sms,
                                              batch * kv_heads)


def test_split_plan_at_the_serve_shape():
    # 8 requests x 8 KV heads over a 2,176-slot cache on 132 SMs: four
    # splits of 576 slots, 256 blocks for 264 resident slots
    assert split_plan(8, 8, 2176, 132) == (576, 4)
    # enough (b, KV head) pairs to fill the card: one split
    assert split_plan(32, 8, 2176, 132) == (2176, 1)
    assert split_plan(8, 8, 7, 132) == (64, 1)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_flash_operands_read_in_place_or_copied():
    assert tma_ready(_bf16(2, 4, 300, 128))
    assert tma_ready(_bf16(2, 4, 300, 80))            # 160-byte rows
    # the serve path's q: a [B, S, H, D] buffer seen as [B, H, S, D]
    assert tma_ready(_bf16(2, 300, 6, 128).transpose(1, 2))
    assert tma_ready(_bf16(2, 4, 300, 72)[..., :64])  # 144-byte stride
    assert not tma_ready(_bf16(2, 4, 300, 68)[..., :64])  # 136-byte stride
    assert not tma_ready(_bf16(2 * 4 * 300 * 64 + 1)[1:].view(2, 4, 300, 64))
    # a broadcast (stride 0) dimension is no tensor map stride
    assert not tma_ready(_bf16(1, 1, 300, 64).expand(2, 4, 300, 64))
    assert tma_ready(torch.zeros((2, 4, 300, 68))[..., :64])  # f32 272 B


def test_decode_caches_read_in_place_or_copied():
    assert rows_aligned(_bf16(8, 8, 2176, 128))
    assert rows_aligned(_bf16(4, 513, 2, 128).transpose(1, 2))
    assert not rows_aligned(_bf16(4, 2, 300, 68)[..., :64])
    assert rows_aligned(torch.zeros((4, 2, 300, 68))[..., :64])
    assert not rows_aligned(_bf16(2 * 300 * 64 + 1)[1:].view(1, 2, 300, 64))


def test_digest_covers_headers_sources_and_commands(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include "hopper.cuh"\n')
    (tmp_path / "hopper.cuh").write_text("// v1\n")
    srcs = _build._sources()
    assert [s.name for s in srcs] == ["a.cu"]       # headers not compiled
    first = _build._digest(srcs)
    assert _build._digest(srcs) == first
    (tmp_path / "hopper.cuh").write_text("// v2\n")
    second = _build._digest(srcs)
    assert second != first
    (tmp_path / "extra.cuh").write_text("// new header\n")
    third = _build._digest(srcs)
    assert third not in (first, second)
    (tmp_path / "a.cu").write_text('#include "hopper.cuh"\n// edit\n')
    fourth = _build._digest(srcs)
    assert fourth not in (first, second, third)
    monkeypatch.setattr(_build, "LINK_FLAGS", ["-shared", "-lcuda"])
    assert _build._digest(srcs) != fourth
    monkeypatch.setattr(_build, "NVCC_FLAGS", ["-O2"])
    assert _build._digest(srcs) != fourth


def test_build_keeps_the_ptxas_report_lines():
    log = ("ptxas info    : 0 bytes gmem\n"
           "ptxas info    : Compiling entry function '_Z4kern' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z4kern\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers\n"
           "some other nvcc line\n")
    lines = _build._ptxas_lines(log)
    assert len(lines) == 5 and "some other" not in " ".join(lines)
    assert lines[3].startswith("0 bytes stack frame, 0 bytes spill stores")
    assert lines[-1].endswith("Used 168 registers, used 1 barriers")
    assert "-v" in _build.NVCC_FLAGS and "-Xptxas" in _build.NVCC_FLAGS
