"""Host-side plans of the port's CUDA kernels, on the CPU: the probe's
route and grid, the decode kernel's split plan, the flash and decode
wrappers' decisions to copy an operand the copies cannot read in place,
and the kernel build's hash and compiler report.  No GPU needed: the
kernels themselves run only on a card (``test_torch_cuda``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attn.kernel import (  # noqa: E402
    BLOCKS_PER_SM, MMA_BLOCKS_PER_SM, MMA_FILL, MMA_HEADS, MMA_MAX_SPLITS,
    MMA_MAX_WALK, MMA_MIN_CHUNK, TILE, decode_plan, max_heads, rows_aligned,
    split_plan, sub_groups)
from repro_torch.kernels.flash_attn.kernel import tma_ready  # noqa: E402
from repro_torch.kernels.sorted_probe.kernel import (  # noqa: E402
    INDEXED_QUERIES, THREADS, probe_blocks, probe_plan)


def _served(n: int, lanes: int, blocks: int) -> np.ndarray:
    """How many times the kernel's index map serves each query: thread x
    of the grid serves query x // L as lane x % L, and lane 0 writes."""
    x = np.arange(blocks * THREADS)
    q = x[(x % lanes == 0) & (x // lanes < n)] // lanes
    return np.bincount(q, minlength=n)


@settings(max_examples=400, deadline=None)
@given(n=st.integers(1, 20_000), t=st.integers(0, 3_000_000))
def test_probe_plan_serves_every_query_once(n, t):
    lanes, blocks = probe_plan(n, t)
    assert lanes in (1, 32) and blocks == probe_blocks(n, lanes)
    assert np.array_equal(_served(n, lanes, blocks), np.ones(n, np.int64))
    # no block is idle: the last one holds a query
    assert (blocks - 1) * THREADS < n * lanes <= blocks * THREADS


@settings(max_examples=400, deadline=None)
@given(n=st.integers(1, 4_000_000), t=st.integers(0, 2**31 - 1))
def test_probe_plan_route(n, t):
    lanes, _ = probe_plan(n, t)
    # a thread per query for large batches into a table of any entries,
    # a warp per query otherwise
    assert (lanes == 1) == (n >= INDEXED_QUERIES and t > 0)


def test_probe_plan_at_the_census_shapes():
    # (N, T) medians of a q8_justin episode's five call sites
    assert probe_plan(466, 465) == (32, 59)             # inverse map
    assert probe_plan(2_829, 41_126) == (32, 354)       # packed memtable
    assert probe_plan(276, 266_800) == (32, 35)         # lsm._probe_run
    assert probe_plan(12_504, 8_081) == (1, 49)         # merge_delta_runs
    assert probe_plan(4, 60_000) == (32, 1)             # _partition_bounds
    # the main shape: 65,536 queries into 2.4 M entries
    assert probe_plan(65_536, 2_400_000) == (1, 256)
    assert probe_plan(5, 0) == (32, 1)                  # empty table


@settings(max_examples=300, deadline=None)
@given(batch=st.integers(1, 64), kv_heads=st.integers(1, 16),
       slots=st.integers(1, 40_000), sms=st.integers(1, 200),
       n_sub=st.integers(1, 4))
def test_split_plan_cuts_the_cache_once(batch, kv_heads, slots, sms, n_sub):
    chunk, n_splits = split_plan(batch, kv_heads, slots, sms, n_sub)
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
    # head, sub-group) triples alone do not
    blocks = batch * kv_heads * n_sub
    assert blocks * n_splits <= max(BLOCKS_PER_SM * sms, blocks)


def test_split_plan_at_the_serve_shape():
    # 8 requests x 8 KV heads over a 2,176-slot cache on 132 SMs: four
    # splits of 576 slots, 256 blocks for 264 resident slots
    assert split_plan(8, 8, 2176, 132) == (576, 4)
    # enough (b, KV head) pairs to fill the card: one split
    assert split_plan(32, 8, 2176, 132) == (2176, 1)
    assert split_plan(8, 8, 7, 132) == (64, 1)
    # recurrentgemma's decode: 8 requests x 1 KV head x 3 sub-groups over
    # the window's 2,048 slots, 11 splits of 192: 264 blocks, one wave
    assert split_plan(8, 1, 2048, 132, sub_groups(10, 256)) == (192, 11)


@pytest.mark.parametrize("group", range(1, 41))
@pytest.mark.parametrize("d", [64, 128, 256])
def test_sub_groups_cover_the_group(group, d):
    """A group is cut into sub-groups of ceil(group / n) q-heads, at most
    ``max_heads(d)`` each (the kernel's per-head registers), none empty:
    the blocks of one KV head serve each of its q-heads once."""
    n = sub_groups(group, d)
    heads = -(-group // n)
    assert heads <= max_heads(d) and (n - 1) * heads < group
    assert n == -(-group // max_heads(d))
    served = [h for sub in range(n)
              for h in range(sub * heads, min(group, (sub + 1) * heads))]
    assert served == list(range(group))
    assert (sub_groups(10, 256), sub_groups(10, 128), sub_groups(8, 128),
            sub_groups(16, 256), sub_groups(1, 256)) == (3, 2, 1, 4, 1)


# (label, batch, q-heads, KV heads, head dim, slots attended): each served
# model's decode step as chip_smoke.py phases 5, 7, 8 and 9 serve it, the
# decode cells of phase 11 (c), and the ranks' shapes of phases 13 (b),
# 14 (b) and 16 (b)
DECODE_SHAPES = (
    ("llama3.2-3b", 8, 24, 8, 128, 2113),
    ("h2o-danube-1.8b, window 4,096", 8, 32, 8, 80, 4096),
    ("mixtral-8x7b", 8, 32, 8, 128, 2113),
    ("llama4-maverick, chunk 8,192", 2, 40, 8, 128, 2112),
    ("internvl2-26b", 8, 48, 8, 128, 2112),
    ("whisper-medium self", 8, 16, 16, 64, 448),
    ("whisper-medium cross", 8, 16, 16, 64, 1500),
    ("recurrentgemma-2b, window 2,048", 8, 10, 1, 256, 2048),
    ("h2o-danube-1.8b decode_32k", 128, 32, 8, 80, 4096),
    ("h2o-danube-1.8b long_500k", 1, 32, 8, 80, 4096),
    ("recurrentgemma-2b decode_32k", 128, 10, 1, 256, 2048),
    ("recurrentgemma-2b long_500k", 1, 10, 1, 256, 2048),
    ("mixtral-8x7b on a rank", 8, 32, 8, 128, 514),
    ("llama3.2-3b on a rank", 4, 6, 2, 128, 516),
    ("whisper-medium cross on a rank", 4, 4, 4, 64, 1500),
    ("recurrentgemma-2b on a rank", 4, 3, 1, 256, 514),
)


@pytest.mark.parametrize("label,batch,hq,hk,d,span", DECODE_SHAPES,
                         ids=[c[0] for c in DECODE_SHAPES])
def test_decode_plan_at_the_served_shapes(label, batch, hq, hk, d, span):
    """bf16 takes the tensor cores with one block per (b, KV head, split)
    serving the whole group, at the blocks an SM that its instantiation
    gets (``test_torch_cuda`` holds them to the card's occupancy), and no
    shape plans a second wave of blocks."""
    sms = 132
    plan = decode_plan(torch.bfloat16, batch, hq, hk, d, span, sms)
    width = 64 if d <= 64 else 128 if d <= 128 else 256
    assert plan.route == "mma" and plan.row_tiles == 1
    assert (plan.heads, plan.n_sub) == (hq // hk, 1)
    assert plan.blocks_per_sm == MMA_BLOCKS_PER_SM[width]
    assert plan.chunk % TILE == 0 and plan.n_splits * plan.chunk >= span
    assert plan.n_splits <= MMA_MAX_SPLITS[width]
    blocks = batch * hk * plan.n_sub
    assert blocks * plan.n_splits <= max(plan.blocks_per_sm * sms, blocks)


def test_decode_plan_cuts_at_the_serve_and_cell_shapes():
    # llama's 64 (b, KV head) pairs fill half the card: one split, each
    # block walking 1.08 MB; h2o-danube's 1.31 MB a block: two splits
    assert decode_plan(torch.bfloat16, 8, 24, 8, 128, 2113,
                       132)[-2:] == (2176, 1)
    assert decode_plan(torch.bfloat16, 8, 32, 8, 80, 4096,
                       132)[-2:] == (2048, 2)
    # a rank's 8 pairs of llama over 516 slots: splits of 4 tiles
    assert decode_plan(torch.bfloat16, 4, 6, 2, 128, 516,
                       132)[-2:] == (192, 3)
    # recurrentgemma's whole group of 10 at D 256, one block an SM: a
    # batch of 8 in splits of 4 tiles, a batch of one likewise, a batch of
    # 128 in one split (the old route cut it into 3 sub-groups)
    assert decode_plan(torch.bfloat16, 8, 10, 1, 256, 2048,
                       132)[-2:] == (256, 8)
    assert decode_plan(torch.bfloat16, 1, 10, 1, 256, 2048,
                       132)[-2:] == (256, 8)
    assert decode_plan(torch.bfloat16, 128, 10, 1, 256, 2048,
                       132)[-2:] == (2048, 1)
    # h2o-danube's batch of one: 8 KV heads x 16 splits of 256 slots
    assert decode_plan(torch.bfloat16, 1, 32, 8, 80, 4096,
                       132)[-2:] == (256, 16)


@settings(max_examples=300, deadline=None)
@given(batch=st.integers(1, 64), hk=st.integers(1, 16),
       group=st.integers(1, 40), d=st.sampled_from([16, 64, 80, 128, 256]),
       span=st.integers(1, 40_000), sms=st.integers(1, 200))
def test_decode_plan_cuts_the_span_once(batch, hk, group, d, span, sms):
    """Any bf16 shape: a group of up to 16 a block, above that ceil(G /
    16) sub-groups of at most 16, none empty; splits of whole tiles that
    cover the span, of at least MMA_MIN_CHUNK slots where the span has
    them, at most MMA_MAX_SPLITS, one wave unless the (b, KV head,
    sub-group) blocks alone are more."""
    plan = decode_plan(torch.bfloat16, batch, hk * group, hk, d, span, sms)
    width = 64 if d <= 64 else 128 if d <= 128 else 256
    assert plan.n_sub == -(-group // MMA_HEADS)
    assert plan.heads <= MMA_HEADS and (plan.n_sub - 1) * plan.heads < group
    assert plan.chunk % TILE == 0 and plan.n_splits * plan.chunk >= span
    assert (plan.n_splits - 1) * plan.chunk < span
    assert plan.n_splits == 1 or plan.chunk >= MMA_MIN_CHUNK
    if batch * hk * plan.n_sub * MMA_FILL >= sms and plan.n_splits > 1:
        # a card the blocks fill: no split shorter than a walk needs
        assert (plan.n_splits - 1) * MMA_MAX_WALK < span * d * 4
    assert 1 <= plan.n_splits <= MMA_MAX_SPLITS[width]
    blocks = batch * hk * plan.n_sub
    assert blocks * plan.n_splits <= max(plan.blocks_per_sm * sms, blocks)


@pytest.mark.parametrize("group", [1, 3, 5, 10, 16, 17, 40])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_decode_plan_float32_keeps_its_sub_groups(group, d):
    """float32 stays on the CUDA cores, cut into ``sub_groups`` and
    ``split_plan`` as before."""
    plan = decode_plan(torch.float32, 8, 2 * group, 2, d, 2113, 132)
    n_sub = sub_groups(group, d)
    assert (plan.route, plan.n_sub, plan.row_tiles) == ("cuda_core", n_sub,
                                                         0)
    assert (plan.chunk, plan.n_splits) == split_plan(8, 2, 2113, 132, n_sub)
    assert plan.heads == -(-group // n_sub) <= max_heads(d)
    assert plan.blocks_per_sm == BLOCKS_PER_SM


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
