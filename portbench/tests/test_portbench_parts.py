"""The harness's arithmetic and plumbing: order statistics and window
rates on hand-made samples, the frozen kernel bounds against the port's
kernel table, the trace reduction, files found by name, and what a run
may import."""
from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from portbench import counts, run, stats
from portbench.trace import Trace
from portbench.tests.tiny import CELLS, SEED

ROOT = run.ROOT


def test_p95_and_window_rate_on_hand_made_samples():
    assert stats.percentile(range(1, 101), 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile([10, 0, 20], 95) == pytest.approx(19.0)
    assert stats.window_rate(4 * 8192 * 3, 6.0) == 16384.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def _brute_keys(sq, skv, window):
    total = 0
    for i in range(sq):
        pos = i + skv - sq
        lo = 0 if window is None else max(0, pos - window + 1)
        total += pos + 1 - lo
    return total


@pytest.mark.parametrize("sq,skv,window", [
    (1, 64, None), (64, 64, None), (64, 64, 7), (100, 130, 64),
    (100, 130, 31), (1, 2304, 4096), (3, 10, 1), (8192, 8192, 4096)])
def test_attended_keys_closed_form(sq, skv, window):
    assert counts.attended_keys(sq, skv, window) == _brute_keys(
        sq, skv, window)


def test_bounds_hold_to_the_kernel_table():
    # h2o-danube prefill, 8 x 6,144, D 80, window 4,096: 1.389846 ms
    ms = counts.bound_s(*counts.flash_fwd(8, 32, 8, 6144, 6144, 80,
                                          4096)) * 1e3
    assert round(ms, 6) == 1.389846
    # mixtral decode, B 8, Hq 32, Hk 8, slots [0, 2,113), D 128: 0.020707 ms
    ms = counts.bound_s(*counts.decode_attn(8, 32, 8, 2113, 128)) * 1e3
    assert round(ms, 6) == 0.020707


def test_model_counts():
    a = run.load(run.HERE / "configs" / "h2o-danube-1.8b.json")["arch"]
    n = a["num_layers"] * counts.layer_matrix_params(a)
    assert n + a["vocab_size"] * a["d_model"] == 1_749_155_840
    assert counts.train_step_flops(a, 4, 8192) == 418_121_106_063_360
    m = run.load(run.HERE / "configs" / "mixtral-8x7b-16of32.json")["arch"]
    assert counts.weight_bytes(m) == pytest.approx(46.96e9, rel=1e-3)


def test_trace_reduction():
    tr = Trace(window_s=10.0, ops=[
        ("gemm", 1.0, 3.0, "prefill"), ("flash_fwd_bf16<>", 2.0, 4.0,
                                        "prefill"),
        ("Memcpy HtoD", 6.0, 6.5, "draw_inputs"), ("gemm", 8.0, 9.0, None)],
        spans=[("prefill", 0.5, 4.9), ("draw_inputs", 5.5, 7.9)])
    assert tr.busy_s() == pytest.approx(4.5)
    assert tr.kernel_s(("flash_fwd",)) == (1, 2.0)
    assert tr.span_ops("prefill") == (2, 4.0)
    assert tr.span_ops("draw_inputs", kernels_only=True) == (0, 0)
    assert tr.top_ops(1) == [["gemm", 3.0]]
    assert tr.idle_gaps(2) == [["host", 2.0], ["draw_inputs", 1.5]]


def test_decode_step_share_and_idle_leave_the_traced_steps_out():
    """The traced steps, slowed by the profiler, give the device's busy
    time a step; the untraced steps after the trace's reduction give the
    step's time."""
    import torch
    from portbench.traffic import decode_pool
    arch = run.load(run.HERE / "configs" / "mixtral-8x7b-16of32.json")[
        "arch"]
    tp = {"batch": 128, "prompt_len": 2048, "wave_tokens": 256}
    ctx = run.Ctx(SEED, torch.device("cpu"), arch, None, tp, True)
    # 4 traced steps of 60 ms, the trace's reduction (5 s), then 10
    # untraced steps of 30 ms
    ends = [0.06 * (i + 1) for i in range(4)]
    resumed = ends[-1] + 5.0
    ends += [resumed + 0.03 * (i + 1) for i in range(10)]
    info = decode_pool.layer_info(ctx, {"ends": ends, "traced": {
        "steps": 4, "decode_launches": 64, "resumed": resumed}})
    assert info["untraced_steps"] == 10
    assert info["untraced_s"] == pytest.approx(0.3)
    bound = sum(counts.bound_s(*counts.decode_step(arch, 128, 2048 + i + 1))
                for i in range(4, 14))
    assert info["untraced_bound_s"] == pytest.approx(bound)
    info["trace"] = Trace(window_s=0.24, ops=[
        ("bmm", 0.06 * i, 0.06 * i + 0.024, "decode_step")
        for i in range(4)])
    assert run.reader("mfu.decode")(info) == pytest.approx(
        100 * bound / 0.3)
    # 24 ms busy a step against 30 ms a step untraced: 20 % idle
    assert run.reader("idle_share.decode")(info) == pytest.approx(20.0)
    assert run.reader("idle_share.train")(info) == pytest.approx(60.0)


def _copy_bench(tmp: pathlib.Path) -> pathlib.Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp


def test_a_cell_and_a_metric_added_as_files_are_found_by_name(tmp_path):
    root = _copy_bench(tmp_path)
    here = root / "portbench"
    (here / "traffic" / "prefill_short.json").write_text(json.dumps({
        "kind": "prefill_pool", "params": {
            "rows": 2, "min_len": 8, "max_len": 16, "cycle": 2,
            "check_waves": 2, "trace_steps": 2}}))
    (here / "workloads" / "danube-prefill-short.json").write_text(
        json.dumps({"limits": {"logits": 0.5}}))
    (here / "metrics" / "waves.prefill.py").write_text(
        "def read(info):\n    return info.get('waves')\n")
    bench = run.load(root / "BENCHMARK.json")
    bench["workloads"].append({"name": "danube-prefill-short",
                               "config": "h2o-danube-1.8b",
                               "traffic": "prefill_short", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].insert(0, {
        "name": "ttft_p95_ms", "unit": "ms", "better": "lower",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["danube-prefill-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = run.run_cell("danube-prefill-short", SEED, 0.2, False,
                             root=root, device="cpu",
                             overrides={"arch": CELLS[
                                 "danube-train-4x8k"]["arch"]})
    assert result["correct"] is True
    assert "ttft_p95_ms" in result["metrics"]
    assert run.reader("waves.prefill", here)({"waves": 3}) == 3


_ISOLATION = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
from portbench import run, control, faults, counts, compare, stats, trace
from portbench.traffic import train, decode_pool, prefill_pool
from portbench.tests.tiny import CELLS, SEED
import pathlib
for p in sorted(pathlib.Path({here!r}, "metrics").glob("*.py")):
    if not p.name.startswith("_"):
        run.reader(p.stem)
for cell, ov in CELLS.items():
    run.run_cell(cell, SEED, 0.2, False, device="cpu", overrides=ov)
print("FORBIDDEN:" + ",".join(run.forbidden_modules()))
"""


def test_a_run_imports_no_jax_and_no_jax_package():
    code = _ISOLATION.format(root=str(ROOT), src=str(ROOT / "src"),
                             here=str(ROOT / "portbench"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "FORBIDDEN:"


def test_the_references_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {!r}); "
            "import portbench.reference.dense, portbench.reference.moe; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('repro_torch', 'repro', 'jax')))"
            ).format(str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "reprolike", sys)
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    found = run.forbidden_modules()
    assert "repro.models" in found and "reprolike" not in found
    assert not any(m.split(".")[0] == "repro_torch" for m in found)


def test_a_checkout_without_the_port_exits_without_a_result(tmp_path):
    root = _copy_bench(tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench.run",
                          "--workload", "danube-prefill-1k-8k", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         cwd=root, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _imported(path: pathlib.Path) -> set:
    import ast
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    (ROOT / "portbench").rglob("*.py")), ids=lambda p: p.name)
def test_no_file_imports_jax_the_jax_package_or_benchmarks(path):
    found = _imported(path) & {"jax", "jaxlib", "flax", "repro",
                               "benchmarks"}
    assert not found, found
    if path.parent.name == "reference":
        assert "repro_torch" not in _imported(path)
