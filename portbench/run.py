"""The port's benchmark entry point.

  python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

run from the root of a checkout that holds the port (``src/repro_torch``)
on a machine with the CUDA devices the cell asks for.  Everything a cell
is made of is found by name: the cell's entry in ``BENCHMARK.json`` names
its configuration (``portbench/configs/<config>.json``: the sizes as run,
read into the port's ``ArchConfig``) and its traffic mix
(``portbench/traffic/<traffic>.json``: a ``kind`` and its parameters,
run by ``portbench/traffic/<kind>.py``); ``portbench/workloads/<cell>.json``
holds the limits its outputs are held to; each per-layer metric is read by
``portbench/metrics/<metric>.py``.

A run sets up (imports, the kernel library built or loaded under
``build/`` in the checkout, weights and inputs made on the device from the
seed, the traffic's own set-up and warm-up), measures for ``--seconds``,
reads the peak memory, frees the program's state and holds what the
window produced against the plain reference.  With ``--trace 1`` the
first units of the window run under ``torch.profiler`` and the line
carries the per-layer metrics and the trace's breakdown; with ``--trace
0`` the end-to-end metrics.  The last line of standard output is the
result; an earlier line gives the set-up's parts.  The numbers compared
and their limits end standard error and the result."""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env(root: pathlib.Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = root / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def load(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str, here: pathlib.Path = HERE):
    """The per-layer metric ``name``'s ``read`` from its own file."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Ctx:
    """What a traffic kind is given: the seed, the device, the sizes as
    run (``arch``, and the port's ``cfg``), the mix's parameters, the
    tracer, and the set-up clock."""

    def __init__(self, seed, dev, arch, cfg, tp, trace):
        import torch
        from portbench.trace import Tracer
        self.seed, self.dev, self.arch, self.cfg = seed, dev, arch, cfg
        self.tp, self.trace = tp, trace
        self.tracer = Tracer(trace and dev.type == "cuda")
        self.parts: dict = {}
        self._torch = torch

    @contextlib.contextmanager
    def part(self, name: str):
        t = time.perf_counter()
        yield
        self.sync()
        self.parts[name] = self.parts.get(name, 0.0) + (
            time.perf_counter() - t)

    def sync(self) -> None:
        if self.dev.type == "cuda":
            self._torch.cuda.synchronize(self.dev)

    def free(self) -> None:
        gc.collect()
        if self.dev.type == "cuda":
            self._torch.cuda.empty_cache()

    def same_tree(self, params: dict) -> None:
        """The benchmark's tree must be the one the port's entry points
        take."""
        from portbench.weights import tree_shapes
        from repro_torch.models import get_model
        want = get_model(self.cfg).param_shapes(self.cfg)
        if tree_shapes(params) != want:
            raise RuntimeError(f"the benchmark's parameter tree "
                               f"{tree_shapes(params)} is not the port's "
                               f"{want}")


def host_use(before, after) -> dict:
    """The process's CPU seconds and context switches over the window:
    how far the host, which paces a dispatch-bound step, was shared."""
    return {"cpu_s": (after.ru_utime + after.ru_stime)
            - (before.ru_utime + before.ru_stime),
            "involuntary_switches": after.ru_nivcsw - before.ru_nivcsw,
            "voluntary_switches": after.ru_nvcsw - before.ru_nvcsw,
            "load_avg": os.getloadavg()[0]}


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def wanted(bench: dict, cell: dict, section: str) -> list[dict]:
    """The metrics of ``section`` that ``cell`` reports: those that list
    it, and the end-to-end ones that list no cell (``setup_s``)."""
    return [m for m in bench[section]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             root: pathlib.Path = ROOT, device: str = "cuda",
             overrides: dict | None = None, fault: str | None = None,
             control: bool = False, readings: bool = False
             ) -> tuple[dict, dict]:
    """One run of cell ``name``.  Returns (result, set-up parts).
    ``overrides`` ({"arch": ..., "traffic": ..., "limits": ...}) replaces
    entries of the cell's files, for tests at a small size; ``fault``
    plants one of ``faults.NAMES`` under the set-up and the window;
    ``control`` adds the float8 reference's numbers (``result["fp8"]``)
    and ``readings`` every number the check computed, limited or not
    (``result["readings"]``).  The benchmark's own runs take none."""
    overrides = overrides or {}
    here = root / "portbench"
    bench = load(root / "BENCHMARK.json")
    cell = cell_of(bench, name)
    conf = load(here / "configs" / f"{cell['config']}.json")
    mix = load(here / "traffic" / f"{cell['traffic']}.json")
    limits = load(here / "workloads" / f"{name}.json")["limits"]
    arch = conf["arch"] | overrides.get("arch", {})
    tp = mix["params"] | overrides.get("traffic", {})
    limits = limits | overrides.get("limits", {})
    if str(root / "src") not in sys.path:
        sys.path.insert(0, str(root / "src"))
    cache_env(root)
    import torch
    from portbench import compare, faults
    from repro_torch.models.config import ArchConfig
    kind = importlib.import_module(f"portbench.traffic.{mix['kind']}")
    dev = torch.device(device)
    ctx = Ctx(seed, dev, arch, ArchConfig(**arch), tp, trace)
    ctx.parts["import"] = time.perf_counter() - T0
    if dev.type == "cuda":
        with ctx.part("build"):
            from repro_torch.kernels import _build
            _build.library()
        torch.cuda.reset_peak_memory_stats(dev)
    with faults.planted(fault):
        state = kind.setup(ctx)
        ctx.sync()
        setup_s = time.perf_counter() - T0
        use = resource.getrusage(resource.RUSAGE_SELF)
        samples = kind.window(ctx, state, seconds)
        ctx.sync()
        host = host_use(use, resource.getrusage(resource.RUSAGE_SELF))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    t_check = time.perf_counter()
    numbers = kind.check(ctx, state, samples, control)
    ctx.parts_after = {"check_s": time.perf_counter() - t_check,
                       "window_s": samples["ends"][-1],
                       "units": len(samples["ends"]), "host": host}
    held = compare.hold(numbers["program"], limits)
    attempted, failed = kind.attempted(samples)
    e2e = kind.end_to_end(ctx, samples) | {"setup_s": setup_s}
    e2e_names = [m["name"] for m in wanted(bench, cell, "end_to_end")]
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": compare.passed(held) and failed == 0,
              "attempted": attempted, "failed": failed}
    if trace and ctx.tracer.trace is not None:
        tr = ctx.tracer.trace
        info = kind.layer_info(ctx, samples) | {"trace": tr,
                                               "window_s": tr.window_s}
        ctx.parts_after["layer_info"] = {
            k: v for k, v in info.items() if isinstance(v, (int, float))}
        metrics = {}
        for m in wanted(bench, cell, "per_layer"):
            value = reader(m["name"], here)(info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info |= {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        result |= {"metrics": metrics, "device": device_info,
                   "breakdown": {"device_ops": tr.top_ops(),
                                 "idle_gaps": tr.idle_gaps()}}
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        result |= {"metrics": {n: {"value": e2e[n], "unit": units[n]}
                               for n in e2e_names},
                   "device": device_info}
    if control:
        result["fp8"] = numbers["fp8"]
    if readings:
        result["readings"] = numbers["program"]
    result["compared"] = held
    parts = dict(ctx.parts)
    parts["other"] = setup_s - sum(parts.values())
    return result, parts | {"after": ctx.parts_after}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no port under {ROOT / 'src'}: nothing to measure",
              file=sys.stderr)
        return 2
    bench = load(ROOT / "BENCHMARK.json")
    chips = cell_of(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    result, parts = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    emit(result, parts)
    return 0


def emit(result: dict, parts: dict) -> None:
    """The set-up's parts, then the numbers compared as the last lines of
    standard error, then the result as the last line of standard output
    (its ``compared`` key last)."""
    print(json.dumps({"setup_parts": parts}), flush=True)
    for k, (value, limit) in result["compared"].items():
        print(f"compared {k}: {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
