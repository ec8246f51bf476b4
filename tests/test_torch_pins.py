"""The pinned answers of ``chip_smoke.py``'s scenario phase.

``tests/data/torch_scenarios.json`` holds the reference package's answers
to the phase's runs: (a) q8 justin vs threshold under a savepoint cost
model, (b) q11 under a spike with a straggler and a killed task, (c) the
ds2/justin q11 pair on one shared-TM cluster under preemption, (d) sampled
fleets of 32 tenants x 6 windows and 128 x 20.  ``chip_smoke.py`` imports
nothing of the reference, so the card holds the port against this file.

Here the same run functions (``chip_smoke.run_*``) run over the reference
and over the port on the CPU; both must reproduce the pin exactly (every
field of every history row, the admission outcomes, the usage series).
The q8 runs (about 70 s for both packages on one CPU) and the 128-tenant
fleet (about 15 s) would take this file past a minute, so they are
marked ``slow``; the card checks them on every ``chip_smoke.py`` run,
and ``-m ""`` runs them here.

Write the file from the reference with

    PYTHONPATH=src python tests/test_torch_pins.py --write

``tests/data/torch_serve.json`` holds the reference's answers to phase 7
(a), ``JustinServeController.autoscale()`` under ds2, justin and threshold
(``chip_smoke.run_serve_controller``), checked here for both packages and
written with ``--write-serve`` (a few seconds).

``tests/data/torch_train.json`` holds the reference's losses for phase 10
(c): every reduced configuration's 3 training steps (AdamW, lr 1e-3) from
the numpy inputs ``chip_smoke.train_pin_inputs`` makes, run by the
reference's jitted ``make_train_step``; the port on the CPU (here) and on
the card (``chip_smoke.run_train_pin``) must land within
``chip_smoke.TRAIN_PIN_TOL`` of them.  Written with ``--write-train`` (about a
minute).
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """These runs are many small tensor ops on the CPU: one intra-op
    thread runs them faster than a pool, and keeps parallel test workers
    from oversubscribing the cores with spinning pool threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = {"device": "cpu"}


def reference_api():
    """The reference's entry points under the names ``chip_smoke``'s run
    functions use (its ``port_api`` gives the port's)."""
    from repro.core.controller import AutoScaler, ControllerConfig
    from repro.core.justin import JustinParams
    from repro.core.policy import make_policy
    from repro.data.nexmark import QUERIES, TARGET_RATES
    from repro.migration import CostModel, MigrationRuntime
    from repro.obs import Tracer, write_jsonl
    from repro.scenarios import (KillTask, SetStraggler, fleet_stats,
                                 run_colocation, run_fleet, run_scenario)
    from repro.scenarios import cluster
    from repro.scenarios.runner import scenario_horizon_s
    from repro.streaming.engine import StreamEngine
    return SimpleNamespace(**locals())


def compute(key: str, api, dev: dict, driver: str = "vectorized",
            trace_path=None):
    if key == "a_savepoint":
        return chip_smoke.run_savepoint(api, dev)
    if key == "b_faults":
        return chip_smoke.run_faults(api, dev, trace_path)
    if key == "c_colocation":
        return chip_smoke.run_colocation_pair(api, dev, driver)
    return chip_smoke.run_fleet_case(api, dev, key, driver)[0]


def write_pins() -> None:
    api, dev = reference_api(), {}
    pins = {"_meta": {
        "written_by": "PYTHONPATH=src python tests/test_torch_pins.py "
                      "--write (the reference package, on the CPU)",
        "row_fields": list(chip_smoke.ROW_FIELDS),
        "seed": 3, "max_level": 2,
        "fleets": chip_smoke.FLEETS}}
    for key in ("a_savepoint", "b_faults", "c_colocation",
                *chip_smoke.FLEETS):
        pins[key] = compute(key, api, dev)
        print(key, "written", flush=True)
    chip_smoke.PINS.write_text(json.dumps(pins, separators=(",", ":"))
                               + "\n")


PINS = json.loads(chip_smoke.PINS.read_text()) \
    if chip_smoke.PINS.exists() else {}
SLOW = pytest.mark.slow
RUNS = [pytest.param("a_savepoint", marks=SLOW), "b_faults",
        "c_colocation", "d_fleet_32",
        pytest.param("d_fleet_128", marks=SLOW)]


def test_pin_file_covers_every_run():
    assert set(PINS) == {"_meta", "a_savepoint", "b_faults",
                         "c_colocation", *chip_smoke.FLEETS}
    assert PINS["_meta"]["row_fields"] == list(chip_smoke.ROW_FIELDS)
    # raises unless the reference's headline holds in the pinned run
    got = chip_smoke.check_savepoint(PINS["a_savepoint"])
    assert (got["justin"]["steps"], got["threshold"]["steps"]) == (3, 4)


@pytest.mark.parametrize("key", RUNS)
def test_reference_reproduces_pin(key):
    chip_smoke.hold(key, compute(key, reference_api(), {}), PINS[key])


@pytest.mark.parametrize("key", RUNS)
def test_port_on_cpu_reproduces_pin(key, tmp_path):
    """The port on ``device="cpu"``; (c) and the fleets under both of
    their drivers, (b) with its trace checked by ``tools/check_trace.py``
    as the card's run checks it."""
    api, dev = chip_smoke.port_api(), CPU
    if key == "b_faults":
        trace = tmp_path / "b.jsonl"
        chip_smoke.hold(key, compute(key, api, dev, trace_path=trace),
                        PINS[key])
        out = subprocess.run([sys.executable,
                              str(ROOT / "tools" / "check_trace.py"),
                              str(trace)], capture_output=True, text=True)
        assert out.returncode == 0, out.stdout + out.stderr
        return
    drivers = ("vectorized", "scalar") if key == "c_colocation" \
        else chip_smoke.FLEETS.get(key, {}).get("drivers", ("vectorized",))
    for driver in drivers:
        chip_smoke.hold(f"{key} ({driver})",
                        compute(key, api, dev, driver), PINS[key])


# ------------------------------------------------ phase 7 (a): serve control
def write_serve_pins() -> None:
    api = chip_smoke.serve_api("repro")
    pins = {"_meta": {
        "written_by": "PYTHONPATH=src python tests/test_torch_pins.py "
                      "--write-serve (the reference package, on the CPU)",
        "serve_ctl": chip_smoke.SERVE_CTL}}
    for policy in chip_smoke.SERVE_POLICIES:
        pins[policy] = chip_smoke.run_serve_controller(api, policy)
    chip_smoke.SERVE_PINS.write_text(json.dumps(pins, separators=(",", ":"))
                                     + "\n")


SERVE_PINS = json.loads(chip_smoke.SERVE_PINS.read_text()) \
    if chip_smoke.SERVE_PINS.exists() else {}


def test_serve_pin_file_covers_every_policy():
    assert set(SERVE_PINS) == {"_meta", *chip_smoke.SERVE_POLICIES}
    assert SERVE_PINS["_meta"]["serve_ctl"] == chip_smoke.SERVE_CTL
    # the workload is one at which every policy steps and Justin also
    # scales the page budget up
    for policy in chip_smoke.SERVE_POLICIES:
        rec = SERVE_PINS[policy]
        assert rec["history"][0]["busyness"] > 0.8 and rec["steps"] >= 1
    assert SERVE_PINS["justin"]["level"] >= 1


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
@pytest.mark.parametrize("policy", ["ds2", "justin", "threshold"])
def test_serve_controller_reproduces_pin(package, policy):
    chip_smoke.hold(f"{package} {policy}", chip_smoke.run_serve_controller(
        chip_smoke.serve_api(package), policy), SERVE_PINS[policy])


# ------------------------------------------------- phase 10 (c): training
def run_reference_train_pin(arch: str) -> dict:
    """The reference's jitted ``make_train_step`` on ``arch``'s reduced
    config for the pinned steps from ``chip_smoke.train_pin_inputs``
    (parameters in the config's param dtype): {"losses": [...]}."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import cpu_mesh_ctx
    from repro.train.optimizer import AdamWConfig, init_opt_state
    from repro.train.train_step import make_train_step
    from repro_torch.configs import get_config
    cfg = jax_get_config(arch).reduced()
    np_params, batches = chip_smoke.train_pin_inputs(
        get_config(arch).reduced())
    params = jax.tree.map(lambda a: jnp.asarray(a, cfg.param_dtype),
                          np_params)
    ocfg = AdamWConfig(lr=chip_smoke.TRAIN_PIN["lr"],
                       opt_dtype=cfg.opt_dtype)
    opt = init_opt_state(params, ocfg)
    step = jax.jit(make_train_step(cfg, cpu_mesh_ctx(), ocfg))
    losses = []
    for bt in batches:
        params, opt, m = step(params, opt,
                              {k: jnp.asarray(v) for k, v in bt.items()})
        losses.append(float(m["loss"]))
    return {"losses": losses}


def write_train_pins() -> None:
    from repro_torch.configs import list_archs
    pins = {"_meta": {
        "written_by": "PYTHONPATH=src python tests/test_torch_pins.py "
                      "--write-train (the reference package, on the CPU)",
        "train_pin": chip_smoke.TRAIN_PIN}}
    for arch in list_archs():
        pins[arch] = run_reference_train_pin(arch)
        print(arch, pins[arch], flush=True)
    chip_smoke.TRAIN_PINS.write_text(json.dumps(pins, indent=1) + "\n")


TRAIN_PINS = json.loads(chip_smoke.TRAIN_PINS.read_text()) \
    if chip_smoke.TRAIN_PINS.exists() else {}
ARCHS = ["whisper-medium", "llama4-maverick-400b-a17b", "mixtral-8x7b",
         "llama3.2-3b", "internlm2-20b", "h2o-danube-1.8b", "minitron-4b",
         "internvl2-26b", "mamba2-130m", "recurrentgemma-2b"]


def test_train_pin_file_covers_every_arch():
    from repro_torch.configs import list_archs
    assert sorted(list_archs()) == sorted(ARCHS)
    assert set(TRAIN_PINS) == {"_meta", *ARCHS}
    assert TRAIN_PINS["_meta"]["train_pin"] == chip_smoke.TRAIN_PIN


def test_reference_reproduces_train_pin():
    """The recipe the pin was written with still gives it (one
    configuration: the reference's jit takes seconds each)."""
    assert run_reference_train_pin("llama3.2-3b") == \
        TRAIN_PINS["llama3.2-3b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_port_on_cpu_trains_to_pin(arch):
    got = chip_smoke.run_train_pin(torch, arch, "cpu")
    chip_smoke.hold_losses(arch, got["losses"], TRAIN_PINS[arch]["losses"])


# --------------------------------- specs and bytes on the production meshes
# The reference builds its 16x16 and 2x16x16 meshes only over 256 / 512
# devices, which JAX forces on the host only before it starts: so one
# subprocess computes, for each architecture, every param, optimizer-state,
# cache (at each applicable shape's seq_len and batch, with the dp axes
# dropped where the batch does not divide them) and batch spec with its
# per-device shard shape on both meshes, and each cell's per-device
# argument and output bytes on 1x1, 16x16 and 2x16x16 (the sums over the
# reference's trees: the outputs' shapes from ``jax.eval_shape`` of its
# prefill and decode steps; a train step returns the donated parameters and
# moments and two float32 scalars, the reference dry-run's out_shardings).
SPEC_MESHES = ("16x16", "2x16x16")
BYTE_MESHES = ("1x1",) + SPEC_MESHES
# one configuration per family, regenerated in tier-1
SPEC_FAMILIES = ("h2o-danube-1.8b", "mixtral-8x7b", "internvl2-26b",
                 "whisper-medium", "mamba2-130m", "recurrentgemma-2b")
_SPEC_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, math, sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import applicable_shapes, get_config, get_shape
from repro.launch.mesh import make_production_mesh
from repro.models.model import (abstract_batch, abstract_cache,
                                abstract_params, batch_specs, drop_dp_axes,
                                get_model)
from repro.models.sharding import MeshCtx
from repro.train.optimizer import opt_state_specs
from repro.train.train_step import make_prefill_step, make_serve_step

MESHES = {"1x1": MeshCtx(Mesh(np.array([[jax.devices()[0]]]),
                              ("data", "model"))),
          "16x16": MeshCtx(make_production_mesh()),
          "2x16x16": MeshCtx(make_production_mesh(multi_pod=True))}
is_spec = lambda x: isinstance(x, P)


def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def flat(tree, leaf=is_spec):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)[0]}


def laid_out(shapes, specs, mctx):
    sh = flat(shapes, lambda x: hasattr(x, "shape"))
    return {k: [enc(sp), list(mctx.sharding(sp).shard_shape(sh[k].shape))]
            for k, sp in flat(specs).items()}


def nbytes(shapes, specs, mctx):
    sh = flat(shapes, lambda x: hasattr(x, "shape"))
    return sum(math.prod(mctx.sharding(sp).shard_shape(sh[k].shape))
               * jnp.dtype(sh[k].dtype).itemsize
               for k, sp in flat(specs).items())


def cell_trees(cfg, shape):
    # (arguments, outputs): the step's abstract trees, unsharded
    params = abstract_params(cfg)
    batch = abstract_batch(cfg, shape)
    if shape.kind == "train":
        opt = {"m": jax.tree.map(
                   lambda a: jax.ShapeDtypeStruct(a.shape, cfg.opt_dtype),
                   params), "step": jax.ShapeDtypeStruct((), jnp.int32)}
        opt["v"] = opt["m"]
        scalars = {"loss": jax.ShapeDtypeStruct((), jnp.float32),
                   "grad_norm": jax.ShapeDtypeStruct((), jnp.float32)}
        return (params, opt, batch), (params, opt, scalars)
    mctx = MESHES["1x1"]
    if shape.kind == "prefill":
        return (params, batch), jax.eval_shape(
            make_prefill_step(cfg, mctx), params, batch)
    caches = abstract_cache(cfg, shape)
    return (params, caches, batch), jax.eval_shape(
        make_serve_step(cfg, mctx), params, caches, batch["tokens"],
        jax.ShapeDtypeStruct((), jnp.int32))


def cell_bytes(cfg, shape, trees, mctx):
    # per-device [argument, output] bytes of one cell on mctx
    model = get_model(cfg)
    pspecs = model.param_specs(cfg, mctx)
    bspecs = batch_specs(cfg, shape, mctx)
    (args, outs) = trees
    if shape.kind == "train":
        ospecs = opt_state_specs(pspecs)
        mspecs = {"loss": P(), "grad_norm": P()}
        return [nbytes(args, (pspecs, ospecs, bspecs), mctx),
                nbytes(outs, (pspecs, ospecs, mspecs), mctx)]
    dp_ok = shape.global_batch % mctx.dp_size == 0
    cspecs = model.cache_specs(cfg, mctx, shape.seq_len)
    if not dp_ok:
        cspecs = drop_dp_axes(cspecs, mctx)
    lspec = P(mctx.dp if dp_ok else None, "model")
    in_specs = (pspecs, bspecs) if shape.kind == "prefill" \
        else (pspecs, cspecs, bspecs)
    return [nbytes(args, in_specs, mctx),
            nbytes(outs, (lspec, cspecs), mctx)]


def arch_pins(arch):
    cfg = get_config(arch)
    model = get_model(cfg)
    shapes = applicable_shapes(cfg)
    out = {"bytes": {m: {} for m in MESHES}}
    for name in ("16x16", "2x16x16"):
        mctx = MESHES[name]
        params = abstract_params(cfg)
        pspecs = model.param_specs(cfg, mctx)
        opt = {"m": params, "v": params,
               "step": jax.ShapeDtypeStruct((), jnp.int32)}
        rec = {"params": laid_out(params, pspecs, mctx),
               "opt": laid_out(opt, opt_state_specs(pspecs), mctx),
               "cache": {}, "batch": {}}
        for sh in shapes:
            shape = get_shape(sh)
            cspecs = model.cache_specs(cfg, mctx, shape.seq_len)
            if shape.global_batch % mctx.dp_size:
                cspecs = drop_dp_axes(cspecs, mctx)
            rec["cache"][sh] = laid_out(
                abstract_cache(cfg, shape), cspecs, mctx)
            rec["batch"][sh] = laid_out(
                abstract_batch(cfg, shape), batch_specs(cfg, shape, mctx),
                mctx)
        out[name] = rec
    for sh in shapes:
        trees = cell_trees(cfg, get_shape(sh))
        for name, mctx in MESHES.items():
            out["bytes"][name][sh] = cell_bytes(cfg, get_shape(sh), trees,
                                                mctx)
    return out


print(json.dumps({arch: arch_pins(arch) for arch in sys.argv[1:]}))
"""


def spec_pins(archs) -> dict:
    """The reference's layouts and cell bytes of ``archs``, from one
    subprocess with 512 forced host devices."""
    out = subprocess.run([sys.executable, "-c", _SPEC_SCRIPT, *archs],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": "src",
                                        "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


def write_spec_pins() -> None:
    from repro_torch.configs import list_archs
    pins = {"_meta": {
        "written_by": "PYTHONPATH=src python tests/test_torch_pins.py "
                      "--write-specs (the reference package, on the CPU, "
                      "512 forced host devices)",
        "meshes": list(SPEC_MESHES), "byte_meshes": list(BYTE_MESHES)},
        **spec_pins(list_archs())}
    SPEC_PINS.write_text(json.dumps(pins, separators=(",", ":")) + "\n")


SPEC_PINS = ROOT / "tests" / "data" / "torch_specs.json"


def test_reference_reproduces_spec_pins():
    """One configuration per family, regenerated, equals the file."""
    pins = json.loads(SPEC_PINS.read_text())
    got = spec_pins(SPEC_FAMILIES)
    for arch in SPEC_FAMILIES:
        assert got[arch] == pins[arch], arch


if __name__ == "__main__":
    writers = {"--write": write_pins, "--write-serve": write_serve_pins,
               "--write-train": write_train_pins,
               "--write-specs": write_spec_pins}
    if len(sys.argv) != 2 or sys.argv[1] not in writers:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_pins.py "
                 "--write | --write-serve | --write-train | --write-specs")
    writers[sys.argv[1]]()
