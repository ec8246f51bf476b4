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

``tests/data/torch_mesh.json`` holds the reference's answers to the MoE
block on 8 devices (``torch_mesh_cases``: ``moe_ffn`` in every mode on
2x4 and 2x2x2, the reduced decoders' prefill and decode on 2x4), which
``test_torch_mesh.py`` holds the port to on 8 gloo ranks and
``chip_smoke.py``'s phase 13 (a) on the card.  Written with
``--write-mesh`` (about 40 s); the ``slow`` test regenerates it.

``tests/data/torch_sharded.json`` holds the reference's answers to the
decoder's sharded prefill and decode steps on 8 devices
(``torch_sharded_cases``: dense, windowed, MoE in each mode and VLM
configurations on 2x4 and 2x2x2, every ``kv_spec`` branch, a batch the
data axes do not divide), which ``test_torch_sharded.py`` holds the port
to on 8 gloo ranks and ``chip_smoke.py``'s phase 14 (a) on the card.
Written with ``--write-sharded``; the ``slow`` test regenerates it.

``tests/data/torch_sharded_train.json`` holds the reference's answers to
its jitted ``make_train_step`` on 8 devices (``torch_sharded_train_cases``:
the decoder families' reduced configs on 2x4 and 2x2x2, float32, 2 AdamW
steps): each step's loss and gradient norm, and the first step's
gradients and the last step's parameters as each leaf's sum of squares
and its values at fixed sample positions.  ``test_torch_sharded_train.py``
holds the port on 8 gloo ranks to it and ``chip_smoke.py``'s phase 15 (a)
on the card.  Written with ``--write-sharded-train``; the ``slow`` test
regenerates it.

``tests/data/torch_sharded_families_train.json`` holds the reference's
answers to its jitted ``make_train_step`` on 8 devices for the enc-dec,
SSM and hybrid families (``torch_sharded_families_train_cases``: reduced
whisper, mamba2 and recurrentgemma on 2x4 and 2x2x2, float32, 2 AdamW
steps), in ``torch_sharded_train.json``'s form, which
``test_torch_sharded_families_train.py`` holds the port to on 8 gloo
ranks and ``chip_smoke.py``'s phase 17 (a) on the card.  Written with
``--write-sharded-families-train``; the ``slow`` test regenerates it.

``tests/data/torch_sharded_families.json`` holds the reference's answers
to the enc-dec, SSM and hybrid families' sharded prefill and decode steps
on 8 devices (``torch_sharded_families_cases``: reduced whisper, mamba2
and recurrentgemma on 2x4 and 2x2x2, every cache layout branch, a batch
the data axes do not divide), which ``test_torch_sharded_families.py``
holds the port to on 8 gloo ranks and ``chip_smoke.py``'s phase 16 (a) on
the card.  Written with ``--write-sharded-families``; the ``slow`` test
regenerates it.

``tests/data/torch_sharded_knobs.json`` holds the reference's answers
under its attention and remat knobs on 8 devices: under ``serve/`` the
decoder's sharded prefill and decode steps of ``torch_sharded_knobs_cases``
(``attn_shard`` "heads" and "seq", ``pad_heads_to``, a window and a
chunk under "seq"), in ``torch_sharded.json``'s form, and under
``train/`` its jitted ``make_train_step`` on ``torch_sharded_knobs_train_
cases`` (the same knobs and ``remat="dots"``), in
``torch_sharded_train.json``'s form; ``test_torch_sharded_knobs.py``
holds the port to it on 8 gloo ranks and ``chip_smoke.py``'s phase 18
(b) to one of its training cases on the card.  Written with
``--write-sharded-knobs`` (about 2 min); the ``slow`` test regenerates
it.  ``--write-specs`` also pins, under ``"_hillclimb"``, the cell bytes
of the tuning plan's iterations whose trees differ from their base cell's
(``torch_hillclimb_cases``: the padded and TP-only ones).
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch_mesh_cases as mesh_cases
import torch_sharded_cases as sharded_cases
import torch_sharded_families_cases as families_cases
import torch_sharded_knobs_cases as knobs_cases
import torch_sharded_knobs_train_cases as knobs_train_cases
import torch_hillclimb_cases as hillclimb_cases
import torch_sharded_families_train_cases as families_train_cases
import torch_sharded_train_cases as train_cases

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


def iteration_pins(arg):
    # one tuning-plan iteration's cell bytes on every mesh:
    # name=arch=shape=<overrides as JSON>
    name, arch, sh, overrides = arg.split("=", 3)
    cfg = get_config(arch).replace(**json.loads(overrides))
    shape = get_shape(sh)
    trees = cell_trees(cfg, shape)
    return {"arch": arch, "shape": sh, "overrides": json.loads(overrides),
            "bytes": {name: cell_bytes(cfg, shape, trees, mctx)
                      for name, mctx in MESHES.items()}}


out = {}
for arg in sys.argv[1:]:
    if "=" in arg:
        out.setdefault("_hillclimb", {})[arg.split("=")[0]] = \
            iteration_pins(arg)
    else:
        out[arg] = arch_pins(arg)
print(json.dumps(out))
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
        **spec_pins(list_archs() + hillclimb_cases.spec_args())}
    SPEC_PINS.write_text(json.dumps(pins, separators=(",", ":")) + "\n")


SPEC_PINS = ROOT / "tests" / "data" / "torch_specs.json"


def test_reference_reproduces_spec_pins():
    """One configuration per family, regenerated, equals the file."""
    pins = json.loads(SPEC_PINS.read_text())
    got = spec_pins(SPEC_FAMILIES)
    for arch in SPEC_FAMILIES:
        assert got[arch] == pins[arch], arch


# The MoE block across 8 devices: the reference runs ``moe_ffn`` in every
# mode on 2x4 and 2x2x2 host meshes, and the reduced decoders' prefill and
# two decode steps on 2x4, from ``torch_mesh_cases``' numpy inputs, in one
# subprocess with 8 forced host devices (each step jitted, the caches
# carried between steps as numpy).  ``test_torch_mesh.py`` holds the port
# on 8 gloo ranks to the file.
_MESH_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
sys.path.insert(0, "tests")
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get_config
from repro.models import get_model
from repro.models.moe import moe_ffn
from repro.models.sharding import MeshCtx
import torch_mesh_cases as C


def carry(tree, pad=0):
    # numpy and back (no sharding rides along), "k"/"v" grown by pad slots
    def leaf(path, x):
        x = np.asarray(x)
        if pad and path[-1].key in ("k", "v"):
            x = np.pad(x, [(0, 0)] * (x.ndim - 2) + [(0, pad), (0, 0)])
        return jnp.asarray(x)
    return jax.tree_util.tree_map_with_path(leaf, tree)


out = {}
for mname, (shape, names) in C.MESHES.items():
    mesh = jax.make_mesh(shape, names)
    assert [d.id for d in mesh.devices.flat] == list(range(C.WORLD))
    mctx = MeshCtx(mesh)
    for arch in C.ARCHS:
        for mode in C.MODES:
            cfg = get_config(arch).reduced().replace(**C.REPLACE,
                                                     moe_shard=mode)
            inp = C.moe_inputs(arch, cfg.d_model, cfg.d_ff,
                               cfg.num_experts, cfg.shared_expert)
            params = jax.tree.map(jnp.asarray, inp["params"])
            block = jax.jit(lambda p, x: moe_ffn(p, x, cfg, mctx))
            for b in C.X_BATCHES:
                out[f"moe/{mname}/{arch}/{mode}/x{b}"] = block(
                    params, jnp.asarray(inp[f"x{b}"]))
            if mname != C.DECODER_MESH:
                continue
            model = get_model(cfg)
            dec = C.decoder_inputs(arch, model.param_shapes(cfg),
                                   cfg.vocab_size)
            params = jax.tree.map(jnp.asarray, dec["params"])
            toks = dec["tokens"]
            key = f"decoder/{mname}/{arch}/{mode}"
            prefill = jax.jit(lambda p, b: model.prefill(p, b, cfg, mctx))
            decode = jax.jit(lambda p, c, tok, t: model.decode(p, c, tok, t,
                                                              cfg, mctx))
            logits, caches = prefill(
                params, {"tokens": jnp.asarray(toks[:, :C.PROMPT])})
            out[f"{key}/prefill"] = logits
            caches = carry(caches, C.STEPS)
            for i in range(C.STEPS):
                t = C.PROMPT + i
                logits, caches = decode(params, caches,
                                        jnp.asarray(toks[:, t:t + 1]),
                                        jnp.int32(t))
                out[f"{key}/decode{i}"] = logits
                caches = carry(caches)
print(json.dumps({k: C.encode(v) for k, v in out.items()}))
"""
MESH_PINS = ROOT / "tests" / "data" / "torch_mesh.json"


def mesh_pins() -> dict:
    """The reference's answers to every case of ``torch_mesh_cases``, from
    one subprocess with 8 forced host devices (about 40 s)."""
    out = subprocess.run([sys.executable, "-c", _MESH_SCRIPT],
                         capture_output=True, text=True, timeout=1200,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": "src",
                                        "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


def write_mesh_pins() -> None:
    pins = {"_meta": {
        "written_by": "PYTHONPATH=src python tests/test_torch_pins.py "
                      "--write-mesh (the reference package, on the CPU, "
                      "8 forced host devices)",
        "meshes": {k: [list(v[0]), list(v[1])]
                   for k, v in mesh_cases.MESHES.items()},
        "replace": mesh_cases.REPLACE},
        **mesh_pins()}
    MESH_PINS.write_text(json.dumps(pins, separators=(",", ":")) + "\n")


def test_mesh_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 13 with the reduced mixtral on 8 gloo
    ranks on the CPU: the pins on every rank, "2d" against the 1x1 path
    and "expert" against "ffn", the ranks' outputs equal (the card's run
    with the sizes cut; the plain versions launch no kernel).  The ranks
    import ``chip_smoke`` by name."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)
    sv = dict(chip_smoke.MESH_SERVE, reduced=True, prompt_len=16, decode=3)
    assert chip_smoke.mesh_phase(torch, "cpu", "cpu", sv=sv) == {
        "flash_attention": 0, "decode_attention": 0}


# The decoder's sharded steps across 8 devices: the reference runs every
# case of ``torch_sharded_cases`` with its parameters placed under
# ``param_specs``, the batch under ``P(dp, None)`` and the caches, carried
# as numpy between steps and grown after the prefill, placed under
# ``cache_specs`` before each step, on meshes with Auto axes (jax 0.9.0's
# ``jax.make_mesh`` makes Explicit axes by default, under which the
# reference's sharded embedding gather raises ``ShardingTypeError``).
# ``test_torch_sharded.py`` holds the port on 8 gloo ranks to the file.
_SHARDED_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import importlib, json, sys
sys.path.insert(0, "tests")
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import get_model
from repro.models.model import drop_dp_axes
from repro.models.sharding import MeshCtx
C = importlib.import_module(sys.argv[1])


def place(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: place(v, specs[k], mesh) for k, v in tree.items()}
    return jax.device_put(jnp.asarray(tree), NamedSharding(mesh, specs))


def carry(tree, pad=0):
    # numpy, the "k"/"v" leaves grown by pad slots
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = carry(v, pad)
            continue
        v = np.asarray(v)
        if pad and k in ("k", "v"):
            v = np.pad(v, [(0, 0)] * (v.ndim - 2) + [(0, pad), (0, 0)])
        out[k] = v
    return out


meshes = {}
for m, (shape, names) in C.MESHES.items():
    mesh = jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape))
    assert [d.id for d in mesh.devices.flat] == list(range(C.WORLD))
    meshes[m] = mesh
out = {}
for name, (arch, _, m, batch, slots) in C.CASES.items():
    mesh = meshes[m]
    mctx = MeshCtx(mesh)
    cfg = get_config(arch).reduced().replace(**C.case_replace(name))
    model = get_model(cfg)
    img = cfg.img_tokens if cfg.family == "vlm" else 0
    inp = C.inputs(name, model.param_shapes(cfg), cfg.vocab_size,
                   cfg.d_model, img)
    dp = mctx.dp if batch % mctx.dp_size == 0 else None
    params = place(inp["params"], model.param_specs(cfg, mctx), mesh)
    toks = inp["tokens"]
    prompt = toks.shape[1] - C.STEPS
    feed = {"tokens": place(toks[:, :prompt], P(dp, None), mesh)}
    if img:
        feed["img_emb"] = place(inp["img_emb"], P(dp, None, None), mesh)

    def cache_specs(n):
        specs = model.cache_specs(cfg, mctx, n)
        return specs if dp else drop_dp_axes(specs, mctx)

    prefill = jax.jit(lambda p, b: model.prefill(p, b, cfg, mctx))
    decode = jax.jit(lambda p, c, tok, t: model.decode(p, c, tok, t, cfg,
                                                      mctx))
    logits, caches = prefill(params, feed)
    out[f"{name}/prefill"] = logits
    s0 = prompt + img
    caches = carry(caches, slots - s0)
    for i in range(C.STEPS):
        tok = place(toks[:, prompt + i:prompt + i + 1], P(dp, None),
                    mesh)
        logits, caches = decode(params, place(caches, cache_specs(slots),
                                              mesh), tok, jnp.int32(s0 + i))
        out[f"{name}/decode{i}"] = logits
        caches = carry(caches)
    for key, arr in C.cache_paths(caches).items():
        out[f"{name}/{key}"] = arr
print(json.dumps({k: C.encode(v) for k, v in out.items()}))
"""
SHARDED_PINS = ROOT / "tests" / "data" / "torch_sharded.json"


def sharded_pins(cases=sharded_cases) -> dict:
    """The reference's answers to every case of the cases module ``cases``
    (``torch_sharded_cases`` by default), from one subprocess with 8
    forced host devices."""
    out = subprocess.run([sys.executable, "-c", _SHARDED_SCRIPT,
                          cases.__name__],
                         capture_output=True, text=True, timeout=1200,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": "src",
                                        "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


def write_sharded_pins() -> None:
    pins = {"_meta": {
        "written_by": "PYTHONPATH=src python tests/test_torch_pins.py "
                      "--write-sharded (the reference package, on the CPU, "
                      "8 forced host devices, Auto mesh axes)",
        "cases": {k: list(v) for k, v in sharded_cases.CASES.items()},
        "replace": sharded_cases.REPLACE,
        "prompt": sharded_cases.PROMPT, "steps": sharded_cases.STEPS},
        **sharded_pins()}
    SHARDED_PINS.write_text(json.dumps(pins, separators=(",", ":")) + "\n")


@pytest.mark.slow
def test_reference_reproduces_sharded_pins():
    """Every sharded case regenerated from the reference equals the file,
    bit for bit."""
    pins = json.loads(SHARDED_PINS.read_text())
    got = sharded_pins()
    assert sorted(got) == sorted(k for k in pins if k != "_meta")
    for key in got:
        np.testing.assert_array_equal(sharded_cases.decode(got[key]),
                                      sharded_cases.decode(pins[key]), key)


def test_sharded_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 14 on 8 gloo ranks on the CPU: the sharded
    pins on every rank with the counting mesh's counts, the reduced llama
    and mixtral served on 2x4 against their 1x1 runs, "ffn"'s experts
    from FSDP storage against ``moe_blocks``' (the card's run with the
    sizes cut; the plain versions launch no kernel)."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)
    sv_b = dict(chip_smoke.SHARD_SERVE, reduced=True, layers=4,
                prompt_len=16, decode=3)
    sv_c = dict(chip_smoke.SHARD_MOE, reduced=True, prompt_len=16)
    assert chip_smoke.sharded_phase(torch, "cpu", "cpu", sv_b=sv_b,
                                    sv_c=sv_c) == {
        "flash_attention": 0, "decode_attention": 0}



# The other families' sharded steps across 8 devices, as ``_SHARDED_SCRIPT``
# runs the decoder's: every case of ``torch_sharded_families_cases``, its
# parameters placed under ``param_specs``, the tokens and whisper's frames
# under ``P(dp, ...)``, the caches carried as numpy (only the
# self-attention ``k``/``v`` leaves grown after the prefill) and placed
# under ``cache_specs`` before each step, each step jitted, on meshes with
# Auto axes.  ``test_torch_sharded_families.py`` holds the port on 8 gloo
# ranks to the file.
_SHARDED_FAMILIES_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
sys.path.insert(0, "tests")
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import get_model
from repro.models.model import drop_dp_axes
from repro.models.sharding import MeshCtx
import torch_sharded_families_cases as C


def place(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: place(v, specs[k], mesh) for k, v in tree.items()}
    return jax.device_put(jnp.asarray(tree), NamedSharding(mesh, specs))


def carry(tree, pad=0):
    # numpy, the self-attention "k"/"v" leaves grown by pad slots
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = carry(v, pad)
            continue
        v = np.asarray(v)
        if pad and k in ("k", "v"):
            v = np.pad(v, [(0, 0)] * (v.ndim - 2) + [(0, pad), (0, 0)])
        out[k] = v
    return out


meshes = {}
for m, (shape, names) in C.MESHES.items():
    mesh = jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape))
    assert [d.id for d in mesh.devices.flat] == list(range(C.WORLD))
    meshes[m] = mesh
out = {}
for name, (arch, _, m, batch, slots) in C.CASES.items():
    mesh = meshes[m]
    mctx = MeshCtx(mesh)
    cfg = get_config(arch).reduced().replace(**C.replace(name))
    model = get_model(cfg)
    enc = cfg.enc_seq if cfg.family == "encdec" else 0
    inp = C.inputs(name, model.param_shapes(cfg), cfg.vocab_size,
                   cfg.d_model, enc)
    dp = mctx.dp if batch % mctx.dp_size == 0 else None
    params = place(inp["params"], model.param_specs(cfg, mctx), mesh)
    toks = inp["tokens"]
    feed = {"tokens": place(toks[:, :C.PROMPT], P(dp, None), mesh)}
    if enc:
        feed["frames"] = place(inp["frames"], P(dp, None, None), mesh)

    def cache_specs(n):
        specs = model.cache_specs(cfg, mctx, n)
        return specs if dp else drop_dp_axes(specs, mctx)

    prefill = jax.jit(lambda p, b: model.prefill(p, b, cfg, mctx))
    decode = jax.jit(lambda p, c, tok, t: model.decode(p, c, tok, t, cfg,
                                                      mctx))
    logits, caches = prefill(params, feed)
    out[f"{name}/prefill"] = logits
    caches = carry(caches, slots - C.PROMPT)
    for i in range(C.STEPS):
        tok = place(toks[:, C.PROMPT + i:C.PROMPT + i + 1], P(dp, None),
                    mesh)
        logits, caches = decode(params, place(caches, cache_specs(slots),
                                              mesh), tok,
                                jnp.int32(C.PROMPT + i))
        out[f"{name}/decode{i}"] = logits
        caches = carry(caches)
    for key, arr in C.cache_paths(caches).items():
        out[f"{name}/{key}"] = arr
print(json.dumps({k: C.encode(np.asarray(v, np.float32))
                  for k, v in out.items()}))
"""
SHARDED_FAMILIES_PINS = ROOT / "tests" / "data" / \
    "torch_sharded_families.json"


def sharded_families_pins() -> dict:
    """The reference's answers to every case of
    ``torch_sharded_families_cases``, from one subprocess with 8 forced
    host devices."""
    out = subprocess.run([sys.executable, "-c", _SHARDED_FAMILIES_SCRIPT],
                         capture_output=True, text=True, timeout=1800,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": "src",
                                        "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


def write_sharded_families_pins() -> None:
    pins = {"_meta": {
        "written_by": "PYTHONPATH=src python tests/test_torch_pins.py "
                      "--write-sharded-families (the reference package, on "
                      "the CPU, 8 forced host devices, Auto mesh axes)",
        "cases": {k: list(v) for k, v in families_cases.CASES.items()},
        "replace": families_cases.REPLACE,
        "prompt": families_cases.PROMPT, "steps": families_cases.STEPS},
        **sharded_families_pins()}
    SHARDED_FAMILIES_PINS.write_text(json.dumps(pins, separators=(",", ":"))
                                     + "\n")


@pytest.mark.slow
def test_reference_reproduces_sharded_families_pins():
    """Every case of the other families regenerated from the reference
    equals the file, bit for bit."""
    pins = json.loads(SHARDED_FAMILIES_PINS.read_text())
    got = sharded_families_pins()
    assert sorted(got) == sorted(k for k in pins if k != "_meta")
    for key in got:
        np.testing.assert_array_equal(families_cases.decode(got[key]),
                                      families_cases.decode(pins[key]), key)


def test_family_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 16 on 8 gloo ranks on the CPU: the
    families' sharded pins on every rank with the counting mesh's counts,
    then the reduced whisper, mamba2 and recurrentgemma served on 2x4
    against their 1x1 runs, each rank's collectives equal to the
    dry-run's count (the card's run with the sizes cut; the plain
    versions launch no kernel)."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)
    svs = tuple(dict(sv, reduced=True, layers=4, prompt_len=16, decode=2)
                for sv in chip_smoke.FAMILY_SERVE)
    assert chip_smoke.family_phase(torch, "cpu", "cpu", svs=svs) == {
        "flash_attention": 0, "decode_attention": 0}

# The sharded training step across 8 devices: the reference's jitted
# ``make_train_step`` on every case of a cases module (its name the
# script's argument: ``torch_sharded_train_cases`` or
# ``torch_sharded_families_train_cases``), its parameters and moments
# placed under ``param_specs`` / ``opt_state_specs`` and the batch under
# ``P(dp, ...)``, on meshes with Auto axes; the first step's gradients
# from ``jax.grad`` of the loss the step differentiates (a microbatched
# case's whole-batch gradient: its parts weigh as many tokens each, so
# the mean is the same function).
_SHARDED_TRAIN_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import importlib, json, sys
sys.path.insert(0, "tests")
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import get_model
from repro.models.sharding import MeshCtx
from repro.train.optimizer import AdamWConfig, init_opt_state, \
    opt_state_specs
from repro.train.train_step import make_loss_fn, make_train_step
C = importlib.import_module(sys.argv[1])


def place(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: place(v, specs[k], mesh) for k, v in tree.items()}
    return jax.device_put(jnp.asarray(tree), NamedSharding(mesh, specs))


def host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


meshes = {}
for m, (shape, names) in C.MESHES.items():
    mesh = jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape))
    assert [d.id for d in mesh.devices.flat] == list(range(C.WORLD))
    meshes[m] = mesh
out = {}
for name, (arch, mode, m, batch, micro) in C.CASES.items():
    mesh = meshes[m]
    mctx = MeshCtx(mesh)
    cfg = get_config(arch).reduced().replace(**C.replace(name))
    model = get_model(cfg)
    inp = C.case_inputs(name, model.param_shapes(cfg), cfg)
    dp = mctx.dp if batch % mctx.dp_size == 0 else None
    specs = model.param_specs(cfg, mctx)
    params = place(inp["params"], specs, mesh)
    ocfg = AdamWConfig(opt_dtype=cfg.opt_dtype)
    opt = place(host(init_opt_state(inp["params"], ocfg)),
                opt_state_specs(specs), mesh)
    opt["step"] = jax.device_put(jnp.zeros((), jnp.int32),
                                 NamedSharding(mesh, P()))
    feed = {k: place(v, P(dp, *(None,) * (v.ndim - 1)), mesh)
            for k, v in inp.items() if k != "params"}
    grads = jax.jit(jax.grad(make_loss_fn(cfg, mctx)))(params, feed)
    for key, val in C.summarise(name, host(grads)).items():
        out[f"{name}/grad/{key}"] = val
    step = jax.jit(make_train_step(cfg, mctx, ocfg, microbatch=micro))
    losses, norms = [], []
    for _ in range(C.STEPS):
        params, opt, metrics = step(params, opt, feed)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    out[f"{name}/loss"] = np.asarray(losses, np.float32)
    out[f"{name}/grad_norm"] = np.asarray(norms, np.float32)
    for key, val in C.summarise(name, host(params)).items():
        out[f"{name}/param/{key}"] = val
print(json.dumps({k: C.encode(v) for k, v in out.items()}))
"""
SHARDED_TRAIN_PINS = ROOT / "tests" / "data" / "torch_sharded_train.json"
SHARDED_FAMILIES_TRAIN_PINS = ROOT / "tests" / "data" / \
    "torch_sharded_families_train.json"


def sharded_train_pins(cases=train_cases) -> dict:
    """The reference's answers to every case of the cases module
    ``cases``, from one subprocess with 8 forced host devices."""
    out = subprocess.run([sys.executable, "-c", _SHARDED_TRAIN_SCRIPT,
                          cases.__name__],
                         capture_output=True, text=True, timeout=1800,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": "src",
                                        "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


def _write_train_pins(cases, path: pathlib.Path, flag: str) -> None:
    pins = {"_meta": {
        "written_by": f"PYTHONPATH=src python tests/test_torch_pins.py "
                      f"{flag} (the reference package, on the CPU, 8 forced "
                      f"host devices, Auto mesh axes)",
        "cases": {k: list(v) for k, v in cases.CASES.items()},
        "replace": {k: cases.replace(k) for k in cases.CASES},
        "steps": cases.STEPS, "seq": cases.SEQ,
        "samples": train_cases.SAMPLES},
        **sharded_train_pins(cases)}
    path.write_text(json.dumps(pins, separators=(",", ":")) + "\n")


def write_sharded_train_pins() -> None:
    _write_train_pins(train_cases, SHARDED_TRAIN_PINS,
                      "--write-sharded-train")


def write_sharded_families_train_pins() -> None:
    _write_train_pins(families_train_cases, SHARDED_FAMILIES_TRAIN_PINS,
                      "--write-sharded-families-train")


@pytest.mark.slow
def test_reference_reproduces_sharded_train_pins():
    """Every sharded training case regenerated from the reference equals
    the file, bit for bit."""
    pins = json.loads(SHARDED_TRAIN_PINS.read_text())
    got = sharded_train_pins()
    assert sorted(got) == sorted(k for k in pins if k != "_meta")
    for key in got:
        np.testing.assert_array_equal(train_cases.decode(got[key]),
                                      train_cases.decode(pins[key]), key)


def test_train_ranks_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 15 on 8 gloo ranks on the CPU: one pinned
    case with the counting mesh's counts, the reduced llama and mixtral
    ("2d") trained on 2x4 against their 1x1 runs (the card's run with the
    sizes cut; the plain versions launch no kernel)."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)
    sv_b = dict(chip_smoke.TRAIN_RANKS, reduced=True, layers=2, seq=64)
    sv_c = dict(chip_smoke.TRAIN_RANKS_MOE, reduced=True, seq=64)
    assert chip_smoke.train_ranks_phase(
        torch, "cpu", "cpu", sv_b=sv_b, sv_c=sv_c,
        pin_names=["llama/2x2x2/groups3"]) == {
        "flash_attention": 0, "flash_attention_bwd": 0}


@pytest.mark.slow
def test_reference_reproduces_sharded_families_train_pins():
    """Every training case of the enc-dec, SSM and hybrid families
    regenerated from the reference equals the file, bit for bit."""
    pins = json.loads(SHARDED_FAMILIES_TRAIN_PINS.read_text())
    got = sharded_train_pins(families_train_cases)
    assert sorted(got) == sorted(k for k in pins if k != "_meta")
    for key in got:
        np.testing.assert_array_equal(
            families_train_cases.decode(got[key]),
            families_train_cases.decode(pins[key]), key)


def test_family_train_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 17 on 8 gloo ranks on the CPU: one pinned
    case with the counting mesh's counts, the reduced whisper, mamba2 and
    recurrentgemma (one full group) trained on 2x4 against their 1x1
    runs, each rank's collectives equal to the dry-run's count (the
    card's run with the sizes cut; the plain versions launch no
    kernel)."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)
    parts = {key: dict(sv, reduced=True, seq=32,
                       layers=3 if key == "recurrentgemma" else 2)
             for key, sv in chip_smoke.TRAIN_FAMILIES.items()}
    assert chip_smoke.family_train_phase(
        torch, "cpu", "cpu", parts=parts,
        pin_names=["mamba2/2x4/cut-heads"]) == {
        "flash_attention": 0, "flash_attention_bwd": 0}


SHARDED_KNOBS_PINS = ROOT / "tests" / "data" / "torch_sharded_knobs.json"


def sharded_knobs_pins() -> dict:
    """The reference's answers to the knob cases: the serving cases of
    ``torch_sharded_knobs_cases`` under ``serve/`` and the training cases
    of ``torch_sharded_knobs_train_cases`` under ``train/`` (one
    subprocess each, 8 forced host devices, Auto axes)."""
    serve = sharded_pins(knobs_cases)
    train = sharded_train_pins(knobs_train_cases)
    return {**{f"serve/{k}": v for k, v in serve.items()},
            **{f"train/{k}": v for k, v in train.items()}}


def write_sharded_knobs_pins() -> None:
    pins = {"_meta": {
        "written_by": "PYTHONPATH=src python tests/test_torch_pins.py "
                      "--write-sharded-knobs (the reference package, on "
                      "the CPU, 8 forced host devices, Auto mesh axes)",
        "serve": {k: list(v) for k, v in knobs_cases.CASES.items()},
        "serve_replace": {k: knobs_cases.case_replace(k)
                          for k in knobs_cases.CASES},
        "train": {k: list(v) for k, v in knobs_train_cases.CASES.items()},
        "train_replace": {k: knobs_train_cases.replace(k)
                          for k in knobs_train_cases.CASES},
        "prompt": knobs_cases.PROMPT, "prompts": knobs_cases.PROMPTS,
        "steps": knobs_cases.STEPS,
        "train_steps": knobs_train_cases.STEPS,
        "seq": knobs_train_cases.SEQ, "seqs": knobs_train_cases.SEQS,
        "samples": train_cases.SAMPLES},
        **sharded_knobs_pins()}
    SHARDED_KNOBS_PINS.write_text(json.dumps(pins, separators=(",", ":"))
                                  + "\n")


@pytest.mark.slow
def test_reference_reproduces_sharded_knobs_pins():
    """Every knob case regenerated from the reference equals the file, bit
    for bit."""
    pins = json.loads(SHARDED_KNOBS_PINS.read_text())
    got = sharded_knobs_pins()
    assert sorted(got) == sorted(k for k in pins if k != "_meta")
    for key in got:
        np.testing.assert_array_equal(knobs_cases.decode(got[key]),
                                      knobs_cases.decode(pins[key]), key)


def test_knob_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 18 on the CPU: (a) "dots" against "full"
    (the reduced llama: the first step's products counted, the losses,
    norms and last parameters equal), (b) and (c) on 8 gloo ranks: the
    reduced llama served under "seq", "auto" and padded with "heads"
    against its 1x1 runs, and trained under "seq" against its 1x1 run
    after one pinned knob case (the card's run with the sizes cut; the
    plain versions launch no kernel)."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)
    sv_a = dict(chip_smoke.KNOB_REMAT, reduced=True, seq=64, steps=2)
    sv_serve = dict(chip_smoke.KNOB_SERVE, reduced=True, layers=2,
                    prompt_len=16)
    parts = dict(chip_smoke.KNOB_PARTS, pad={
        "num_heads": 6, "pad_heads_to": 8, "attn_shard": "heads"})
    sv_train = dict(chip_smoke.KNOB_TRAIN, reduced=True, layers=2, seq=64)
    assert chip_smoke.knob_phase(
        torch, "cpu", "cpu", sv_a, sv_serve, parts, sv_train,
        ["llama/2x4/seq"]) == {"flash_attention": 0,
                               "flash_attention_bwd": 0,
                               "decode_attention": 0}


@pytest.mark.slow
def test_reference_reproduces_mesh_pins():
    """Every mesh case regenerated from the reference equals the file, bit
    for bit."""
    pins = json.loads(MESH_PINS.read_text())
    got = mesh_pins()
    assert sorted(got) == sorted(mesh_cases.case_keys())
    for key in mesh_cases.case_keys():
        np.testing.assert_array_equal(mesh_cases.decode(got[key]),
                                      mesh_cases.decode(pins[key]), key)


if __name__ == "__main__":
    writers = {"--write": write_pins, "--write-serve": write_serve_pins,
               "--write-train": write_train_pins,
               "--write-specs": write_spec_pins,
               "--write-mesh": write_mesh_pins,
               "--write-sharded": write_sharded_pins,
               "--write-sharded-train": write_sharded_train_pins,
               "--write-sharded-families": write_sharded_families_pins,
               "--write-sharded-families-train":
                   write_sharded_families_train_pins,
               "--write-sharded-knobs": write_sharded_knobs_pins}
    if len(sys.argv) != 2 or sys.argv[1] not in writers:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_pins.py "
                 "--write | --write-serve | --write-train | --write-specs "
                 "| --write-mesh | --write-sharded "
                 "| --write-sharded-train | --write-sharded-families "
                 "| --write-sharded-families-train | --write-sharded-knobs")
    writers[sys.argv[1]]()
