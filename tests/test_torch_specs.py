"""The port's partition specs against the reference's, entry for entry.

On the 1x1 mesh both packages run here (``cpu_mesh_ctx`` in each): every
configuration's parameter, optimizer-state, cache (at each applicable
shape's seq_len) and batch spec trees.  The reference builds its 16x16 and
2x16x16 meshes only over 256 / 512 forced host devices, so on those the
port is held against ``tests/data/torch_specs.json`` (written by
``tests/test_torch_pins.py --write-specs``, which also checks one
configuration per family against a fresh subprocess): the same trees and
each leaf's per-device shard shape.
"""
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.sharding import cpu_mesh_ctx as jax_cpu_mesh_ctx  # noqa
from repro.train.optimizer import opt_state_specs as jax_opt_specs  # noqa
from repro_torch.configs import (applicable_shapes, get_config,  # noqa
                                 get_shape, list_archs)
from repro_torch.launch.mesh import production_mesh_ctx  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.sharding import (P, ShapeDtypeStruct,  # noqa
                                         cpu_mesh_ctx)
from repro_torch.train.optimizer import opt_state_specs  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PINS = json.loads((ROOT / "tests" / "data" / "torch_specs.json").read_text())
ARCHS = list_archs()
MESHES = {"16x16": False, "2x16x16": True}


def flat(tree, prefix: str = "") -> dict:
    """{keystr path: leaf} of a nested dict whose leaves are specs (either
    package's) or ShapeDtypeStructs, as ``jax.tree_util.keystr`` names
    the paths."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in flat(tree[k], f"{prefix}[{k!r}]").items()}
    return {prefix: tree}


def entries(spec) -> tuple:
    """A spec's entries as plain tuples (JSON lists back to tuples)."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def port_trees(cfg, mctx) -> dict:
    """{kind: spec tree} of the port, the cache and batch trees per
    applicable shape, the cache's dp axes dropped where the batch does not
    divide them (as ``abstract_cache`` lays it out)."""
    model = port_model.get_model(cfg)
    pspecs = model.param_specs(cfg, mctx)
    out = {"params": pspecs, "opt": opt_state_specs(pspecs)}
    for sh in applicable_shapes(cfg):
        shape = get_shape(sh)
        cspecs = model.cache_specs(cfg, mctx, shape.seq_len)
        if shape.global_batch % mctx.dp_size:
            cspecs = port_model.drop_dp_axes(cspecs, mctx)
        out[f"cache/{sh}"] = cspecs
        out[f"batch/{sh}"] = port_model.batch_specs(cfg, shape, mctx)
    return out


def test_pin_file_covers_every_arch():
    # and the tuning plan's padded and TP-only cells (test_torch_dryrun.py)
    assert set(PINS) == {"_meta", "_hillclimb", *ARCHS}
    assert PINS["_meta"]["meshes"] == list(MESHES)
    for arch in ARCHS:
        shapes = applicable_shapes(get_config(arch))
        for mesh in MESHES:
            assert set(PINS[arch][mesh]["cache"]) == set(shapes)
            assert set(PINS[arch][mesh]["batch"]) == set(shapes)
        for mesh in PINS["_meta"]["byte_meshes"]:
            assert set(PINS[arch]["bytes"][mesh]) == set(shapes)


def test_spec_entries_normalise_as_jax_does():
    assert P(None, ("data",), "model") == (None, "data", "model")
    assert tuple(JP(None, ("data",), "model")) == (None, "data", "model")
    assert P(("pod", "data"), None) == (("pod", "data"), None)
    assert repr(P("model", None)) == "P('model', None)"


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_on_1x1_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    mctx, jmctx = cpu_mesh_ctx(), jax_cpu_mesh_ctx()
    jmodel = jax_model.get_model(jcfg)
    jp = jmodel.param_specs(jcfg, jmctx)
    want = {"params": jp, "opt": jax_opt_specs(jp)}
    for sh in applicable_shapes(cfg):
        shape = get_shape(sh)
        want[f"cache/{sh}"] = jmodel.cache_specs(jcfg, jmctx, shape.seq_len)
        want[f"batch/{sh}"] = jax_model.batch_specs(jcfg, shape, jmctx)
    got = port_trees(cfg, mctx)
    assert set(got) == set(want)
    for kind in want:
        g, w = flat(got[kind]), flat(want[kind])
        assert list(g) == list(w), kind
        for path in w:
            assert isinstance(g[path], P), (kind, path)
            assert tuple(g[path]) == tuple(w[path]), (kind, path)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_shard_shapes_equal_the_pins(arch, mesh):
    """Every leaf's spec and per-device shard shape on the production
    mesh, for the parameters, the optimizer state and each shape's cache
    and batch (the shapes from the port's own abstract trees)."""
    cfg = get_config(arch)
    mctx = production_mesh_ctx(multi_pod=MESHES[mesh])
    pins = PINS[arch][mesh]
    params = port_model.abstract_params(cfg, mctx)
    trees = {"params": params,
             "opt": {"m": params, "v": params,
                     "step": ShapeDtypeStruct((), torch.int32,
                                              mctx.sharding(P()))}}
    want = {"params": pins["params"], "opt": pins["opt"]}
    for sh in applicable_shapes(cfg):
        shape = get_shape(sh)
        trees[f"cache/{sh}"] = port_model.abstract_cache(cfg, shape, mctx)
        trees[f"batch/{sh}"] = port_model.abstract_batch(cfg, shape, mctx)
        want[f"cache/{sh}"] = pins["cache"][sh]
        want[f"batch/{sh}"] = pins["batch"][sh]
    specs = port_trees(cfg, mctx)
    for kind, tree in trees.items():
        got = flat(tree)
        spec_tree = flat(specs[kind])
        assert list(got) == list(want[kind]), kind
        for path, (spec, shard) in want[kind].items():
            leaf = got[path]
            assert tuple(leaf.sharding.spec) == entries(spec), (kind, path)
            assert tuple(spec_tree[path]) == entries(spec), (kind, path)
            assert leaf.sharding.shard_shape(leaf.shape) == tuple(shard), \
                (kind, path)
