"""The port stands alone: no module of ``src/repro_torch`` and neither
``chip_smoke.py``, ``kernel_ab.py``, ``store_census.py``,
``first_loss_depth.py`` nor the mesh and knob cases ``chip_smoke.py``
runs on the card (``tests/torch_mesh_cases.py``,
``tests/torch_sharded_knobs_train_cases.py`` and the training cases it
builds on) imports JAX or the JAX package ``repro``, the entry points
refuse to run on the CPU unless asked to, and ``kernel_ab.py`` binds
another tree's kernel wrappers to that tree's own build."""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py",
       ROOT / "store_census.py", ROOT / "first_loss_depth.py",
       ROOT / "tests" / "torch_mesh_cases.py",
       ROOT / "tests" / "torch_sharded_train_cases.py",
       ROOT / "tests" / "torch_sharded_knobs_train_cases.py"]
FORBIDDEN = ("jax", "repro", "jaxlib", "ml_dtypes")


def _imports(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_files_exist():
    assert len(PORT_FILES) > 20
    assert (ROOT / "src" / "repro_torch" / "csrc" / "sorted_probe.cu").exists()
    assert (ROOT / "src" / "repro_torch" / "csrc" / "window_agg.cu").exists()
    assert (ROOT / "src" / "repro_torch" / "csrc" / "flash_attn.cu").exists()
    assert (ROOT / "src" / "repro_torch" / "csrc" / "decode_attn.cu").exists()
    assert (ROOT / "src" / "repro_torch" / "csrc"
            / "flash_attn_bwd.cu").exists()
    for module in ("serve/kv_cache.py", "serve/engine.py", "models/moe.py",
                   "configs/h2o_danube_1_8b.py", "configs/mixtral_8x7b.py",
                   "train/__init__.py", "train/optimizer.py",
                   "train/grad_compress.py", "train/train_step.py",
                   "train/checkpoint.py", "train/tree.py",
                   "launch/train.py", "models/sharding.py", "launch/mesh.py",
                   "launch/elastic.py", "launch/dryrun.py",
                   "state/legacy.py"):
        assert ROOT / "src" / "repro_torch" / module in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imports(path)
           if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_without_device_raises_when_no_cuda(monkeypatch):
    from repro_torch.data.nexmark import q11
    from repro_torch.streaming.engine import StreamEngine
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamEngine(q11(), seed=3)


def test_store_without_device_raises_when_no_cuda(monkeypatch):
    from repro_torch.state.lsm import LSMStore
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        LSMStore(4.0)
    assert LSMStore(4.0, device="cpu").device.type == "cpu"


def test_legacy_store_without_device_raises_when_no_cuda(monkeypatch):
    """The legacy store resolves its device as the columnar one does,
    also when ``make_store`` builds it under the legacy switch."""
    from repro_torch.state import lsm
    from repro_torch.state.legacy import LegacyLSMStore
    _no_cuda(monkeypatch)
    monkeypatch.setattr(lsm, "_ACTIVE_STORE_IMPL", "columnar")
    with pytest.raises(RuntimeError, match="CUDA"):
        LegacyLSMStore(1.0)
    lsm.set_store_impl("legacy")
    with pytest.raises(RuntimeError, match="CUDA"):
        lsm.make_store(1.0)
    s = lsm.make_store(1.0, device="cpu")
    assert type(s) is LegacyLSMStore and s.device.type == "cpu"


def _scenario_entry_points():
    from repro_torch import scenarios as S
    tiny = dict(windows=1, verbose=False)
    return {
        "run_scenario": lambda: S.run_scenario("justin", "q1", "constant",
                                               windows=1),
        "run_colocated": lambda: S.run_colocated(
            [("ds2", "q1")], S.Cluster(cpu_slots=8, memory_mb=1e4),
            windows=0),
        "run_fleet": lambda: S.run_fleet(2, 1),
        "run_grid": lambda: S.run_grid(["q1"], ["constant"], ["ds2"],
                                       **tiny),
        "run_colocation": lambda: S.run_colocation(["q1"], **tiny),
    }


@pytest.mark.parametrize("name", ["run_scenario", "run_colocated",
                                  "run_fleet", "run_grid",
                                  "run_colocation"])
def test_scenario_entry_points_raise_when_no_cuda(monkeypatch, name):
    """Every entry point that builds engines resolves its device first:
    without one given and no CUDA it raises before building anything."""
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        _scenario_entry_points()[name]()


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mixtral-8x7b",
                                  "minitron-4b", "internlm2-20b"])
def test_serve_without_device_raises_when_no_cuda(monkeypatch, arch):
    """Every architecture the port serves resolves its device first:
    without one given and no CUDA, ``serve`` raises before it builds
    anything."""
    from repro_torch.launch.serve import serve
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(arch, requests=1, prompt_len=8, decode=1, verbose=False)


def test_train_without_device_raises_when_no_cuda(monkeypatch):
    """The training entry point resolves its device first: without one
    given and no CUDA, ``train`` raises before it builds anything."""
    from repro_torch.launch.train import train
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        train("llama3.2-3b", steps=1, verbose=False)


def test_derive_mesh_without_devices_raises_when_no_cuda(monkeypatch):
    """The card's mesh comes from its CUDA devices: without devices given
    and no CUDA, ``derive_mesh`` raises; given devices, it lays them out."""
    from repro_torch.launch.elastic import derive_mesh
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        derive_mesh(1)
    mctx = derive_mesh(1, devices=[torch.device("cpu")])
    assert mctx.mesh.shape == {"data": 1, "model": 1}


def test_decode_layer_on_the_card_never_takes_the_plain_mask():
    """On a CUDA tensor the decode layer hands the kernel a slot range or
    raises: an explicit position map, a tensor ``t`` or a wrapped ring the
    window cuts never fall back to the plain path's full mask."""
    from repro_torch.models import layers

    class FakeCuda:
        is_cuda = True
        shape = (1, 2, 1, 16)

    k = torch.zeros((1, 1, 64, 16))
    for kw in (dict(kv_positions=torch.arange(64)[None], t=10),
               dict(kv_positions=None, t=torch.tensor([10])),
               dict(kv_positions=None, t=100)):
        with pytest.raises(NotImplementedError):
            layers.decode_attention(FakeCuda(), k, k, window=32, **kw)


def test_cuda_tensor_without_build_raises_not_falls_back(monkeypatch):
    """A CUDA tensor goes to the kernel binding or raises; it never takes
    the plain version.  Checked without a card by handing the wrapper a
    tensor that claims to be on CUDA."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.sorted_probe import ops

    class FakeCuda:
        is_cuda = True
        shape = (3,)

    monkeypatch.setattr(_build, "CSRC", ROOT / "no-such-dir")
    with pytest.raises((ValueError, RuntimeError)):
        ops.probe(torch.arange(3), FakeCuda())
    with pytest.raises(RuntimeError, match="no CUDA sources"):
        _build.build()


def test_kernel_ab_loads_another_tree_beside_this_one(tmp_path, monkeypatch):
    """The A/B tool's baseline wrappers are another copy of the package,
    each bound to the ``_build`` (sources, build directory) of its own
    tree, and this checkout's modules are left as they were."""
    import shutil
    import sys
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    monkeypatch.syspath_prepend(str(ROOT))
    import kernel_ab
    from repro_torch.kernels import _build
    shutil.copytree(ROOT / "src" / "repro_torch",
                    tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cur = kernel_ab.load_wrappers()
    before = dict(kernel_ab._package_modules())
    base = kernel_ab.load_wrappers(tmp_path / "src")
    assert kernel_ab._package_modules() == before
    assert str(tmp_path / "src") not in sys.path
    for k in ("sorted_probe", "window_agg", "flash_attention"):
        assert cur[k].__globals__["_build"] is _build
        other = base[k].__globals__["_build"]
        assert other is not _build
        assert other.CSRC == tmp_path / "src" / "repro_torch" / "csrc"
        assert other.build_dir() == tmp_path / "build" / "repro_torch"
    assert base["sorted_probe"].__globals__["_build"] \
        is base["window_agg"].__globals__["_build"] \
        is base["flash_attention"].__globals__["_build"]
