"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro``, and the entry
points refuse to run on the CPU unless asked to."""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "repro", "jaxlib")


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
