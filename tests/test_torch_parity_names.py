"""The port does all that the JAX package does, name for name.

Every public top-level name (function, class, constant) and every public
method of a public class, in every module of ``src/repro``, must exist in
the same module of ``src/repro_torch``.  Both packages' sources are read
with ``ast``; neither is imported.  The allow-list names what the port
leaves out on purpose, one reason each.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent / "src"
REF = ROOT / "repro"
PORT = ROOT / "repro_torch"

_TILES = "a Pallas tile constant; the CUDA kernels pick their own tiles"
ALLOWED = {
    "kernels/decode_attn/kernel.py": {"KV_BLOCK": _TILES,
                                      "NEG_INF": _TILES},
    "kernels/flash_attn/kernel.py": {"KV_BLOCK": _TILES, "NEG_INF": _TILES,
                                     "Q_BLOCK": _TILES},
    "kernels/sorted_probe/kernel.py": {"QUERY_BLOCK": _TILES,
                                       "TABLE_TILE": _TILES},
    "kernels/window_agg/kernel.py": {"EVENT_TILE": _TILES,
                                     "SEG_BLOCK": _TILES},
    "launch/mesh.py": {"ICI_BW": "the TPU interconnect's rate; one H100 "
                                 "has no interconnect to price"},
    "launch/dryrun.py": {"collective_bytes_from_text":
                         "parses XLA's HLO text; the port counts its own "
                         "collectives (dryrun.count_collectives, a step "
                         "on meta tensors on a CountingMesh)"},
    "state/lsm.py": {n: "the wrappers already dispatch by device; CPU "
                        "tensors run the plain versions"
                     for n in ("DEFAULT_KERNEL_IMPL", "set_kernel_impl")},
    "models/layers.py": {"cdiv": "the Pallas grids' ceiling division; "
                                 "the port's kernels size their own grids"},
}


def public_names(path: pathlib.Path) -> set[str]:
    """Public top-level names and ``Class.method`` names of public
    classes defined in ``path`` (imports are not definitions)."""
    names: set[str] = set()

    def targets(t):
        if isinstance(t, ast.Name):
            yield t.id
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                yield from targets(e)

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(node.name)
            elif isinstance(node, ast.ClassDef):
                names.add(node.name)
                names.update(f"{node.name}.{m.name}" for m in node.body
                             if isinstance(m, (ast.FunctionDef,
                                               ast.AsyncFunctionDef)))
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    names.update(targets(t))
            elif isinstance(node, ast.AnnAssign):
                names.update(targets(node.target))
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                visit(node.body)
                visit(node.orelse)
                for h in node.handlers:
                    visit(h.body)

    visit(ast.parse(path.read_text(), filename=str(path)).body)
    return {n for n in names
            if not any(part.startswith("_") for part in n.split("."))}


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def test_reference_modules_found():
    assert len(REF_MODULES) > 50
    assert "state/legacy.py" in REF_MODULES


@pytest.mark.parametrize("module", REF_MODULES)
def test_port_defines_every_public_name(module):
    port = PORT / module
    assert port.exists(), f"the port has no {module}"
    missing = public_names(REF / module) - public_names(port) \
        - set(ALLOWED.get(module, ()))
    assert not missing, f"{module}: the port lacks {sorted(missing)}"


def test_allow_list_names_only_what_the_reference_has():
    """Each allowed name is a public name of its reference module that
    the port does not define, with a reason: the list cannot go stale."""
    for module, allowed in ALLOWED.items():
        ref, port = public_names(REF / module), public_names(PORT / module)
        for name, reason in allowed.items():
            assert name in ref, (module, name)
            assert name not in port, (module, name)
            assert reason, (module, name)


def test_private_and_imported_names_are_not_counted(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import os\nfrom x import y\nos.environ['A'] = '1'\n"
        "A, (B, _C) = 1, (2, 3)\nD: int = 4\n_E = 5\n"
        "class F:\n    def g(self): pass\n    def _h(self): pass\n"
        "class _G:\n    def g(self): pass\n"
        "def h(): pass\n"
        "try:\n    import z\nexcept ImportError:\n    I = 1\n")
    assert public_names(src) == {"A", "B", "D", "F", "F.g", "h", "I"}
