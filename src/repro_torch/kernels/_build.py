"""Build and load the port's CUDA kernels.

At first use every ``repro_torch/csrc/*.cu`` is compiled for Hopper
(``sm_90a``) with ``nvcc``, one process per source started together, and
the objects are linked into one shared library with a plain C interface,
loaded through ``ctypes``.  The library's name carries a hash of the
sources, the shared headers (``csrc/*.cuh``) and the compile and link
commands, so an edited source or header is rebuilt and a built one is
reused.  ``ptxas -v`` reports each kernel's registers, shared memory and
spills; ``build_info["ptxas"]`` keeps those lines per source (also for a
reused library: they are stored beside it).  The build goes to
``build/repro_torch/`` at the checkout root, or to
``$REPRO_TORCH_BUILD_DIR`` when that is set.

Nothing here runs at import time, and a failed build or load raises: no
caller falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-shared"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_S = ctypes.POINTER(ctypes.c_int64)     # a host array of element strides
# every exported symbol: (argtypes, restype)
_SIGNATURES = {
    # table, t, queries, n, pos, found, lanes per query, blocks, stream
    "sorted_probe_i32": ([_P, _L, _P, _L, _P, _P, _L, _L, _P], _I),
    "sorted_probe_i64": ([_P, _L, _P, _L, _P, _P, _L, _L, _P], _I),
    # seg, id bytes, values, n, v, s, sums, counts, stream
    "window_agg_f32": ([_P, _L, _P, _L, _L, _L, _P, _P, _P], _I),
    "window_agg_i64": ([_P, _L, _P, _L, _L, _L, _P, _P, _P], _I),
    # q, k, v, out, lse (or null), b, hq, hk, sq, skv, d, strides[12],
    # causal, window, chunk, stream
    "flash_attn_bf16": ([_P, _P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _S, _L,
                         _L, _L, _P], _I),
    "flash_attn_f32": ([_P, _P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _S, _L,
                        _L, _L, _P], _I),
    # q, k, v, o, dout, lse, delta, dq, dk, dv, dkv_part (or null), b, hq,
    # hk, sq, skv, d, strides[24], causal, window, chunk, route, shares,
    # delta elements, dkv_part elements, stream (flash_attn.kernel.bwd_plan)
    "flash_attn_bwd_bf16": ([_P] * 11 + [_L] * 6 + [_S] + [_L] * 7 + [_P],
                            _I),
    "flash_attn_bwd_f32": ([_P] * 11 + [_L] * 6 + [_S] + [_L] * 7 + [_P],
                           _I),
    # q, k, v, valid_len, lo, out, part_m, part_l, part_acc, tickets, b,
    # hq, hk, s, d, strides[10], chunk, n_splits, n_sub, stream
    "decode_attn_bf16": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L,
                          _L, _L, _S, _L, _L, _L, _P], _I),
    # d, int32 out: the bf16 kernel's blocks an SM
    "decode_attn_bf16_blocks_per_sm": ([_L, _P], _I),
    "decode_attn_f32": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L,
                         _L, _L, _S, _L, _L, _L, _P], _I),
}

_lib: ctypes.CDLL | None = None
build_info: dict = {}          # seconds, path and ptxas report of the build


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    # src/repro_torch/kernels/_build.py -> checkout root
    root = pathlib.Path(__file__).resolve().parents[3]
    return root / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources() -> list[pathlib.Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs: list[pathlib.Path]) -> str:
    """Hash of the compile and link commands, the sources and every shared
    header under CSRC (a header edit must rebuild its includers)."""
    h = hashlib.sha256(" ".join(ARCH + NVCC_FLAGS + LINK_FLAGS).encode())
    for s in [*srcs, *sorted(CSRC.glob("*.cuh"))]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _ptxas_lines(text: str) -> list[str]:
    """The ``ptxas -v`` lines of an nvcc log: per kernel, its registers,
    shared memory, stack frame and spill stores/loads, and any warning
    (C7513: wgmma serialised)."""
    return [line.strip() for line in text.splitlines()
            if line.lstrip().startswith("ptxas info")
            or "bytes spill stores" in line or "warning" in line]


def build() -> pathlib.Path:
    """Compile the sources (if not built yet) and return the library path."""
    srcs = _sources()
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"librepro_torch_{_digest(srcs)}.so"
    report = lib.with_suffix(".ptxas.json")
    if lib.exists():
        build_info.update(path=str(lib), seconds=0.0, cached=True,
                          ptxas=json.loads(report.read_text())
                          if report.exists() else {})
        return lib
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for s in srcs:
        obj = out / f"{s.stem}_{lib.stem[-16:]}.o"
        cmd = [nvcc, *ARCH, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)]
        procs.append((s, obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    ptxas = {}
    for s, _obj, cmd, p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {s.name} ({' '.join(cmd)}):\n{text}")
        ptxas[s.name] = _ptxas_lines(text)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *ARCH, *LINK_FLAGS, *(str(o) for _, o, _, _ in procs),
           "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({' '.join(cmd)}):\n"
                           f"{res.stdout}{res.stderr}")
    report.write_text(json.dumps(ptxas))
    os.replace(tmp, lib)
    build_info.update(path=str(lib), seconds=time.perf_counter() - t0,
                      cached=False, ptxas=ptxas)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a CUDA error code returned by a launch (negative: no TMA
    tensor map could be encoded)."""
    if err < 0:
        raise RuntimeError(f"{name}: tensor map encoding failed ({err})")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
