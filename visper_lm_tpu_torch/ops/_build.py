"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C interface
under `visper_lm_tpu_torch/_build/<hash>/`, keyed by a hash of the sources and
the flags, so an edited source rebuilds and an unchanged one is reused. The
build happens at first use; `build_all()` starts one nvcc per source at once.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
    "-Xptxas", "-v",
)

# library name -> C signatures (argtypes, restype)
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "flash_fwd": {
        "visper_flash_fwd": (
            [_P] * 7 + [_LL] * 12 + [_I] * 6 + [ctypes.c_float, _I, _I, _P],
            ctypes.c_int,
        ),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str) -> subprocess.Popen:
    lib = _lib_path(name)
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_all() -> Dict[str, str]:
    """Compile every library that is not built yet, one nvcc each, in parallel.

    Returns {name: compiler output} for the libraries built by this call
    (nvcc's -Xptxas -v lines give registers, shared memory and spills)."""
    procs = {n: _start(n) for n in SIGNATURES if not _lib_path(n).exists()}
    logs = {}
    failed = []
    for name, proc in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            continue
        lib = _lib_path(name)
        os.replace(lib.with_suffix(f".{os.getpid()}.tmp"), lib)
        lib.with_suffix(".log").write_text(out)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building it first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    _loaded[name] = lib
    return lib
