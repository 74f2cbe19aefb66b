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
import re
import shutil
import subprocess
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator, List, Mapping, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
    "-Xptxas", "-v",
    "-split-compile", "0",   # a source's kernels are optimized on all cores: decode_attn.cu has 24
)

# library name -> C signatures (argtypes, restype)
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_BWD = (
    [_P] * 11 + [ctypes.POINTER(_LL)] + [_I] * 6 + [ctypes.c_float, _I, _P],
    ctypes.c_int,
)
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "flash_fwd": {
        "visper_flash_fwd": (
            [_P] * 7 + [_LL] * 12 + [_I] * 6 + [ctypes.c_float, _I, _I, _P],
            ctypes.c_int,
        ),
        "visper_flash_fwd_wgmma_info": ([_I] + [ctypes.POINTER(_I)] * 3, ctypes.c_int),
    },
    "flash_bwd": {
        "visper_flash_bwd_dq": _BWD,
        "visper_flash_bwd_dkv": _BWD,
        "visper_flash_bwd_wgmma_info": ([_I] + [ctypes.POINTER(_I)] * 4, ctypes.c_int),
    },
    "window_attn": {
        "visper_window_attn": (
            [_P] * 6 + [_LL] * 12 + [_I] * 5 + [ctypes.c_float] + [_I] * 2 + [_P],
            ctypes.c_int,
        ),
        "visper_window_attn_info": ([_I] * 4 + [ctypes.POINTER(_I)] * 3, ctypes.c_int),
    },
    "w4_matmul": {"visper_w4_matmul": ([_P] * 4 + [_I] * 6 + [_P], ctypes.c_int)},
    "decode_attn": {
        "visper_decode_attn": (
            [_P] * 8 + [_I] * 5 + [ctypes.c_float] + [_I] * 5 + [_P],
            ctypes.c_int,
        ),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}   # library name -> seconds its nvcc took in `build_all`


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


def nvcc_command(
    src: Path, out: Path, *, defines: Optional[Mapping[str, int]] = None,
    flags: Sequence[str] = NVCC_FLAGS,
) -> List[str]:
    """The nvcc command that builds `src` into the shared library `out`, with
    the sources' headers on the include path and `-D` for each define."""
    return [nvcc_path(), *flags, f"-I{CSRC}", *(f"-D{k}={v}" for k, v in (defines or {}).items()),
            "-o", str(out), str(src)]


def _start(name: str) -> subprocess.Popen:
    lib = _lib_path(name)
    lib.parent.mkdir(parents=True, exist_ok=True)
    cmd = nvcc_command(CSRC / f"{name}.cu", lib.with_suffix(f".{os.getpid()}.tmp"))
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_all() -> Dict[str, str]:
    """Compile every library that is not built yet, one nvcc each, in parallel.

    Returns {name: compiler output} for the libraries built by this call
    (nvcc's -Xptxas -v lines give registers, shared memory and spills);
    `build_seconds` then holds how long each took."""
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in SIGNATURES if not _lib_path(n).exists()}
    pending = set(procs)
    while pending:
        for name in sorted(pending):
            if procs[name].poll() is not None:
                build_seconds[name] = time.perf_counter() - t0
                pending.discard(name)
        if pending:
            time.sleep(0.05)
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


def kernel_resources(log: str) -> Dict[str, Dict[str, int]]:
    """{mangled entry name: registers, spill_bytes, static_smem_bytes} from one
    library's -Xptxas -v output."""
    out: Dict[str, Dict[str, int]] = {}
    entry = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
            out[entry] = dict(registers=0, spill_bytes=0, static_smem_bytes=0)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[entry]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[entry]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            out[entry]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def build_log(name: str) -> str:
    """The compiler output of library `name`'s build (built first if needed)."""
    load(name)
    return _lib_path(name).with_suffix(".log").read_text()


def bind(name: str, path: Path) -> ctypes.CDLL:
    """Load the shared library at `path` with the C signatures of `name`."""
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building it first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all()
    lib = _loaded[name] = bind(name, path)
    return lib


@contextmanager
def loaded_as(name: str, lib: ctypes.CDLL) -> Iterator[None]:
    """Within the block, the wrappers that `load(name)` launch from `lib` (a
    library built from a modified copy of the source, to time it)."""
    before = _loaded.get(name)
    _loaded[name] = lib
    try:
        yield
    finally:
        if before is None:
            _loaded.pop(name, None)
        else:
            _loaded[name] = before
