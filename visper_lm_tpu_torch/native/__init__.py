"""ctypes bindings for the native image preprocessing library (counterpart of
visper_lm_tpu/native/__init__.py).

`preprocess.cc` (the port's own copy of the JAX package's source) is built
with g++ at first use into `visper_lm_tpu_torch/_build/<hash>/`, keyed by a
hash of the source, the flags and the host CPU's target flags (-march=native),
and loaded with ctypes. There is no fallback: when the compiler is missing or
the build or the load fails, the first call raises with the compiler's output.
Nothing is built at import.

The flags are the JAX package's Makefile's, with -fopenmp where the
compiler can link OpenMP (a g++ without libgomp cannot: `openmp()` says
which build this is). Without it the pragmas are not compiled in and each
call runs on one core; the output rows are independent sums either way, so
the bytes are the same. `teacher_batch` spreads images over a thread pool.

`resize_normalize` is PIL's antialiased separable resize (bilinear or
bicubic) in f32 with the per-channel normalize fused in; `expand2square`
centre-pads to a square with a fill colour. Both release the GIL (ctypes),
so a thread pool scales them across host cores.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "preprocess.cc"
BUILD_DIR = _HERE.parent / "_build"
# the JAX package's Makefile flags (-Wall aside); -fopenmp only where it links
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17", "-shared")

BILINEAR = 0
BICUBIC = 1

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_openmp: Optional[bool] = None
build_seconds: Optional[float] = None    # how long this process's g++ took (None: no build)


def _compiler() -> str:
    name = os.environ.get("CXX") or "g++"
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"the native preprocessing library needs a C++ compiler: {name!r} "
                           "(g++, or $CXX) was not found")
    return found


def _target() -> str:
    """What -march=native means on this host, as the compiler expands it: a
    library built for one CPU is not loaded on another."""
    proc = subprocess.run([_compiler(), "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True)
    return proc.stdout


def openmp() -> bool:
    """Whether the compiler can build and link an OpenMP shared library."""
    global _openmp
    if _openmp is None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        probe = BUILD_DIR / f".openmp-probe-{os.getpid()}-{threading.get_ident()}"
        src = probe.with_suffix(".cc")
        src.write_text("#include <omp.h>\nextern \"C\" int visper_threads() "
                       "{ return omp_get_max_threads(); }\n")
        try:
            proc = subprocess.run([_compiler(), "-fopenmp", "-fPIC", "-shared", "-o",
                                   str(probe.with_suffix(".so")), str(src)],
                                  capture_output=True, text=True)
            _openmp = proc.returncode == 0
        finally:
            for f in (src, probe.with_suffix(".so")):
                f.unlink(missing_ok=True)
    return _openmp


def flags() -> Tuple[str, ...]:
    """The flags this host builds with: CXXFLAGS, less -fopenmp without OpenMP."""
    return CXXFLAGS if openmp() else tuple(f for f in CXXFLAGS if f != "-fopenmp")


def lib_path() -> Path:
    h = hashlib.sha256()
    h.update(" ".join(flags()).encode())
    h.update(_target().encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libvisper_preprocess.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path. Raises
    with the compiler's output when the build fails."""
    global build_seconds
    path = lib_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_compiler(), *flags(), "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the native preprocessing library failed ({' '.join(cmd)}):\n"
            + proc.stdout + proc.stderr)
    os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    return path


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (raises if it cannot be)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8p, f32p, c_int = (ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
                                ctypes.c_int)
            lib.visper_resize_normalize.argtypes = [
                u8p, c_int, c_int, c_int, f32p, c_int, c_int, f32p, f32p, c_int]
            lib.visper_resize_normalize.restype = None
            lib.visper_expand2square.argtypes = [u8p, c_int, c_int, c_int, u8p, u8p]
            lib.visper_expand2square.restype = None
            _lib = lib
    return _lib


def resize_normalize(
    image: np.ndarray,                      # uint8 (H, W, C), C <= 8
    size: Union[int, Tuple[int, int]],      # side, or (height, width)
    mean: Sequence[float],
    std: Sequence[float],
    mode: int = BICUBIC,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Fused resize + normalize: f32 (dh, dw, C) of (resize(image) / 255 -
    mean) / std. `out`: a C-contiguous f32 (dh, dw, C) destination, e.g. one
    row of a batch slab."""
    lib = load()
    dh, dw = (size, size) if isinstance(size, int) else size
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or not 1 <= image.shape[2] <= 8 or min(image.shape[:2]) < 1:
        raise ValueError(f"resize_normalize takes a uint8 (H, W, C <= 8) image, got {image.shape}")
    h, w, c = image.shape
    if dh < 1 or dw < 1:
        raise ValueError(f"resize_normalize to {(dh, dw)}")
    if len(mean) < c or len(std) < c:
        raise ValueError(f"{c} channels need {c} means and stds")
    if out is None:
        out = np.empty((dh, dw, c), dtype=np.float32)
    elif out.shape != (dh, dw, c) or out.dtype != np.float32 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out must be a C-contiguous f32 {(dh, dw, c)} array")
    mean_a = np.ascontiguousarray(mean, np.float32)
    std_a = np.ascontiguousarray(std, np.float32)
    lib.visper_resize_normalize(
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dh, dw,
        mean_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), mode,
    )
    return out


def expand2square(image: np.ndarray, fill: Sequence[int]) -> np.ndarray:
    """uint8 (H, W, C) centred on a max(H, W) square of colour `fill`."""
    lib = load()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or len(fill) < image.shape[2]:
        raise ValueError(f"expand2square takes a uint8 (H, W, C) image and C fill values, "
                         f"got {image.shape} and {len(fill)}")
    h, w, c = image.shape
    side = max(h, w)
    out = np.empty((side, side, c), dtype=np.uint8)
    fill_a = np.ascontiguousarray(fill, np.uint8)
    lib.visper_expand2square(
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        fill_a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out
