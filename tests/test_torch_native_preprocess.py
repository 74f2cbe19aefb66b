"""The port's native preprocessing library (visper_lm_tpu_torch/native/) against
the JAX package's (visper_lm_tpu/native/): the same C++ source built with the
same flags, so every output is BIT-EQUAL (and without OpenMP, as a g++ with no
libgomp builds it, the same bytes), on seeded uint8 images at the
teachers' sizes (336, 224 on the shortest edge, 768) and non-square ones, in
both resampling modes. Against the plain numpy version (PIL's fixed-point
bicubic, data/mm_utils.py) the bound is test_teacher_preprocess_native.py's:
mean |diff| < 0.02 and max < 0.5 in normalized units. expand2square equals
the JAX library's and mm_utils'. A library that cannot be built raises with
the compiler's output (there is no fallback).
"""

import time

import numpy as np
import pytest

from visper_lm_tpu_torch import native
from visper_lm_tpu_torch.data import mm_utils as tmm

SHAPES = [(480, 640), (123, 201), (1024, 1024), (200, 900), (900, 200), (336, 336)]
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _jax_native():
    """The JAX package's library. It builds itself with `make` in its source
    directory at first use; a test file run beside this one may be building
    it at the same moment, and a half-written file makes it give up for the
    process, so wait for the build and ask again."""
    from visper_lm_tpu import native as jn

    for _ in range(60):
        if jn.available():
            return jn
        jn._tried = False
        time.sleep(0.5)
    pytest.fail("the JAX package's native library did not build")


def _image(h, w, seed=0):
    return np.random.default_rng(seed + 31 * h + w).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _shortest_edge(h, w, size=224):
    if min(h, w) == size:
        return h, w
    return (int(size * h / w), size) if w <= h else (size, int(size * w / h))


@pytest.mark.parametrize("shape", SHAPES)
def test_resize_normalize_bit_equal_to_jax_library(shape):
    jn = _jax_native()
    img = _image(*shape)
    for mode in (native.BILINEAR, native.BICUBIC):
        for size in (336, _shortest_edge(*shape), 768, (77, 301)):
            got = native.resize_normalize(img, size, MEAN, STD, mode)
            ref = jn.resize_normalize(img, size, MEAN, STD, mode)
            assert got.dtype == np.float32 and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref, err_msg=f"{shape} -> {size} mode {mode}")


def test_out_slab_rows_equal_fresh_results():
    imgs = [_image(300, 500, s) for s in range(3)]
    slab = np.empty((3, 96, 96, 3), np.float32)
    for i, im in enumerate(imgs):
        row = native.resize_normalize(im, 96, MEAN, STD, out=slab[i])
        assert np.shares_memory(row, slab)
        np.testing.assert_array_equal(slab[i], native.resize_normalize(im, 96, MEAN, STD))
    with pytest.raises(ValueError):
        native.resize_normalize(imgs[0], 96, MEAN, STD, out=np.empty((96, 96, 3), np.float64))
    # shapes the C code cannot take are refused before a pointer is passed
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 9), np.uint8), np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises(ValueError):
            native.resize_normalize(bad, 8, MEAN * 3, STD * 3)
    with pytest.raises(ValueError):
        native.resize_normalize(imgs[0], 8, MEAN[:2], STD[:2])
    with pytest.raises(ValueError):
        native.expand2square(imgs[0], (1, 2))


@pytest.mark.parametrize("shape", SHAPES[:4])
def test_native_within_bound_of_the_plain_numpy_version(shape):
    img = _image(*shape)
    for size in ((336, 336), (768, 768), (111, 250)):
        got = native.resize_normalize(img, (size[1], size[0]), MEAN, STD, native.BICUBIC)
        ref = tmm.normalize_image(tmm.resize_bicubic(img, size), MEAN, STD)
        diff = np.abs(got - ref)
        assert float(diff.mean()) < 0.02, (size, diff.mean())
        assert float(diff.max()) < 0.5, (size, diff.max())


def test_expand2square_equals_jax_library_and_mm_utils():
    jn = _jax_native()
    for h, w in ((30, 50), (50, 30), (17, 17), (1, 9)):
        img = _image(h, w, seed=2)
        got = native.expand2square(img, (7, 8, 9))
        np.testing.assert_array_equal(got, jn.expand2square(img, (7, 8, 9)))
        np.testing.assert_array_equal(got, tmm.expand2square(img, (7, 8, 9)))


def test_without_openmp_the_bytes_are_the_same(tmp_path, monkeypatch):
    """A g++ without libgomp (the card's) builds without -fopenmp: one core a
    call, the same bytes as the OpenMP build."""
    img = _image(480, 640)
    ref = [native.resize_normalize(img, size, MEAN, STD, native.BICUBIC) for size in (336, 768)]
    assert native.openmp()                              # this host links OpenMP
    monkeypatch.setattr(native, "_openmp", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    assert "-fopenmp" not in native.flags()
    for size, r in zip((336, 768), ref):
        np.testing.assert_array_equal(native.resize_normalize(img, size, MEAN, STD), r)
    assert native.lib_path().exists()


def test_build_is_keyed_and_a_failed_build_raises(tmp_path, monkeypatch):
    path = native.build()
    assert path.exists() and path.parent.parent == native.BUILD_DIR
    assert native.lib_path() == path                   # unchanged source: no rebuild
    broken = tmp_path / "preprocess.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    assert native.lib_path() != path                   # another source, another key
    with pytest.raises(RuntimeError, match="this is not C"):
        native.resize_normalize(_image(8, 8), 4, MEAN, STD)
    monkeypatch.setattr(native, "SOURCE", path.parent.parent.parent / "native" / "preprocess.cc")
    monkeypatch.setattr(native, "_target", lambda: "another CPU")
    assert native.lib_path().parent.name != path.parent.name     # another host, another key
    # a compiler that cannot link OpenMP builds the same source without it
    monkeypatch.setattr(native, "_openmp", False)
    assert "-fopenmp" not in native.flags() and native.lib_path() != path
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.load()
