"""Image preprocessing and image-token tokenization
(visper_lm_tpu_torch/data/mm_utils.py) vs the JAX package's, which resizes
through PIL. The port computes Pillow's bicubic resampling in numpy; every
array here must be EQUAL to JAX's (no uint8 step of difference): the
resampler against PIL's `Image.resize` at up- and down-scales, odd and
non-square sizes, and `process_images` in all five aspect modes on images
made from seeded uint8 arrays (JAX gets PIL images of the same arrays).
"""

import numpy as np
import pytest
from PIL import Image

from visper_lm_tpu.data import mm_utils as jmm

from visper_lm_tpu_torch.constants import IMAGE_TOKEN_INDEX
from visper_lm_tpu_torch.data import mm_utils as tmm

from test_data_pipeline import FakeTokenizer

SHAPES = [(40, 40), (30, 80), (480, 640), (336, 336), (77, 1000), (901, 203), (17, 333),
          (5, 7), (1000, 3)]


def _image(h, w, seed=0):
    return np.random.default_rng(seed + h * 7 + w).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
def test_resize_bicubic_equals_pillow(shape):
    h, w = shape
    a = _image(h, w)
    for size in [(336, 336), (2 * w + 1, h), (w, 3 * h + 2), (123, 77), (w // 2 + 1, h // 3 + 1),
                 (1, 1), (448, 336), (w, h)]:
        ref = np.asarray(Image.fromarray(a).resize(size, Image.Resampling.BICUBIC))
        np.testing.assert_array_equal(tmm.resize_bicubic(a, size), ref, err_msg=str(size))


MODES = dict(
    square={}, pad={},
    anyres=dict(grid_pinpoints="[[336,672],[672,336],[672,672],[1008,336],[336,1008]]"),
    highres=dict(highres_grid=(672,)),
    crop_split=dict(crop_resolution=672, split_resolution=336),
)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shapes", [SHAPES[:3], SHAPES[3:6], SHAPES[6:8]])
def test_process_images_equals_jax(mode, shapes):
    arrays = [_image(h, w, seed=1) for h, w in shapes]
    ref = jmm.process_images([Image.fromarray(a) for a in arrays], image_aspect_ratio=mode,
                             image_size=336, **MODES[mode])
    got = tmm.process_images(arrays, image_aspect_ratio=mode, image_size=336, **MODES[mode])
    assert type(got) is type(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.float32 and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_pil_images_and_other_layouts():
    a = _image(60, 90, seed=2)
    ref = jmm.process_images([Image.fromarray(a)], image_aspect_ratio="pad", image_size=56)
    np.testing.assert_array_equal(
        tmm.process_images([Image.fromarray(a)], image_aspect_ratio="pad", image_size=56), ref)
    rgba = np.concatenate([a, np.full(a.shape[:2] + (1,), 7, np.uint8)], axis=-1)
    np.testing.assert_array_equal(
        tmm.process_images([rgba], image_aspect_ratio="pad", image_size=56), ref)
    grey = a[..., 0]
    np.testing.assert_array_equal(
        tmm.clip_preprocess(grey, 28), jmm.clip_preprocess(Image.fromarray(grey), 28))
    with pytest.raises(ValueError, match="uint8"):
        tmm.to_rgb_array(a.astype(np.float32))


@pytest.mark.parametrize("shape", [(40, 40), (30, 80), (81, 20)])
def test_expand2square_equals_jax(shape):
    a = _image(*shape, seed=3)
    bg = tuple(int(x * 255) for x in tmm.CLIP_IMAGE_MEAN)
    ref = np.asarray(jmm.expand2square(Image.fromarray(a), bg))
    np.testing.assert_array_equal(tmm.expand2square(a, bg), ref)


@pytest.mark.parametrize("size", [(800, 600), (600, 800), (336, 336), (1500, 300), (10, 1000),
                                  (1008, 336)])
def test_select_best_resolution_and_grid_equal_jax(size):
    pins = [(336, 672), (672, 336), (672, 672), (1008, 336), (336, 1008)]
    assert tmm.select_best_resolution(size, pins) == jmm.select_best_resolution(size, pins)
    assert (tmm.get_anyres_image_grid_shape(size, str(pins), 336)
            == jmm.get_anyres_image_grid_shape(size, str(pins), 336))


@pytest.mark.parametrize("size", [(800, 600), (600, 800), (300, 300)])
def test_unpad_image_array_equals_jax(size):
    feats = np.arange(24 * 48 * 2, dtype=np.float32).reshape(24, 48, 2)
    np.testing.assert_array_equal(tmm.unpad_image_array(feats, size),
                                  jmm.unpad_image_array(feats, size))


@pytest.mark.parametrize("prompt", [
    "hello <image> world", "<image>\nwhat is this?", "no image here",
    "<image> one <image> two <image>", "",
])
def test_tokenizer_image_token_equals_jax(prompt):
    tok = FakeTokenizer()
    got = tmm.tokenizer_image_token(prompt, tok)
    assert got == jmm.tokenizer_image_token(prompt, tok)
    assert got.count(IMAGE_TOKEN_INDEX) == prompt.count("<image>")


def test_keywords_stopping_criteria_equals_jax():
    class Tok:
        def decode(self, ids, skip_special_tokens=False):
            return "".join(chr(97 + i) for i in ids)

    ids = [0, 1, 2, 3, 4]
    for kw in (["cd"], ["x"], ["ab"]):
        t = tmm.KeywordsStoppingCriteria(kw, Tok(), input_len=2)
        j = jmm.KeywordsStoppingCriteria(kw, Tok(), input_len=2)
        assert t.should_stop(ids) == j.should_stop(ids)
