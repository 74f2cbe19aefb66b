"""Multimodal host utilities: image preprocessing modes and image-token
tokenization (counterpart of visper_lm_tpu/data/mm_utils.py).

Images are HWC uint8 numpy arrays (a 2-D array is grey, a fourth channel is
dropped); an object with a `convert` method (a PIL image) is read through
`np.asarray(image.convert("RGB"))`, so PIL is never imported here. The JAX
package resizes through PIL; this module computes Pillow's resampling itself
(`resize_bicubic`: libImaging/Resample.c's separable filter with 22-bit fixed
point coefficients, horizontal pass first, a uint8 clip after each pass), and
crops and pads as PIL does (outside the image is 0), so the arrays equal the
JAX package's.

anyres: the tiling is here; the feature index plans are in data/anyres.py
and the tiles are encoded by models/vlm.py's `encode_images`.
"""

from __future__ import annotations

import ast
import math
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np

from visper_lm_tpu_torch.constants import IMAGE_TOKEN_INDEX

# OpenAI CLIP normalization constants (HF CLIPImageProcessor defaults).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
# OpenCLIP ConvNeXt-XXL normalization.
OPENCLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENCLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
# ImageNet normalization (DINOv2 / Depth-Anything-v2, OneFormer).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

Image = Any  # an (H, W, 3) uint8 array, or anything with .convert("RGB")

# ---------------------------------------------------------------------------
# Pillow's resampling (libImaging/Resample.c), in numpy
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2
_BICUBIC_SUPPORT = 2.0


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic_filter (a = -0.5), in float64 with its operation order."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """precompute_coeffs + normalize_coeffs_8bpc: each output pixel's first
    input pixel (out_size,) and its fixed-point weights (out_size, ksize),
    zero past the window's end."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _BICUBIC_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    valid = taps[None, :] < xmax[:, None]
    w = _bicubic(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(valid, w, 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):                      # the C loop's summation order
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    scaled = w * (1 << _PRECISION_BITS)
    fixed = np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5)).astype(np.int64)
    return xmin, fixed


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along `axis` (1: horizontal, 0: vertical) of an (H, W, C) uint8
    image. The fixed-point sums are one float64 product with the (out, in)
    matrix of the windows' weights: every partial sum is an integer below
    2^53, so the product is exact and equals C's int32 sums."""
    in_size = img.shape[axis]
    xmin, k = _coefficients(in_size, out_size)
    weights = np.zeros((out_size, in_size))
    taps = xmin[:, None] + np.arange(k.shape[1])[None, :]
    valid = k != 0
    weights[np.nonzero(valid)[0], taps[valid]] = k[valid]
    acc = np.moveaxis(np.tensordot(weights, img.astype(np.float64), axes=([1], [axis])), 0, axis)
    acc = acc.astype(np.int64) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Pillow's `Image.resize(size, BICUBIC)` of an (H, W, C) uint8 image;
    size is (width, height) as PIL takes it."""
    w, h = size
    out = img
    if w != img.shape[1]:
        out = _resample_axis(out, w, axis=1)
    if h != img.shape[0]:
        out = _resample_axis(out, h, axis=0)
    return out if out is not img else img.copy()


def to_rgb_array(image: Image) -> np.ndarray:
    """An image as a (H, W, 3) uint8 array (PIL's convert("RGB"))."""
    if hasattr(image, "convert"):
        return np.asarray(image.convert("RGB"))
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise ValueError(f"images are uint8 arrays, got {arr.dtype}")
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    if arr.ndim != 3 or arr.shape[-1] not in (3, 4):
        raise ValueError(f"images are (H, W, 3) arrays, got shape {arr.shape}")
    return arr[..., :3]


def image_size(image: np.ndarray) -> Tuple[int, int]:
    """(width, height), PIL's `Image.size`."""
    return image.shape[1], image.shape[0]


def _crop(image: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
    """PIL's crop: the box may reach outside the image, which reads as 0."""
    left, top, right, bottom = box
    out = np.zeros((bottom - top, right - left, image.shape[2]), image.dtype)
    h, w = image.shape[:2]
    y0, y1, x0, x1 = max(top, 0), min(bottom, h), max(left, 0), min(right, w)
    if y0 < y1 and x0 < x1:
        out[y0 - top : y1 - top, x0 - left : x1 - left] = image[y0:y1, x0:x1]
    return out


def _canvas(width: int, height: int, color, image: np.ndarray, at: Tuple[int, int]) -> np.ndarray:
    """PIL's Image.new((width, height), color) with `image` pasted at (x, y)."""
    out = np.empty((height, width, image.shape[2]), np.uint8)
    out[...] = np.asarray(color, np.uint8)
    x, y = at
    out[y : y + image.shape[0], x : x + image.shape[1]] = image
    return out


# ---------------------------------------------------------------------------
# Core pixel ops (HF CLIPImageProcessor-compatible)
# ---------------------------------------------------------------------------


def resize_shortest_edge(image: np.ndarray, size: int) -> np.ndarray:
    """HF 'shortest_edge' resize with bicubic resampling."""
    w, h = image_size(image)
    short, long = (w, h) if w <= h else (h, w)
    if short == size:
        return image
    new_long = int(size * long / short)
    new_w, new_h = (size, new_long) if w <= h else (new_long, size)
    return resize_bicubic(image, (new_w, new_h))


def center_crop(image: np.ndarray, size: int) -> np.ndarray:
    w, h = image_size(image)
    left = (w - size) // 2
    top = (h - size) // 2
    return _crop(image, (left, top, left + size, top + size))


def normalize_image(image: Image, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    """RGB -> float32 (H, W, 3) normalized, NHWC."""
    arr = to_rgb_array(image).astype(np.float32) / 255.0
    return (arr - np.asarray(mean, dtype=np.float32)) / np.asarray(std, dtype=np.float32)


def clip_preprocess(image: Image, size: int = 336) -> np.ndarray:
    """HF CLIPImageProcessor: shortest-edge resize -> center crop -> normalize."""
    image = center_crop(resize_shortest_edge(to_rgb_array(image), size), size)
    return normalize_image(image, CLIP_IMAGE_MEAN, CLIP_IMAGE_STD)


def resize_square_preprocess(
    image: Image,
    size: int,
    mean: Sequence[float] = CLIP_IMAGE_MEAN,
    std: Sequence[float] = CLIP_IMAGE_STD,
) -> np.ndarray:
    """Plain (size, size) bicubic resize + normalize (the ConvNeXt tower's)."""
    return normalize_image(resize_bicubic(to_rgb_array(image), (size, size)), mean, std)


def expand2square(image: Image, background_color: Tuple[int, ...]) -> np.ndarray:
    """Pad to a square with the given color, the image centred."""
    image = to_rgb_array(image)
    width, height = image_size(image)
    if width == height:
        return image
    if width > height:
        return _canvas(width, width, background_color, image, (0, (width - height) // 2))
    return _canvas(height, height, background_color, image, ((height - width) // 2, 0))


# ---------------------------------------------------------------------------
# anyres tiling
# ---------------------------------------------------------------------------


def select_best_resolution(
    original_size: Tuple[int, int], possible_resolutions: List[Tuple[int, int]]
) -> Tuple[int, int]:
    """The grid resolution with the most effective resolution, then the least waste."""
    original_width, original_height = original_size
    best_fit = None
    max_effective_resolution = 0
    min_wasted_resolution = float("inf")

    for width, height in possible_resolutions:
        scale = min(width / original_width, height / original_height)
        downscaled_width = int(original_width * scale)
        downscaled_height = int(original_height * scale)
        effective_resolution = min(
            downscaled_width * downscaled_height, original_width * original_height
        )
        wasted_resolution = width * height - effective_resolution

        if effective_resolution > max_effective_resolution or (
            effective_resolution == max_effective_resolution
            and wasted_resolution < min_wasted_resolution
        ):
            max_effective_resolution = effective_resolution
            min_wasted_resolution = wasted_resolution
            best_fit = (width, height)

    return best_fit


def resize_and_pad_image(image: np.ndarray, target_resolution: Tuple[int, int]) -> np.ndarray:
    """Aspect-preserving resize, then centred on a black canvas of the target size."""
    original_width, original_height = image_size(image)
    target_width, target_height = target_resolution

    scale_w = target_width / original_width
    scale_h = target_height / original_height

    if scale_w < scale_h:
        new_width = target_width
        new_height = min(math.ceil(original_height * scale_w), target_height)
    else:
        new_height = target_height
        new_width = min(math.ceil(original_width * scale_h), target_width)

    resized = resize_bicubic(image, (new_width, new_height))
    paste_x = (target_width - new_width) // 2
    paste_y = (target_height - new_height) // 2
    return _canvas(target_width, target_height, (0, 0, 0), resized, (paste_x, paste_y))


def divide_to_patches(image: np.ndarray, patch_size: int) -> List[np.ndarray]:
    patches = []
    width, height = image_size(image)
    for i in range(0, height, patch_size):
        for j in range(0, width, patch_size):
            patches.append(_crop(image, (j, i, j + patch_size, i + patch_size)))
    return patches


def _resolutions(grid_pinpoints: Union[str, List[Tuple[int, int]]]) -> List[Tuple[int, int]]:
    if isinstance(grid_pinpoints, str):
        return ast.literal_eval(grid_pinpoints)
    return grid_pinpoints


def get_anyres_image_grid_shape(
    image_size_wh: Tuple[int, int],
    grid_pinpoints: Union[str, List[Tuple[int, int]]],
    patch_size: int,
) -> Tuple[int, int]:
    width, height = select_best_resolution(image_size_wh, _resolutions(grid_pinpoints))
    return width // patch_size, height // patch_size


def process_anyres_image(
    image: Image,
    grid_pinpoints: Union[str, List[Tuple[int, int]]],
    crop_size: int,
    shortest_edge: int,
    preprocess_fn,
) -> np.ndarray:
    """The base resize and the tiles: (1 + n_tiles, H, W, 3)."""
    image = to_rgb_array(image)
    best_resolution = select_best_resolution(image_size(image), _resolutions(grid_pinpoints))
    patches = divide_to_patches(resize_and_pad_image(image, best_resolution), crop_size)
    base = resize_bicubic(image, (shortest_edge, shortest_edge))
    return np.stack([preprocess_fn(p) for p in [base] + patches], axis=0)


def unpad_image_array(tensor: np.ndarray, original_size: Tuple[int, int]) -> np.ndarray:
    """Remove the centre padding resize_and_pad_image added; tensor is an
    (H, W, C) feature map in spatial layout."""
    original_width, original_height = original_size
    current_height, current_width = tensor.shape[:2]

    if original_width / original_height > current_width / current_height:
        new_height = int(original_height * (current_width / original_width))
        padding = (current_height - new_height) // 2
        return tensor[padding : current_height - padding, :]
    new_width = int(original_width * (current_height / original_height))
    padding = (current_width - new_width) // 2
    return tensor[:, padding : current_width - padding]


# ---------------------------------------------------------------------------
# highres / crop_split modes
# ---------------------------------------------------------------------------


def resize_and_center_crop(image: np.ndarray, size: int) -> np.ndarray:
    return center_crop(resize_shortest_edge(image, size), size)


def extract_patches(
    image: np.ndarray, patch_size: int, overlap_ratio: float = 0.0
) -> List[np.ndarray]:
    """A centred grid of (overlapping) patches."""
    w, h = image_size(image)
    stride = int(patch_size * (1 - overlap_ratio))
    num_y = (h - patch_size) // stride + 1
    num_x = (w - patch_size) // stride + 1
    y_start = (h - (num_y - 1) * stride - patch_size) // 2
    x_start = (w - (num_x - 1) * stride - patch_size) // 2
    patches = []
    for y in range(y_start, y_start + num_y * stride, stride):
        for x in range(x_start, x_start + num_x * stride, stride):
            patches.append(_crop(image, (x, y, x + patch_size, y + patch_size)))
    return patches


def process_highres_image(
    image: Image,
    grid_params: Sequence[int],
    shortest_edge: int,
    preprocess_fn,
) -> np.ndarray:
    """Square-pad to max(grid_params), split into shortest_edge patches and
    put the base resize first (the largest grid is always taken, as in JAX)."""
    image = to_rgb_array(image)
    select_size = max(grid_params)
    bg = tuple(int(x * 255) for x in CLIP_IMAGE_MEAN)
    padded = resize_bicubic(expand2square(image, bg), (select_size, select_size))
    base = resize_bicubic(image, (shortest_edge, shortest_edge))
    patches = [base] + extract_patches(padded, patch_size=shortest_edge, overlap_ratio=0)
    return np.stack([preprocess_fn(p) for p in patches], axis=0)


def process_crop_split_image(
    image: Image,
    crop_resolution: int,
    split_resolution: int,
    preprocess_fn,
) -> np.ndarray:
    """Resize + centre crop, then a non-overlapping split."""
    crop = resize_and_center_crop(to_rgb_array(image), crop_resolution)
    patches = extract_patches(crop, patch_size=split_resolution, overlap_ratio=0)
    return np.stack([preprocess_fn(p) for p in patches], axis=0)


# ---------------------------------------------------------------------------
# process_images dispatch
# ---------------------------------------------------------------------------


def process_images(
    images: List[Image],
    image_aspect_ratio: str = "square",
    image_size: int = 336,
    grid_pinpoints: Optional[Union[str, List[Tuple[int, int]]]] = None,
    preprocess_fn=None,
    highres_grid: Sequence[int] = (672,),
    crop_resolution: int = 672,
    split_resolution: int = 336,
) -> Union[np.ndarray, List[np.ndarray]]:
    if preprocess_fn is None:
        def preprocess_fn(im):
            return clip_preprocess(im, image_size)

    if image_aspect_ratio == "highres":
        return [process_highres_image(im, highres_grid, image_size, preprocess_fn) for im in images]
    if image_aspect_ratio == "crop_split":
        return [
            process_crop_split_image(im, crop_resolution, split_resolution, preprocess_fn)
            for im in images
        ]
    if image_aspect_ratio == "pad":
        bg = tuple(int(x * 255) for x in CLIP_IMAGE_MEAN)
        return np.stack([preprocess_fn(expand2square(im, bg)) for im in images], axis=0)
    if image_aspect_ratio == "anyres":
        if grid_pinpoints is None:
            raise ValueError("anyres needs grid_pinpoints")
        return [
            process_anyres_image(im, grid_pinpoints, image_size, image_size, preprocess_fn)
            for im in images
        ]
    # 'square', the default
    return np.stack([preprocess_fn(to_rgb_array(im)) for im in images], axis=0)


# ---------------------------------------------------------------------------
# Tokenization with <image> placeholders
# ---------------------------------------------------------------------------


def tokenizer_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
) -> List[int]:
    """Split the prompt on '<image>' and put the sentinel index between the
    chunks; a BOS that starts the first chunk is kept once, at the front."""
    prompt_chunks = [tokenizer(chunk).input_ids for chunk in prompt.split("<image>")]

    def insert_separator(X, sep):
        return [ele for sublist in zip(X, [sep] * len(X)) for ele in sublist][:-1]

    input_ids = []
    offset = 0
    if (
        len(prompt_chunks) > 0
        and len(prompt_chunks[0]) > 0
        and prompt_chunks[0][0] == tokenizer.bos_token_id
    ):
        offset = 1
        input_ids.append(prompt_chunks[0][0])

    for x in insert_separator(prompt_chunks, [image_token_index] * (offset + 1)):
        input_ids.extend(x[offset:])

    return input_ids


class KeywordsStoppingCriteria:
    """Stop when any keyword appears in the decoded generation (host side)."""

    def __init__(self, keywords: List[str], tokenizer, input_len: int):
        self.keywords = keywords
        self.tokenizer = tokenizer
        self.input_len = input_len

    def should_stop(self, output_ids: Sequence[int]) -> bool:
        text = self.tokenizer.decode(output_ids[self.input_len :], skip_special_tokens=False)
        return any(kw in text for kw in self.keywords)
