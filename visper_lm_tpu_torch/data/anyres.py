"""anyres tiling: host-side feature index plans (counterpart of
visper_lm_tpu/data/anyres.py; numpy only).

LLaVA merges anyres tile features per sample (spatial grid -> unpad ->
image_newline -> flatten). Here the merge is a gather whose indices depend
only on (image size, grid shape), so the host computes them and the
collator puts them into the splice plan's src_index: the device encodes all
tiles in one batch and gathers.

Each sample's flat feature buffer: encode(tiles) -> (n_tiles, per_tile, D)
flattened row-major, base image first, with the learned image_newline row
appended last (index n_tiles * per_tile). The plans index that layout.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from visper_lm_tpu_torch.data.mm_utils import get_anyres_image_grid_shape


def unpadded_hw(
    original_size: Tuple[int, int], grid_h_patches: int, grid_w_patches: int, patch_side: int,
) -> Tuple[int, int, int, int]:
    """The feature-space crop of resize_and_pad_image's centre padding
    (LLaVA's unpad_image): (h', w', pad_top, pad_left) in feature cells."""
    ow, oh = original_size
    cur_h = grid_h_patches * patch_side
    cur_w = grid_w_patches * patch_side
    if ow / oh > cur_w / cur_h:
        new_h = int(oh * (cur_w / ow))
        pad = (cur_h - new_h) // 2
        return cur_h - 2 * pad, cur_w, pad, 0
    new_w = int(ow * (cur_h / oh))
    pad = (cur_w - new_w) // 2
    return cur_h, cur_w - 2 * pad, 0, pad


def anyres_index_plan(
    image_size: Tuple[int, int],        # (width, height) of the original image
    grid_pinpoints,
    *,
    tile_size: int = 336,
    patch_side: int = 24,
    merge_type: str = "spatial_unpad",
) -> Tuple[np.ndarray, int]:
    """(indices (N,) int32 into the sample's flat feature buffer, newline
    index = n_tiles * patch_side^2). The base tile's rows come first; then
    'flat': every grid tile's rows in order; 'spatial': the grid's cells
    row-major; 'spatial_unpad': the unpadded cells row-major with the
    newline index closing every row."""
    npw, nph = get_anyres_image_grid_shape(image_size, grid_pinpoints, tile_size)
    n_tiles = 1 + npw * nph
    per_tile = patch_side * patch_side
    newline = n_tiles * per_tile
    base = np.arange(per_tile, dtype=np.int32)
    if merge_type == "flat":
        return np.arange(n_tiles * per_tile, dtype=np.int32), newline
    if not merge_type.startswith("spatial"):
        raise ValueError(f"unknown mm_patch_merge_type {merge_type!r}")
    if "unpad" in merge_type:
        hp, wp, top, left = unpadded_hw(image_size, nph, npw, patch_side)
    else:
        hp, wp, top, left = nph * patch_side, npw * patch_side, 0, 0
    gy = np.arange(hp)[:, None] + top
    gx = np.arange(wp)[None, :] + left
    tile = 1 + (gy // patch_side) * npw + gx // patch_side
    grid = tile * per_tile + (gy % patch_side) * patch_side + gx % patch_side
    if "unpad" in merge_type:
        grid = np.concatenate([grid, np.full((hp, 1), newline)], axis=1)
    return np.concatenate([base, grid.reshape(-1).astype(np.int32)]), newline


def anyres_token_count(
    image_size: Tuple[int, int], grid_pinpoints, *, tile_size: int = 336,
    patch_side: int = 24, merge_type: str = "spatial_unpad",
) -> int:
    """The number of image positions `anyres_index_plan` gives the sample."""
    idx, _ = anyres_index_plan(image_size, grid_pinpoints, tile_size=tile_size,
                               patch_side=patch_side, merge_type=merge_type)
    return int(idx.shape[0])
