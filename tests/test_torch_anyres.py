"""anyres tiling (visper_lm_tpu_torch/data/anyres.py, `encode_images` on
tiles, the user API) vs the JAX package's on the CPU.

  * `unpadded_hw`, `anyres_index_plan` and `anyres_token_count` equal to
    JAX's exactly over tests/test_convnext_anyres.py's GRID and a sweep of
    image sizes, in every merge type, at CLIP-L's 336 / 24 and the tiny
    tower's 28 / 2;
  * `encode_images` on (B, n_tiles, H, W, 3) tiles with a drawn image_newline
    against JAX's, f32, rtol = atol = 1e-4, and the splice gathering the
    newline row; `vlm_forward` on tiles (the training forward) against JAX's;
  * the whole slice: `VisperModel.chat` on tiny_test_vlm with anyres +
    spatial_unpad and grid_pinpoints scaled to the tiny tower's 28 px tiles,
    two images of different tile counts in one batch (the pad-and-remap
    path): greedy answers identical to JAX's; `serve` and a `ChatSession`
    (which squares the image) likewise.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from visper_lm_tpu import api as japi
from visper_lm_tpu import config as jconfig
from visper_lm_tpu.data import anyres as janyres
from visper_lm_tpu.models.vlm import encode_images as j_encode_images
from visper_lm_tpu.models.vlm import init_vlm as j_init_vlm

from visper_lm_tpu_torch import api as tapi
from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.constants import IMAGE_TOKEN_INDEX, SEG_IMAGE
from visper_lm_tpu_torch.data import anyres as tanyres
from visper_lm_tpu_torch.data.collate import build_splice_plan
from visper_lm_tpu_torch.models.vlm import encode_images, splice_embeddings
from visper_lm_tpu_torch.weights import from_jax_params

from test_data_pipeline import FakeTokenizer

torch.set_num_threads(2)

GRID = [(336, 672), (672, 336), (672, 672), (1008, 336), (336, 1008)]
TINY_GRID = [[28, 56], [56, 28], [56, 56]]
SIZES = [(900, 300), (300, 900), (1000, 500), (500, 1000), (900, 900), (400, 1200), (300, 1000),
         (640, 480), (1, 1), (17, 333), (1333, 751), (336, 336), (672, 671), (2000, 90)]
MERGES = ["flat", "spatial", "spatial_unpad"]


class FakeTok(FakeTokenizer):
    eos_token_id = 2


@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("grid,tile,side", [(GRID, 336, 24), (TINY_GRID, 28, 2)])
def test_index_plans_equal_jax(merge, grid, tile, side):
    for size in SIZES:
        kw = dict(tile_size=tile, patch_side=side, merge_type=merge)
        ref_idx, ref_nl = janyres.anyres_index_plan(size, grid, **kw)
        idx, nl = tanyres.anyres_index_plan(size, grid, **kw)
        assert nl == ref_nl, size
        assert idx.dtype == np.int32 and np.array_equal(idx, ref_idx), size
        assert tanyres.anyres_token_count(size, grid, **kw) == janyres.anyres_token_count(
            size, grid, **kw)


def test_index_plans_accept_the_string_grid():
    text = "[[336,672],[672,336],[672,672],[1008,336],[336,1008]]"
    for size in SIZES:
        assert np.array_equal(tanyres.anyres_index_plan(size, text)[0],
                              janyres.anyres_index_plan(size, GRID)[0])


def test_unpadded_hw_equals_jax():
    for w in (1, 7, 300, 333, 900, 1001):
        for h in (1, 5, 300, 672, 1000):
            for gh, gw in ((1, 2), (2, 1), (2, 2), (1, 3), (3, 1)):
                for side in (2, 24):
                    assert tanyres.unpadded_hw((w, h), gh, gw, side) == janyres.unpadded_hw(
                        (w, h), gh, gw, side)


@pytest.fixture(scope="module")
def anyres_models():
    cfg_j = dataclasses.replace(jconfig.tiny_test_vlm(distill=True), image_aspect_ratio="anyres",
                                mm_patch_merge_type="spatial_unpad")
    cfg_t = dataclasses.replace(tconfig.tiny_test_vlm(distill=True), image_aspect_ratio="anyres",
                                mm_patch_merge_type="spatial_unpad")
    params = jax.tree_util.tree_map(np.asarray, j_init_vlm(jax.random.PRNGKey(0), cfg_j))
    assert not np.asarray(params["image_newline"]).any()        # JAX inits it to zeros
    params["image_newline"] = np.random.default_rng(1).normal(
        size=params["image_newline"].shape).astype(np.float32)
    model = from_jax_params(params, cfg_t, device="cpu")
    tok = FakeTok()
    return (japi.VisperModel(cfg=cfg_j, params=params, tokenizer=tok, context_len=256,
                             grid_pinpoints=TINY_GRID),
            tapi.VisperModel(cfg=cfg_t, model=model, tokenizer=tok, context_len=256,
                             grid_pinpoints=TINY_GRID))


def test_encode_tiles_with_newline_equals_jax(anyres_models):
    jm, tm = anyres_models
    tiles = np.random.default_rng(2).normal(size=(2, 3, 28, 28, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: j_encode_images(p, jm.cfg, x))(jm.params, tiles)
    with torch.no_grad():
        got = encode_images(tm.model, torch.from_numpy(tiles))
    per_tile = tm.cfg.vision.num_patches
    assert got.shape == (2, 3 * per_tile + 1, tm.cfg.decoder.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    assert torch.equal(got[:, -1], tm.model.image_newline.detach().expand(2, -1))

    # a plan whose third image slot is the newline row splices the newline
    indices = np.array([0, 1, 3 * per_tile, 2], dtype=np.int32)
    plan = build_splice_plan([1, IMAGE_TOKEN_INDEX, 5], None, 16, num_image_tokens=4,
                             image_feature_indices=[indices])
    with torch.no_grad():
        emb = splice_embeddings(tm.model, torch.from_numpy(plan.text_ids)[None].long(),
                                torch.from_numpy(plan.token_type)[None],
                                torch.from_numpy(plan.src_index)[None].long(), got[:1])
    assert torch.equal(emb[0, 3], tm.model.image_newline.detach())


@pytest.mark.parametrize("merge", ["flat", "spatial_unpad"])
def test_vlm_forward_on_tiles_equals_jax(anyres_models, merge):
    """The training forward takes tiles as bench.py's --anyres-tiles cell
    does: (B, 1 + n, H, W, 3) through the tower in one batch, a gather plan
    per sample (each image's own index plan here); logits and taps within
    rtol 1e-3 / atol 1e-4 of JAX's vlm_forward."""
    from visper_lm_tpu.models.vlm import vlm_forward as j_vlm_forward
    from visper_lm_tpu_torch.data.collate import collate_plans
    from visper_lm_tpu_torch.models.vlm import vlm_forward

    jm, tm = anyres_models
    imgs = _images([(40, 80), (80, 40)], seed=7)             # 3 tiles each
    tiles, _ = tm.anyres_inputs(imgs)
    plans = []
    for i, im in enumerate(imgs):
        idx = tanyres.anyres_index_plan((im.shape[1], im.shape[0]), TINY_GRID, tile_size=28,
                                        patch_side=2, merge_type=merge)[0]
        ids = [1, 5 + i, IMAGE_TOKEN_INDEX, 7, 8, 9 + i]
        plans.append(build_splice_plan(ids, ids, 64, num_image_tokens=len(idx),
                                       num_task_tokens=2, num_tasks=3,
                                       image_feature_indices=[idx]))
    batch = collate_plans(plans, images=np.stack(tiles))
    assert batch["images"].shape == (2, 3, 28, 28, 3)
    ref = j_vlm_forward(jm.params, jm.cfg, {k: jax.numpy.asarray(v) for k, v in batch.items()},
                        use_pallas=False)
    with torch.no_grad():
        out = vlm_forward(tm.model, tm.cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(ref["logits"]),
                               rtol=1e-3, atol=1e-4)
    for g, r in zip(out["taps"], ref["taps"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3, atol=1e-4)


def _images(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]


def test_chat_batch_pads_tiles_and_remaps_the_newline(anyres_models):
    _, tm = anyres_models
    imgs = _images([(40, 80), (60, 60)], seed=3)          # 2 x 1 grid (3 tiles), 2 x 2 (5 tiles)
    batch = tm.chat_batch(["what?", "and this one?"], imgs)
    assert batch["images"].shape == (2, 5, 28, 28, 3)
    assert not batch["images"][0, 3:].any() and batch["images"][1, 4].any()
    tiles, own = tm.anyres_inputs(imgs)
    assert [t.shape[0] for t in tiles] == [3, 5]
    per_tile = tm.cfg.vision.num_patches
    for i, (t, idx) in enumerate(zip(tiles, own)):
        src = batch["src_index"][i][batch["token_type"][i] == SEG_IMAGE]
        assert np.array_equal(src, np.where(idx == t.shape[0] * per_tile, 5 * per_tile, idx))
        assert (src == 5 * per_tile).sum() > 0


def test_chat_greedy_answers_equal_jax(anyres_models):
    jm, tm = anyres_models
    imgs = _images([(40, 80), (60, 60), (90, 30)], seed=4)
    qs = ["what color?", "how many objects are in this picture?", "describe it"]
    ref = jm.chat(qs, [Image.fromarray(a) for a in imgs], max_new_tokens=6)
    out = tm.chat(qs, imgs, max_new_tokens=6)
    assert out == ref
    assert all(len(t.split()) == 6 for t in out)


def test_serve_answers_equal_jax_and_chat(anyres_models):
    jm, tm = anyres_models
    imgs = _images([(40, 80), (60, 60), (30, 70)], seed=5)
    qs = ["what color?", "how many objects are in this picture?", "is it red?"]
    ref = jm.serve(qs, [Image.fromarray(a) for a in imgs], max_new_tokens=5, num_slots=2)
    out = tm.serve(qs, imgs, max_new_tokens=5, num_slots=2)
    assert out == ref
    assert out == [tm.chat([q], [im], max_new_tokens=5)[0] for q, im in zip(qs, imgs)]


def test_chat_session_squares_an_anyres_image_as_jax_does(anyres_models):
    jm, tm = anyres_models
    img = _images([(40, 80)], seed=6)[0]
    sj, st = jm.chat_session(Image.fromarray(img)), tm.chat_session(img)
    assert st._pixels.shape == (1, 28, 28, 3)
    np.testing.assert_array_equal(st._pixels, np.asarray(sj._pixels))
    for q in ["what color?", "how many?"]:
        assert st.ask(q, max_new_tokens=4) == sj.ask(q, max_new_tokens=4)
