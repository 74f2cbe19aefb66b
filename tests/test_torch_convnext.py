"""The ConvNeXt tower (visper_lm_tpu_torch/models/convnext.py) vs the JAX
package's on the CPU.

The tiny trunk of tests/test_convnext_anyres.py (dims 8/16/32/64, depths
1/1/2/1, 64 px), f32, JAX's init_convnext with every layer-scale gamma drawn
from N(0, 0.1^2) (at JAX's 1e-6 every block is the identity and a wrong
block would pass), carried over by weights.py:
  * `convnext_forward` (and each stage's map) and `convnext_tower_features`
    with and without interp_tokens: rtol = atol = 3e-4, the JAX test's bound;
  * the OpenCLIP / timm import and export: bit-equal to JAX's, alone and
    inside a whole VLM checkpoint (export_vlm / import_vlm / to_model);
  * a VLM with the tiny trunk: `encode_images`, and `VisperModel.chat`'s
    greedy answers equal to JAX's Generator on the port's chat batch;
  * `convnext_flops` equal to JAX's; C12: what JAX's chat hands the XXL
    trunk (CLIP-size pixels) against the port's (768 px), by shapes only.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from visper_lm_tpu import api as japi
from visper_lm_tpu import config as jconfig
from visper_lm_tpu.checkpoint import hf_export as jexp
from visper_lm_tpu.data import mm_utils as jmm
from visper_lm_tpu.models import convnext as jcx
from visper_lm_tpu.models.vlm import encode_images as j_encode_images
from visper_lm_tpu.models.vlm import init_vlm as j_init_vlm
from visper_lm_tpu.serve import generate as jgen
from visper_lm_tpu.utils import diagnostics as jdiag

from visper_lm_tpu_torch import api as tapi
from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.checkpoint import hf_export as texp
from visper_lm_tpu_torch.checkpoint import hf_import as timp
from visper_lm_tpu_torch.models import convnext as tcx
from visper_lm_tpu_torch.models.vlm import encode_images, init_vlm
from visper_lm_tpu_torch.utils import diagnostics as tdiag
from visper_lm_tpu_torch.weights import convnext_tree_to_state_dict, from_jax_params

from test_data_pipeline import FakeTokenizer

torch.set_num_threads(2)
TOL = dict(rtol=3e-4, atol=3e-4)


class FakeTok(FakeTokenizer):
    eos_token_id = 2


def _tiny_cx(c):
    return c.ConvNeXtConfig(image_size=64, depths=(1, 1, 2, 1), dims=(8, 16, 32, 64),
                            dtype="float32")


def _tiny_vlm_cfg(c, distill=True):
    base = c.tiny_test_vlm(distill=distill)
    return dataclasses.replace(
        c.with_convnext_tower(base), convnext=_tiny_cx(c),
        projector=dataclasses.replace(base.projector, input_dim=64))


def _draw_gammas(tree, seed):
    """Every block's gamma from N(0, 0.1^2), in place of JAX's 1e-6."""
    rng = np.random.default_rng(seed)
    for stage in tree["stages"]:
        g = np.asarray(stage["blocks"]["gamma"])
        stage["blocks"]["gamma"] = (0.1 * rng.standard_normal(g.shape)).astype(np.float32)
    return tree


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tower(tree, cfg):
    tower = tcx.ConvNeXt(cfg)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in convnext_tree_to_state_dict(tree).items()}
    tower.load_state_dict(sd, strict=True)
    return tower.eval()


@pytest.fixture(scope="module")
def trunk():
    cfg_j, cfg_t = _tiny_cx(jconfig), _tiny_cx(tconfig)
    tree = _draw_gammas(_numpy(jcx.init_convnext(jax.random.PRNGKey(0), cfg_j)), seed=1)
    images = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32)
    return cfg_j, cfg_t, tree, _tower(tree, cfg_t), images


def test_trunk_forward_and_stages_equal_jax(trunk):
    cfg_j, _, tree, tower, images = trunk
    ref, ref_stages = jax.jit(
        lambda p, x: jcx.convnext_forward(p, cfg_j, x, return_stages=True))(tree, images)
    with torch.no_grad():
        out, stages = tcx.convnext_forward(tower, torch.from_numpy(images), return_stages=True)
    assert out.shape == (2, 2, 2, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    for s, (a, b) in enumerate(zip(stages, ref_stages)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=f"stage {s}")
    # the drawn gammas make every block's branch count
    assert float(np.abs(np.asarray(ref_stages[2])).max()) > 0.1


@pytest.mark.parametrize("interp_tokens", [None, 4, 9, 1])
def test_tower_features_equal_jax(trunk, interp_tokens):
    cfg_j, _, tree, tower, images = trunk
    ref = jax.jit(lambda p, x: jcx.convnext_tower_features(p, cfg_j, x, interp_tokens))(
        tree, images)
    with torch.no_grad():
        got = tcx.convnext_tower_features(tower, torch.from_numpy(images), interp_tokens)
    assert got.shape == ref.shape == (2, interp_tokens or 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_openclip_import_and_export_bit_equal_jax(trunk):
    cfg_j, cfg_t, tree, tower, _ = trunk
    timm = {k: np.asarray(v) for k, v in jcx.export_openclip_convnext(tree, cfg_j).items()}
    assert "visual.trunk.stages.2.blocks.1.mlp.fc1.weight" in timm
    assert "visual.trunk.stages.0.downsample.1.weight" not in timm
    ref = convnext_tree_to_state_dict(_numpy(jcx.import_openclip_convnext(timm, cfg_j)))
    got = tcx.import_openclip_convnext({k: torch.from_numpy(v.copy()) for k, v in timm.items()},
                                       cfg_t)
    assert sorted(got) == sorted(ref) == sorted(tower.state_dict())
    for k in ref:
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    back = tcx.export_openclip_convnext(tower.state_dict(), cfg_t)
    assert sorted(back) == sorted(timm)
    for k in timm:
        assert back[k].dtype == torch.float32 and np.array_equal(back[k].numpy(), timm[k]), k


@pytest.fixture(scope="module")
def cx_vlm():
    cfg_j, cfg_t = _tiny_vlm_cfg(jconfig), _tiny_vlm_cfg(tconfig)
    params = _numpy(j_init_vlm(jax.random.PRNGKey(3), cfg_j))
    params["vision_tower"] = _draw_gammas(params["vision_tower"], seed=4)
    return cfg_j, cfg_t, params, from_jax_params(params, cfg_t, device="cpu")


def test_vlm_encode_images_equals_jax(cx_vlm):
    cfg_j, cfg_t, params, model = cx_vlm
    assert isinstance(model.vision_tower, tcx.ConvNeXt) and model.image_newline is None
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    images = np.random.default_rng(5).normal(size=(3, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: j_encode_images(p, cfg_j, x))(params, images)
    with torch.no_grad():
        got = encode_images(model, torch.from_numpy(images))
    assert got.shape == (3, cfg_t.num_image_tokens, cfg_t.decoder.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_vlm_checkpoint_export_import_bit_equal_jax(cx_vlm):
    cfg_j, cfg_t, params, model = cx_vlm
    ref = {k: np.asarray(v) for k, v in jexp.export_vlm(params, cfg_j).items()}
    got = texp.export_vlm(model, cfg_t)
    assert sorted(got) == sorted(ref)
    assert "model.vision_tower.vision_tower.stem.0.weight" in got
    for k in ref:
        assert np.array_equal(got[k].numpy(), ref[k]), k
    sd = timp.import_vlm({k: torch.from_numpy(v.copy()) for k, v in ref.items()}, cfg_t)
    back = timp.to_model(sd, cfg_t, device="cpu", dtype=None)
    own = model.state_dict()
    assert sorted(back.state_dict()) == sorted(own)
    for k, v in back.state_dict().items():
        assert torch.equal(v, own[k]), k


def test_npz_round_trip_with_jax_both_ways(tmp_path):
    """A ConvNeXt VLM with image_newline through the npz files: JAX's
    save_params_npz -> the port's load -> a model -> the port's save -> JAX's
    load gives the same tree (each stage's blocks stacked again), bytes equal."""
    from visper_lm_tpu.utils import param as jparam
    from visper_lm_tpu_torch.utils import param as tparam

    cfg_j = dataclasses.replace(_tiny_vlm_cfg(jconfig), mm_patch_merge_type="spatial_unpad")
    cfg_t = dataclasses.replace(_tiny_vlm_cfg(tconfig), mm_patch_merge_type="spatial_unpad")
    params = j_init_vlm(jax.random.PRNGKey(8), cfg_j)
    jparam.save_params_npz(str(tmp_path / "jax.npz"), params)
    model = from_jax_params(tparam.load_params_npz(str(tmp_path / "jax.npz")), cfg_t,
                            device="cpu")
    assert model.image_newline is not None
    tparam.save_params_npz(str(tmp_path / "port.npz"), model)
    back = jparam.load_params_npz(str(tmp_path / "port.npz"))
    ref = jax.tree_util.tree_flatten_with_path(params)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (k, a), (_, b) in zip(ref, got):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), k


def test_convnext_chat_equals_jax_generator_on_the_port_batch(cx_vlm):
    """The port's chat preprocesses at the trunk's 64 px (C12); JAX's
    Generator fed that same batch gives the same greedy answers."""
    cfg_j, cfg_t, params, model = cx_vlm
    tok = FakeTok()
    tm = tapi.VisperModel(cfg=cfg_t, model=model, tokenizer=tok, context_len=256)
    rng = np.random.default_rng(6)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((40, 70), (90, 33))]
    qs = ["what color?", "how many objects are in this picture?"]
    batch = tm.chat_batch(qs, imgs)
    assert batch["images"].shape == (2, 64, 64, 3)
    out = tm.chat(qs, imgs, max_new_tokens=6)
    jm = japi.VisperModel(cfg=cfg_j, params=params, tokenizer=tok, context_len=256)
    gen_cfg = jgen.GenerationConfig(max_new_tokens=6, eos_token_ids=tuple(jm._eos_ids()),
                                    stop_strings=tuple(jm.stop_strings()))
    gen = jgen.Generator(params, cfg_j, gen_cfg, len(qs), batch["text_ids"].shape[1])
    ref = gen.generate({k: jnp.asarray(v) for k, v in batch.items()}, tokenizer=tok)
    assert out == [t.strip() for t in ref]
    assert all(len(t.split()) == 6 for t in out)


def test_init_vlm_draws_the_trunk_as_jax_does():
    cfg = _tiny_vlm_cfg(tconfig)
    model = init_vlm(cfg, device="cpu", seed=0)
    tower = model.vision_tower
    blocks = [b for s in tower.stages for b in s.blocks]
    assert all(torch.equal(b.gamma, torch.full_like(b.gamma, 1e-6)) for b in blocks)
    dw = torch.cat([b.dwconv.weight.detach().flatten() for b in blocks])
    assert 0.01 < float(dw.std()) < 0.03
    assert all(torch.equal(b.dwconv.bias, torch.zeros_like(b.dwconv.bias)) for b in blocks)
    assert float(tower.stem_conv.weight.detach().abs().max()) <= 48 ** -0.5
    again = init_vlm(cfg, device="cpu", seed=0)
    for (n, a), (_, b) in zip(model.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("make", [lambda c: c.ConvNeXtConfig(), _tiny_cx])
def test_convnext_flops_equal_jax(make):
    assert tdiag.convnext_flops(make(tconfig)) == jdiag.convnext_flops(make(jconfig))
    cfg_t, cfg_j = tconfig.with_convnext_tower(tconfig.phi3_clip_vlm()), \
        jconfig.with_convnext_tower(jconfig.phi3_clip_vlm())
    assert tdiag.vision_flops(cfg_t) == jdiag.vision_flops(cfg_j)
    assert tdiag.train_step_flops(cfg_t, 4, 1024) == jdiag.train_step_flops(cfg_j, 4, 1024)


def test_c12_jax_chat_gives_the_xxl_trunk_clip_size_pixels():
    """ROADMAP C12. JAX's chat preprocesses at cfg.vision.image_size (336)
    whatever the tower; the 768-px XXL trunk then makes 10 x 10 = 100
    feature rows where the splice plan places 576 (rows 100-575 repeat row
    99 after splice_embeddings' clip). The port preprocesses at
    cfg.convnext.image_size: 576 rows. Shapes only (eval_shape / meta)."""
    cfg_j = jconfig.with_convnext_tower(jconfig.llama3_clip_vlm())
    cfg_t = tconfig.with_convnext_tower(tconfig.llama3_clip_vlm())
    img = np.random.default_rng(7).integers(0, 256, (300, 500, 3), dtype=np.uint8)
    # what JAX's VisperModel.chat computes for its pixels (api.py, non-anyres branch)
    j_pixels = jmm.process_images([Image.fromarray(img)], image_aspect_ratio="square",
                                  image_size=cfg_j.vision.image_size)
    assert np.asarray(j_pixels).shape == (1, 336, 336, 3)
    tree = jax.eval_shape(lambda: jcx.init_convnext(jax.random.PRNGKey(0), cfg_j.convnext))
    rows = jax.eval_shape(
        lambda p, x: jcx.convnext_tower_features(p, cfg_j.convnext, x), tree,
        jax.ShapeDtypeStruct((1, 336, 336, 3), jnp.float32)).shape[1]
    assert (rows, cfg_j.num_image_tokens) == (100, 576)

    tm = tapi.VisperModel(cfg=cfg_t, model=None, tokenizer=FakeTok())
    pixels = tm._pixels([img])
    assert pixels.shape == (1, 768, 768, 3) and tm.tower_geometry() == (768, 24)
    with torch.device("meta"):
        trunk = tcx.ConvNeXt(cfg_t.convnext)
        feats = tcx.convnext_tower_features(trunk, torch.empty(pixels.shape))
    assert feats.shape == (1, cfg_t.num_image_tokens, 3072)
