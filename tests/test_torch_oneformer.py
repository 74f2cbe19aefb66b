"""OneFormer mask decoding in visper_lm_tpu_torch vs the JAX package's on the
CPU (models/teachers/oneformer.py), on tests/test_oneformer.py's tiny HF
OneFormerForUniversalSegmentation (random init, seed 0): one numpy state dict
imported by both packages (the trees bit-equal), then `get_masks` with and
without the backbone-last-feature substitution (class and mask logits,
rtol = atol = 1e-4 through the Swin backbone, the deformable encoder and the
masked decoder, in f32: one ulp can flip a mask threshold in bf16), the port
against HF itself at test_oneformer.py's 2e-3, `semantic_segmentation` (the
scores at 1e-5, the map wherever the top-two margin exceeds 1e-4),
`configs_from_hf`, and the port's seeded init at ONEFORMER_COCO's shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu.checkpoint.hf_import import torch_state_dict_to_numpy
from visper_lm_tpu.models.teachers import oneformer as jof
from visper_lm_tpu.models.teachers import swin as jswin

from visper_lm_tpu_torch.config import dataclass_from_dict
from visper_lm_tpu_torch.models.teachers import oneformer as tof
from visper_lm_tpu_torch.models.teachers import swin as tswin
from visper_lm_tpu_torch.weights import module_to_jax_tree, oneformer_from_jax_params

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    from transformers import OneFormerConfig, SwinConfig as HFSwinConfig
    from transformers.models.oneformer.modeling_oneformer import OneFormerForUniversalSegmentation

    backbone = HFSwinConfig(
        image_size=64, patch_size=4, embed_dim=8, depths=[1, 1, 1, 1], num_heads=[1, 2, 2, 4],
        window_size=2, drop_path_rate=0.0, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, out_features=["stage1", "stage2", "stage3", "stage4"],
    )
    hf_cfg = OneFormerConfig(
        backbone_config=backbone, conv_dim=32, mask_dim=32, hidden_dim=32,
        encoder_feedforward_dim=48, dim_feedforward=48, num_queries=6, encoder_layers=2,
        decoder_layers=3, num_attention_heads=4, dropout=0.0, task_seq_len=77,
        text_encoder_n_ctx=16, max_seq_len=77, use_auxiliary_loss=False, num_labels=9,
    )
    torch.manual_seed(0)
    hf = OneFormerForUniversalSegmentation(hf_cfg).eval()
    sd = torch_state_dict_to_numpy(hf.state_dict())
    sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
    jcfg = jof.OneFormerDecoderConfig(
        d_model=32, encoder_layers=2, decoder_layers=3, query_dec_layers=2, dim_feedforward=48,
        num_heads=4, num_queries=6, num_classes=9, num_feature_levels=3, num_points=4,
        backbone_dims=(8, 16, 32, 64))
    tcfg = tof.OneFormerDecoderConfig(**dataclasses.asdict(jcfg))
    jswin_cfg = jswin.SwinConfig(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 4),
                                 window_size=2)
    tswin_cfg = tswin.SwinConfig(**dataclasses.asdict(jswin_cfg))
    prefix = "pixel_level_module.encoder."
    jdec = jof.import_oneformer_decoder(sd, jcfg)
    jsw = jswin.import_swin_backbone(sd, jswin_cfg, prefix=prefix)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    tree = tof.import_oneformer_decoder(tsd, tcfg)
    dec = oneformer_from_jax_params(tree, tcfg, device="cpu")
    sw = tswin.SwinBackbone(tswin_cfg)
    sw.load_state_dict(tswin.import_swin_backbone(tsd, tswin_cfg, prefix=prefix), strict=True)
    return dict(hf=hf, hf_cfg=hf_cfg, jcfg=jcfg, tcfg=tcfg, jdec=jdec, jsw=jsw, jswin_cfg=jswin_cfg,
                tree=tree, dec=dec, sw=sw.eval())


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    task = rng.integers(0, 100, size=(2, 77)).astype(np.float32)
    return img, task


def test_import_oneformer_decoder_bit_equal(models):
    ref = jax.tree_util.tree_flatten_with_path(models["jdec"], is_leaf=lambda x: x is None)[0]
    got = jax.tree_util.tree_flatten_with_path(models["tree"], is_leaf=lambda x: x is None)[0]
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        if b is None:
            assert a is None, path
        else:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    # identity projections (conv_dim == hidden_dim) stay None through the module
    assert models["tree"]["transformer_decoder"]["input_projections"] == [None] * 3
    back = module_to_jax_tree(models["dec"])
    flat = jax.tree_util.tree_flatten_with_path(back, is_leaf=lambda x: x is None)[0]
    assert [p for p, _ in flat] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(flat, ref):
        assert (a is None) == (b is None), path
        if b is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))


@pytest.mark.parametrize("substitute", [False, True], ids=["backbone", "substituted"])
def test_get_masks_matches_jax(models, substitute):
    img, task = _inputs()
    sub = None
    if substitute:   # a predicted (B, 4, 4, C) map resized onto the 2 x 2 last stage
        sub = np.random.default_rng(1).normal(size=(2, 4, 4, 64)).astype(np.float32)
    run = jax.jit(jof.get_masks, static_argnums=(1, 3))
    ref = run(models["jdec"], models["jcfg"], models["jsw"], models["jswin_cfg"],
              jnp.asarray(img), jnp.asarray(task), None if sub is None else jnp.asarray(sub))
    got = tof.get_masks(models["dec"], models["tcfg"], models["sw"], torch.from_numpy(img),
                        torch.from_numpy(task),
                        backbone_last_feature=None if sub is None else torch.from_numpy(sub))
    for k in ("class_queries_logits", "masks_queries_logits"):
        assert tuple(got[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k, **TOL)
    if not substitute:   # and HF itself, at test_oneformer.py's tolerances
        with torch.no_grad():
            hf = models["hf"](pixel_values=torch.from_numpy(img.transpose(0, 3, 1, 2)).contiguous(),
                              task_inputs=torch.from_numpy(task))
        np.testing.assert_allclose(got["class_queries_logits"].numpy(),
                                   hf.class_queries_logits.numpy(), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(got["masks_queries_logits"].numpy(),
                                   hf.masks_queries_logits.numpy(), rtol=2e-3, atol=3e-3)


def test_semantic_segmentation_matches_jax():
    rng = np.random.default_rng(1)
    classes = rng.normal(size=(2, 6, 10)).astype(np.float32)
    masks = rng.normal(size=(2, 6, 16, 16)).astype(np.float32)
    for hw in (None, (32, 24)):
        ref = np.asarray(jof.semantic_segmentation(jnp.asarray(classes), jnp.asarray(masks), hw))
        labels = tof.semantic_segmentation(torch.from_numpy(classes), torch.from_numpy(masks), hw)
        # the scores both take the argmax of, in numpy from JAX's resize
        if hw is not None:
            from visper_lm_tpu.utils.image import resize_bilinear

            m = np.asarray(resize_bilinear(jnp.asarray(masks.transpose(0, 2, 3, 1)), hw,
                                           align_corners=False)).transpose(0, 3, 1, 2)
        else:
            m = masks
        e = np.exp(classes - classes.max(-1, keepdims=True))
        probs = (e / e.sum(-1, keepdims=True))[..., :-1]
        want = np.einsum("bqc,bqhw->bchw", probs, 1 / (1 + np.exp(-m)))
        top2 = np.sort(want, axis=1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 1e-4
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(labels.numpy()[clear], ref[clear])
        np.testing.assert_array_equal(labels.numpy()[clear], want.argmax(1)[clear])


def test_configs_from_hf_match_jax(models):
    d = models["hf_cfg"].to_dict()
    jd, js = jof.configs_from_hf(d)
    td, ts = tof.configs_from_hf(d)
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert dataclasses.asdict(tof.ONEFORMER_COCO) == dataclasses.asdict(jof.ONEFORMER_COCO)
    assert dataclass_from_dict(tof.OneFormerDecoderConfig, dataclasses.asdict(jd)) == td


def test_seeded_init_at_coco_shapes():
    """The port's seeded init builds the COCO decoder the importer's tree
    shapes describe (150 queries, 133 classes + 1, 6 + 9 layers) and runs
    get_masks over a Swin of Swin-L's widths with a substituted feature."""
    cfg = tof.ONEFORMER_COCO
    gen = torch.Generator().manual_seed(0)
    dec = tof.init_oneformer(cfg, generator=gen, device="cpu")
    tree = module_to_jax_tree(dec)
    assert tree["transformer_decoder"]["queries_embedder"].shape == (150, 256)
    assert tree["transformer_decoder"]["class_embed"]["kernel"].shape == (256, 134)
    assert len(tree["pixel_decoder"]["encoder_layers"]) == 6
    assert len(tree["transformer_decoder"]["decoder_layers"]) == 9
    assert tree["pixel_decoder"]["input_projections"][0]["proj"]["kernel"].shape == (1536, 256)
    assert tree["pixel_decoder"]["output_convs"][0]["conv"]["kernel"].shape == (3, 3, 256, 256)
    again = oneformer_from_jax_params(tree, cfg, device="cpu")
    for (n, a), (_, b) in zip(dec.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), n
    sw_cfg = tswin.SwinConfig(embed_dim=192, depths=(1, 1, 1, 1), num_heads=(6, 12, 24, 48),
                              window_size=2)
    sw = tswin.SwinBackbone(sw_cfg)
    tswin.init_swin_(sw, gen)
    img = torch.randn(1, 64, 64, 3, generator=gen)
    sub = torch.randn(1, 3, 3, 1536, generator=gen)
    out = tof.get_masks(dec, cfg, sw.eval(), img, torch.zeros(1, 77), backbone_last_feature=sub)
    assert out["class_queries_logits"].shape == (1, 150, 134)
    assert out["masks_queries_logits"].shape == (1, 150, 2, 2)   # all on the last grid
    assert torch.isfinite(out["masks_queries_logits"]).all()
