"""The visual-interpretation path of visper_lm_tpu_torch vs the JAX package's
on the CPU, on `tiny_test_vlm(distill=True)` with JAX's init carried over by
`weights.from_jax_params`:

  * `VisperModel.get_visual_interpretations`: every task / layer prediction
    (rtol = atol = 1e-4: the decoder's and the heads' f32 sums);
  * `DistillVizHook`: its depth maps against the maps JAX's hook renders
    (1e-4), the same files, PNG pixels within one level of JAX's;
  * `load_viz_decoders`, `visualize_interpretations` and `demo.main` one-shot
    over a teachers dir of JAX-packed bundles: the manifest's keys and file
    names equal to JAX's, every .npy within 1e-4, the depth PNGs within one
    level, >= 99 % of the seg PNGs' pixels equal (an argmax may tie), the gen
    PNGs of the same shape (the pipelines draw their noise differently:
    tests/test_torch_genpipe.py holds generation on the same draws);
  * `build_ui` under tests/test_demo_ui.py's gradio stub;
  * the bundles: the port's packers against JAX's on the same .pth / HF /
    diffusers sources (the .npz arrays equal), bundles packed by the port from
    its modules equal to the JAX-packed ones they were loaded from and loaded
    by JAX's `load_viz_decoders`;
  * checkpoint/delta.py against JAX's, a bf16 model round-tripping bit for
    bit, and `consolidate` of the port's checkpoint format.

The spec: tests/test_demo_viz.py, test_demo_ui.py, test_viz_hook.py and
test_fid_delta.py.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from visper_lm_tpu import demo as jdemo
from visper_lm_tpu.api import VisperModel as JVisperModel
from visper_lm_tpu.checkpoint import delta as jdelta
from visper_lm_tpu.checkpoint import teacher_bundles as jtb
from visper_lm_tpu.config import tiny_test_vlm as jtiny
from visper_lm_tpu.constants import IMAGE_TOKEN_INDEX
from visper_lm_tpu.data.collate import build_splice_plan, collate_plans
from visper_lm_tpu.models import genpipe as jgp
from visper_lm_tpu.models.teachers import oneformer as jof
from visper_lm_tpu.models.teachers import swin as jswin
from visper_lm_tpu.models.vlm import init_vlm
from visper_lm_tpu.train import viz as jviz
from visper_lm_tpu.train.optimizer import trainable_mask
from visper_lm_tpu.utils.param import partition_params, save_params_npz

from visper_lm_tpu_torch import demo as tdemo
from visper_lm_tpu_torch.api import VisperModel
from visper_lm_tpu_torch.checkpoint import delta as tdelta
from visper_lm_tpu_torch.checkpoint import teacher_bundles as ttb
from visper_lm_tpu_torch.config import tiny_test_vlm as ttiny
from visper_lm_tpu_torch.data.image_io import read_png, write_png
from visper_lm_tpu_torch.train import viz as tviz
from visper_lm_tpu_torch.weights import dpt_from_jax_params, from_jax_params

from test_data_pipeline import FakeTokenizer
from test_demo_ui import _stub_gradio
from test_genpipe import _synth_diffusers_sds
from test_torch_dpt import _dav2_state_dict, _jax_head

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


class FakeTok(FakeTokenizer):
    eos_token_id = 2


@pytest.fixture(scope="module")
def models():
    params = init_vlm(jax.random.PRNGKey(0), jtiny(distill=True))
    jm = JVisperModel(cfg=jtiny(distill=True), params=params, tokenizer=FakeTok(), context_len=256)
    cfg = ttiny(distill=True)
    tm = VisperModel(cfg=cfg, model=from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                                                    device="cpu"),
                     tokenizer=FakeTok(), context_len=256)
    return jm, tm, params


def _image(seed=0, size=(40, 48)):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 255, size + (3,), np.uint8))


def test_get_visual_interpretations_matches_jax(models):
    jm, tm, _ = models
    img = _image()
    ref = jm.get_visual_interpretations("what is in the image?", img)
    got = tm.get_visual_interpretations("what is in the image?", img)
    assert sorted(got) == sorted(ref) == ["depth", "gen", "seg"]
    for task in ref:
        assert sorted(got[task]) == sorted(ref[task]), task
        for layer, want in ref[task].items():
            assert got[task][layer].shape == want.shape and got[task][layer].dtype == np.float32
            np.testing.assert_allclose(got[task][layer], want, err_msg=f"{task}/{layer}", **TOL)
    # the same from a uint8 array (no PIL on the card)
    again = tm.get_visual_interpretations("what is in the image?", np.asarray(img))
    for task in got:
        for layer in got[task]:
            np.testing.assert_array_equal(again[task][layer], got[task][layer])


def test_distill_viz_hook_matches_jax(models, tmp_path):
    jm, tm, params = models
    cfg_j = jtiny(distill=True)
    trainable, frozen = partition_params(params, trainable_mask(params, "pretrain"))
    dpt_tree = _jax_head(24, (8, 8, 8, 8), 8, seed=1)
    plans = [build_splice_plan([1, 2, IMAGE_TOKEN_INDEX, 5, 6], None, 32,
                               num_image_tokens=cfg_j.num_image_tokens,
                               num_task_tokens=cfg_j.distill.num_task_tokens, num_tasks=3)]
    images = np.random.default_rng(0).normal(size=(1, 28, 28, 3)).astype(np.float32)
    batch = collate_plans(plans, images=images)

    class JState:
        pass

    jstate = JState()
    jstate.params = trainable
    jhook = jviz.DistillVizHook(cfg_j, str(tmp_path / "jax"), frozen, dpt_tree, every=2)
    jhook(2, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    keys = ("images", "text_ids", "token_type", "src_index", "seq_lengths")
    ref = np.asarray(jhook._fn(trainable, frozen, dpt_tree,
                               {k: jnp.asarray(batch[k]) for k in keys}))

    class TState:
        model = tm.model

    thook = tviz.DistillVizHook(tm.cfg, str(tmp_path / "port"), dpt_from_jax_params(dpt_tree, "cpu"),
                                every=2)
    assert thook(1, TState(), batch) is None          # not a multiple of `every`
    assert not os.path.exists(tmp_path / "port" / "viz")
    maps = thook(2, TState(), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert maps.shape == ref.shape
    assert maps.shape[:2] == (len(tm.cfg.distill.get_task("depth").layer_indices), 1)
    np.testing.assert_allclose(maps, ref, **TOL)
    files = sorted(os.listdir(tmp_path / "port" / "viz"))
    assert files == sorted(os.listdir(tmp_path / "jax" / "viz"))
    assert files == [f"depth_l{i}_step2.png" for i in range(maps.shape[0])]
    for f in files:
        a = read_png(str(tmp_path / "port" / "viz" / f)).astype(int)
        b = np.asarray(Image.open(tmp_path / "jax" / "viz" / f).convert("RGB")).astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, f


def test_save_image_grid_layout(tmp_path):
    imgs = [np.random.default_rng(i).random((8, 8)) for i in range(5)]
    tviz.save_image_grid(imgs, str(tmp_path / "t.png"), cols=3)
    jviz.save_image_grid(imgs, str(tmp_path / "j.png"), cols=3)
    got = read_png(str(tmp_path / "t.png"))
    assert got.shape == (16, 24, 3)
    np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "j.png").convert("RGB")))


# ---------------------------------------------------------------------------
# Bundles, the demo and the UI
# ---------------------------------------------------------------------------


def _hf_oneformer(seed):
    from transformers import OneFormerConfig, SwinConfig as HFSwinConfig
    from transformers.models.oneformer.modeling_oneformer import OneFormerForUniversalSegmentation

    backbone = HFSwinConfig(
        image_size=64, patch_size=4, embed_dim=2, depths=[1, 1, 1, 1], num_heads=[1, 1, 1, 2],
        window_size=2, drop_path_rate=0.0, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, out_features=["stage1", "stage2", "stage3", "stage4"])
    hf_cfg = OneFormerConfig(
        backbone_config=backbone, conv_dim=32, mask_dim=32, hidden_dim=32,
        encoder_feedforward_dim=48, dim_feedforward=48, num_queries=4, encoder_layers=1,
        decoder_layers=2, num_attention_heads=2, dropout=0.0, task_seq_len=77,
        text_encoder_n_ctx=16, max_seq_len=77, use_auxiliary_loss=False, num_labels=5)
    torch.manual_seed(seed)
    return OneFormerForUniversalSegmentation(hf_cfg).eval()


def _tiny_gen_cfg(m):
    g = m.tiny_genpipe_config()
    return dataclasses.replace(g, embed_dim=24, unet=dataclasses.replace(
        g.unet, projection_class_embeddings_input_dim=48))


@pytest.fixture(scope="module")
def teachers_dir(tmp_path_factory):
    """test_demo_viz.py's teachers dir, packed by the JAX package: DPT at the
    depth head's 24, a tiny OneFormer (HF weights through JAX's importers),
    a tiny unCLIP pipeline at the gen head's 24; biases drawn so that no
    decoder is trivially zero."""
    from visper_lm_tpu.checkpoint.hf_import import torch_state_dict_to_numpy

    td = tmp_path_factory.mktemp("teachers_jax")
    save_params_npz(str(td / "dav2_head.npz"), _jax_head(24, seed=1))
    sd = torch_state_dict_to_numpy(_hf_oneformer(0).state_dict())
    sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
    dec_cfg = jof.OneFormerDecoderConfig(
        d_model=32, encoder_layers=1, decoder_layers=2, query_dec_layers=2, dim_feedforward=48,
        num_heads=2, num_queries=4, num_classes=5, num_feature_levels=3, num_points=4,
        backbone_dims=(2, 4, 8, 16))
    swin_cfg = jswin.SwinConfig(embed_dim=2, depths=(1, 1, 1, 1), num_heads=(1, 1, 1, 2),
                                window_size=2)
    save_params_npz(str(td / "oneformer.npz"), {
        "dec": jof.import_oneformer_decoder(sd, dec_cfg),
        "swin": jswin.import_swin_backbone(sd, swin_cfg, prefix="pixel_level_module.encoder.")})
    (td / "oneformer.json").write_text(json.dumps({
        "decoder": dataclasses.asdict(dec_cfg), "swin": dataclasses.asdict(swin_cfg),
        "image_size": 64}))
    gcfg = _tiny_gen_cfg(jgp)
    save_params_npz(str(td / "genpipe.npz"), jgp.init_genpipe(jax.random.PRNGKey(2), gcfg))
    gd = jgp.genpipe_config_to_dict(gcfg)
    gd["num_inference_steps"] = 3
    (td / "genpipe.json").write_text(json.dumps(gd))
    return str(td)


def test_load_viz_decoders_discovers_all(models, teachers_dir):
    _, tm, _ = models
    dec = tdemo.load_viz_decoders(tm, model_dir=None, teachers_dir=teachers_dir, quiet=True)
    assert set(dec) == {"dpt", "oneformer", "genpipe"}
    assert dec["oneformer"]["cfg"].num_queries == 4 and dec["oneformer"]["image_size"] == 64
    assert dec["oneformer"]["swin_cfg"] == tdemo_swin_cfg()
    assert dec["genpipe"]["cfg"] == _tiny_gen_cfg(__import__(
        "visper_lm_tpu_torch.models.genpipe", fromlist=["x"]))
    assert dec["genpipe"]["num_inference_steps"] == 3
    assert all(p.dtype == torch.float32 and not p.requires_grad
               for d in (dec["dpt"], dec["oneformer"]["decoder"], dec["genpipe"]["pipe"])
               for p in d.parameters())
    # a missing decoder is reported and left out
    assert tdemo.load_viz_decoders(tm, None, None, quiet=True) == {}


def tdemo_swin_cfg():
    from visper_lm_tpu_torch.models.teachers.swin import SwinConfig

    return SwinConfig(embed_dim=2, depths=(1, 1, 1, 1), num_heads=(1, 1, 1, 2), window_size=2)


def _compare_outputs(got, ref, got_dir, ref_dir):
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert os.path.basename(got[key]) == os.path.basename(ref[key]), key
        if key.endswith(("_png", "_sem")):
            a = read_png(got[key]).astype(int)
            b = np.asarray(Image.open(ref[key]).convert("RGB")).astype(int)
            assert a.shape == b.shape, key
            if key.startswith("depth/"):
                assert np.abs(a - b).max() <= 1, key
            elif key.endswith("_sem"):
                assert (a == b).all(-1).mean() >= 0.99, key
        else:
            np.testing.assert_allclose(np.load(got[key]), np.load(ref[key]), err_msg=key, **TOL)


def test_visualize_interpretations_matches_jax(models, teachers_dir, tmp_path):
    jm, tm, _ = models
    img = _image(3, (40, 48))
    jdec = jdemo.load_viz_decoders(jm, None, teachers_dir, quiet=True)
    ref = jdemo.visualize_interpretations(jm, "describe", img, str(tmp_path / "jax"), **jdec)
    tdec = tdemo.load_viz_decoders(tm, None, teachers_dir, quiet=True)
    got = tdemo.visualize_interpretations(tm, "describe", np.asarray(img), str(tmp_path / "port"),
                                          **tdec)
    # every task rendered, every layer dumped
    for tcfg in tm.cfg.distill.tasks:
        for layer in tcfg.layer_indices:
            assert f"{tcfg.task}/{layer + 1}" in got
    assert {k.split("/")[0] for k in got if k.endswith(("_png", "_sem"))} == {"depth", "seg", "gen"}
    _compare_outputs(got, ref, tmp_path / "port", tmp_path / "jax")
    for key in got:
        if key.startswith("gen/") and key.endswith("_png"):
            assert read_png(got[key]).shape == (16, 16, 3)


def test_depth_pyramid_uses_intermediate_mlps(models):
    jm, tm, _ = models
    tcfg = [t for t in tm.cfg.distill.tasks if t.task == "depth"][0]
    emb = np.random.default_rng(0).normal(size=(1, 4, 24)).astype(np.float32)
    got = tdemo._depth_pyramid(tm, tcfg.layer_indices[0], emb)
    ref = jdemo._depth_pyramid(jm, tcfg.layer_indices[0], emb)
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_array_equal(got[3].numpy(), emb)
    assert all(torch.equal(f, torch.from_numpy(emb)) for f in tdemo._depth_pyramid(tm, 99, emb))


def test_demo_main_one_shot_viz(models, teachers_dir, tmp_path, capsys):
    jm, tm, _ = models
    img_path = tmp_path / "in.png"
    write_png(str(img_path), np.full((40, 40, 3), (10, 200, 30), np.uint8))
    out_dir = tmp_path / "out"
    tdemo.main(["--image", str(img_path), "--question", "what is this?", "--viz",
                "--teachers", teachers_dir, "--out-dir", str(out_dir)], model=tm)
    printed = capsys.readouterr().out
    manifest = json.loads(printed[printed.index("{"):])
    ref = jdemo.visualize_interpretations(
        jm, "what is this?", Image.open(img_path).convert("RGB"), str(tmp_path / "jax"),
        **jdemo.load_viz_decoders(jm, None, teachers_dir, quiet=True))
    _compare_outputs(manifest, ref, out_dir, tmp_path / "jax")
    files = os.listdir(out_dir)
    assert any(f.startswith("depth_") and f.endswith(".png") for f in files)
    assert any(f.endswith("_sem.png") for f in files)
    assert any(f.startswith("gen_") and f.endswith(".png") for f in files)
    for f in files:
        if f.endswith(".png"):
            assert read_png(str(out_dir / f)).ndim == 3


def test_build_ui_graph_and_handlers(models, teachers_dir, tmp_path):
    _, tm, _ = models
    gr = _stub_gradio()
    dec = tdemo.load_viz_decoders(tm, None, teachers_dir, quiet=True)
    ui, handlers = tdemo.build_ui(tm, gr, out_dir=str(tmp_path), decoders=dec, max_new_tokens=8)
    assert ui.kwargs.get("title") == "VisPer-LM TPU demo"
    assert [type(c).__name__ for c in gr._created] == ["Image", "ChatInterface", "Textbox",
                                                        "Button", "JSON"]
    assert gr._created[1].kwargs["fn"] is handlers["chat"]
    assert gr._created[1].kwargs["additional_inputs"] == [gr._created[0]]
    (click,) = gr._clicks
    assert click["fn"] is handlers["viz"]
    assert click["inputs"] == [gr._created[2], gr._created[0]] and click["outputs"] == [gr._created[4]]
    img = np.random.default_rng(0).integers(0, 255, (32, 32, 3), np.uint8)
    chunks = list(handlers["chat"]("describe the image", [], img))
    assert chunks
    for a, b in zip(chunks, chunks[1:]):
        assert b.startswith(a)
    assert chunks[-1] == tm.chat(["describe the image"], [img], max_new_tokens=8)[0]
    assert list(handlers["chat"]("hi", [], None)) == ["Please upload an image first."]
    assert handlers["viz"]("what is here?", None) == {}
    manifest = handlers["viz"]("what is here?", img)
    assert any(k.endswith("_sem") for k in manifest)

    class Boom:
        def chat(self, *a, **kw):
            raise RuntimeError("decode exploded")

    _, h2 = tdemo.build_ui(Boom(), _stub_gradio(), out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="decode exploded"):
        list(h2["chat"]("hi", [], img))


def _npz_equal(a_path, b_path):
    a, b = np.load(a_path), np.load(b_path)
    assert sorted(a.files) == sorted(b.files), (a_path, b_path)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_bundles_port_packed_equal_jax_packed_and_load_in_jax(models, teachers_dir, tmp_path):
    """The port's modules loaded from JAX's bundles, packed again by the
    port: the same .npz arrays and JSON; JAX's load_viz_decoders reads them."""
    jm, tm, _ = models
    dec = tdemo.load_viz_decoders(tm, None, teachers_dir, quiet=True)
    out = ttb.pack_modules(str(tmp_path), dpt=dec["dpt"], oneformer=dec["oneformer"],
                           genpipe=dec["genpipe"])
    assert sorted(out) == ["dpt", "genpipe", "oneformer"]
    for name in ("dav2_head", "oneformer", "genpipe"):
        _npz_equal(str(tmp_path / f"{name}.npz"), os.path.join(teachers_dir, f"{name}.npz"))
    for name in ("oneformer", "genpipe"):
        assert json.loads((tmp_path / f"{name}.json").read_text()) == json.loads(
            open(os.path.join(teachers_dir, f"{name}.json")).read())
    jdec = jdemo.load_viz_decoders(jm, None, str(tmp_path), quiet=True)
    assert set(jdec) == {"dpt_params", "oneformer", "genpipe"}
    assert jdec["oneformer"]["cfg"].num_queries == 4 and jdec["genpipe"]["cfg"].embed_dim == 24


def test_packers_match_jax(models, tmp_path):
    """pack_dav2 (.pth), pack_oneformer (an HF directory) and pack_genpipe (a
    diffusers checkout) give JAX's bundles; the port also reads diffusers'
    diffusion_pytorch_model.safetensors names, and the HF OneFormer directory
    as the demo finds it."""
    from safetensors.numpy import save_file

    _, tm, _ = models
    src = tmp_path / "src"
    src.mkdir()
    sd = _dav2_state_dict(_jax_head(24, (8, 16, 16, 24), 16, seed=5), "depth_head.")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, src / "dav2.pth")
    hf_dir = src / "oneformer"
    _hf_oneformer(1).save_pretrained(hf_dir, safe_serialization=True)
    gcfg_j, gcfg_t = jgp.tiny_genpipe_config(), __import__(
        "visper_lm_tpu_torch.models.genpipe", fromlist=["x"]).tiny_genpipe_config()
    for name, comp in zip(("unet", "vae", "text_encoder", "image_normalizer"),
                          _synth_diffusers_sds(gcfg_j)):
        (src / "sd" / name).mkdir(parents=True)
        save_file({k: np.ascontiguousarray(v) for k, v in comp.items()},
                  str(src / "sd" / name / "model.safetensors"))
    for who, mod in (("jax", jtb), ("port", ttb)):
        mod.pack_dav2(str(src / "dav2.pth"), str(tmp_path / who))
        mod.pack_oneformer(str(hf_dir), str(tmp_path / who), image_size=64)
        mod.pack_genpipe(str(src / "sd"), str(tmp_path / who), cfg=gcfg_j if who == "jax" else gcfg_t,
                         num_inference_steps=4)
    for name in ("dav2_head", "oneformer", "genpipe"):
        _npz_equal(str(tmp_path / "port" / f"{name}.npz"), str(tmp_path / "jax" / f"{name}.npz"))
    for name in ("oneformer", "genpipe"):
        assert json.loads((tmp_path / "port" / f"{name}.json").read_text()) == json.loads(
            (tmp_path / "jax" / f"{name}.json").read_text())
    # diffusers' own file names, and the CLI
    for name in ("unet", "vae"):
        os.rename(src / "sd" / name / "model.safetensors",
                  src / "sd" / name / "diffusion_pytorch_model.safetensors")
    ttb.pack_genpipe(str(src / "sd"), str(tmp_path / "diffusers"), cfg=gcfg_t, num_inference_steps=4)
    _npz_equal(str(tmp_path / "diffusers" / "genpipe.npz"), str(tmp_path / "jax" / "genpipe.npz"))
    ttb.main(["--dav2", str(src / "dav2.pth"), "--oneformer", str(hf_dir), "--out",
              str(tmp_path / "cli")])
    assert sorted(os.listdir(tmp_path / "cli")) == ["dav2_head.npz", "oneformer.json",
                                                     "oneformer.npz"]
    _npz_equal(str(tmp_path / "cli" / "dav2_head.npz"), str(tmp_path / "jax" / "dav2_head.npz"))
    # the HF directory read as it is (zeros for the task text without its tokenizer)
    teachers = tmp_path / "teachers_hf"
    teachers.mkdir()
    os.symlink(hf_dir, teachers / "oneformer")
    dec = tdemo.load_viz_decoders(tm, None, str(teachers), quiet=True)
    assert dec["oneformer"]["cfg"].num_queries == 4 and dec["oneformer"]["swin_cfg"].embed_dim == 2
    assert dec["oneformer"]["task_inputs"].shape == (1, 77)


# ---------------------------------------------------------------------------
# checkpoint/delta.py
# ---------------------------------------------------------------------------


def test_delta_matches_jax():
    rng = np.random.default_rng(3)
    base = {"decoder": {"w": rng.normal(size=(4, 4)).astype(np.float32)},
            "embed": rng.normal(size=(10, 4)).astype(np.float32), "layers": [
                {"k": rng.normal(size=(3,)).astype(np.float32)}]}
    target = {
        "decoder": {"w": base["decoder"]["w"] + 1.0},
        "embed": np.concatenate([base["embed"] + 0.5, rng.normal(size=(2, 4)).astype(np.float32)]),
        "mm_projector": {"k": rng.normal(size=(4, 4)).astype(np.float32)},
        "layers": [{"k": base["layers"][0]["k"] * 2}],
    }
    ref = jdelta.make_delta(base, target)
    got = tdelta.make_delta(base, {k: v if k != "decoder" else {"w": torch.from_numpy(v["w"])}
                                   for k, v in target.items()})
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    back_j, back_t = jdelta.apply_delta(base, ref), tdelta.apply_delta(base, got)
    assert sorted(back_t) == sorted(back_j)
    for k in back_j:
        np.testing.assert_array_equal(back_t[k], back_j[k], err_msg=k)
    assert tdelta.unflatten(back_t).keys() == jdelta.unflatten(back_j).keys()
    restored = tdelta.unflatten(back_t)
    np.testing.assert_allclose(restored["embed"], target["embed"], rtol=1e-6)
    np.testing.assert_allclose(restored["layers"]["0"]["k"], target["layers"][0]["k"], rtol=1e-6)


def test_delta_of_modules_matches_jax_and_bf16_round_trips(models):
    """A port module flattens under JAX's paths: the heads' delta equals
    JAX's on the same trees; in bf16 the round trip is bit for bit."""
    _, tm, params = models
    cfg = ttiny(distill=True)
    jtarget = jax.tree_util.tree_map(lambda a: np.asarray(a) * 1.5 + 0.25, params)
    target = from_jax_params(jtarget, cfg, device="cpu")
    ref = jdelta.make_delta(params["heads"], jtarget["heads"])
    got = tdelta.make_delta(tm.model.heads, target.heads)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    base16, target16 = tm.model.heads.to(torch.bfloat16), target.heads.to(torch.bfloat16)
    back = tdelta.apply_delta(base16, tdelta.make_delta(base16, target16))
    want = tdelta.flat(target16)
    assert sorted(back) == sorted(want)
    for k in want:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    tm.model.heads.float()


def test_consolidate_port_checkpoint(tmp_path):
    from visper_lm_tpu_torch.train.checkpoint import CheckpointManager

    class State:
        def state_tensors(self):
            return {"params/heads.depth.0.resampler.proj_out.weight": torch.arange(6.).reshape(2, 3),
                    "params/decoder.blocks.0.q_proj.weight": torch.ones(2, 2),
                    "opt/mu.x": torch.zeros(1)}

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, State())
    tdelta.consolidate(str(tmp_path / "ckpt"), str(tmp_path / "flat.npz"))
    flat = np.load(tmp_path / "flat.npz")
    assert sorted(flat.files) == ["decoder/blocks/q_proj/kernel",
                                  "heads/depth/0/resampler/proj_out/kernel"]
    np.testing.assert_array_equal(flat["heads/depth/0/resampler/proj_out/kernel"],
                                  np.arange(6.).reshape(2, 3).T)
    with pytest.raises(FileNotFoundError):
        tdelta.consolidate(str(tmp_path / "empty"), str(tmp_path / "x.npz"))
