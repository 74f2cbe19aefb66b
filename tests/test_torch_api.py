"""The user API (visper_lm_tpu_torch/api.py) vs the JAX package's on the CPU.

tiny_test_vlm(distill=True) with JAX's init_vlm weights carried over (f32),
the fake tokenizers of tests/test_api.py, images from seeded uint8 arrays
(PIL images of the same arrays on the JAX side). Prompts and configs must be
equal; greedy answers of chat(), serve() and ChatSession identical (the fake
tokenizers decode ids to their numbers, so equal strings are equal tokens);
from_hf_checkpoint on a directory the JAX package wrote gives JAX's
prefill logits within 1e-4 absolute / 1e-3 relative (f32 through the tiny
decoder, as tests/test_torch_generate.py holds prefill logits).
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
from visper_lm_tpu.checkpoint.hf_export import save_hf_checkpoint as j_save_hf_checkpoint
from visper_lm_tpu.models.vlm import init_vlm as j_init_vlm
from visper_lm_tpu.serve import generate as jgen

from visper_lm_tpu_torch import api as tapi
from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.serve import generate as tgen
from visper_lm_tpu_torch.weights import from_jax_params

from test_api import RoundTripTok
from test_data_pipeline import FakeTokenizer

torch.set_num_threads(2)


class FakeTok(FakeTokenizer):
    eos_token_id = 2


def _images(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]


@pytest.fixture(scope="module")
def models():
    cfg_j = jconfig.tiny_test_vlm(distill=True)
    cfg_t = tconfig.tiny_test_vlm(distill=True)
    params = j_init_vlm(jax.random.PRNGKey(0), cfg_j)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    tok = FakeTok()
    return (japi.VisperModel(cfg=cfg_j, params=params, tokenizer=tok, context_len=256),
            tapi.VisperModel(cfg=cfg_t, model=model, tokenizer=tok, context_len=256))


@pytest.mark.parametrize("template", ["llava_phi_3", "llava_llama_3", "vicuna_v1", "plain"])
@pytest.mark.parametrize("with_image", [True, False])
def test_build_prompt_and_stops_equal_jax(models, template, with_image):
    jm, tm = models
    jm = dataclasses.replace(jm, cfg=dataclasses.replace(jm.cfg, conv_template=template))
    tm = dataclasses.replace(tm, cfg=dataclasses.replace(tm.cfg, conv_template=template))
    q = "what is in this picture?"
    assert tm.build_prompt(q, with_image) == jm.build_prompt(q, with_image)
    assert tm.stop_strings() == jm.stop_strings()
    assert tm._eos_ids() == jm._eos_ids()


def test_vicuna_prompt_golden():
    cfg = dataclasses.replace(tconfig.tiny_test_vlm(), conv_template="vicuna_v1",
                              num_sys_tokens=26)
    m = tapi.VisperModel(cfg=cfg, model=None, tokenizer=FakeTok())
    assert m.build_prompt("what is this?") == (
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the user's "
        "questions. USER: <image>\nwhat is this? ASSISTANT:"
    )
    assert m.stop_strings() == ["</s>"]


@pytest.mark.parametrize("aspect", ["square", "pad"])
def test_chat_greedy_answers_equal_jax(models, aspect):
    jm, tm = models
    jm = dataclasses.replace(jm, cfg=dataclasses.replace(jm.cfg, image_aspect_ratio=aspect))
    tm = dataclasses.replace(tm, cfg=dataclasses.replace(tm.cfg, image_aspect_ratio=aspect))
    imgs = _images([(40, 40), (30, 64), (57, 21)])
    qs = ["what color?", "how many objects are in this picture?", "describe it"]
    ref = jm.chat(qs, [Image.fromarray(a) for a in imgs], max_new_tokens=6)
    out = tm.chat(qs, imgs, max_new_tokens=6)
    assert out == ref
    assert all(len(t.split()) == 6 for t in out)


def test_chat_streams_the_answer_and_pil_images_give_the_same_answer(models):
    jm, tm = models
    img = _images([(48, 33)], seed=3)[0]
    deltas_j, deltas_t = [], []
    ref = jm.chat(["what is it?"], [Image.fromarray(img)], max_new_tokens=5,
                  stream_callback=deltas_j.append)
    out = tm.chat(["what is it?"], [img], max_new_tokens=5, stream_callback=deltas_t.append)
    assert out == ref and deltas_t == deltas_j
    assert "".join(deltas_t).strip() == out[0]
    assert tm.chat(["what is it?"], [Image.fromarray(img)], max_new_tokens=5) == out


def test_serve_answers_equal_jax_and_chat(models):
    jm, tm = models
    imgs = _images([(40, 40), (32, 64), (40, 40), (32, 64)], seed=1)
    qs = ["what color?", "how many objects are in this picture?", "describe the scene",
          "is it red?"]
    ref = jm.serve(qs, [Image.fromarray(a) for a in imgs], max_new_tokens=5, num_slots=2)
    out = tm.serve(qs, imgs, max_new_tokens=5, num_slots=2)
    assert out == ref
    assert out == [tm.chat([q], [im], max_new_tokens=5)[0] for q, im in zip(qs, imgs)]


def test_quantized_serving_shares_one_decoder_copy(models):
    """Generators and engines of every shape share the model's tower and one
    quantized decoder per mode; the caller's decoder is left as it was."""
    _, tm = models
    tm = dataclasses.replace(tm)
    assert not tm._gen_cache and not tm._serving_models
    before = tm.model.decoder.blocks[0].q_proj.weight.clone()
    imgs = _images([(40, 40), (30, 64)], seed=2)
    tm.chat(["a?"], imgs[:1], max_new_tokens=2, weight_quant=True)
    tm.chat(["a?", "b c?"], imgs, max_new_tokens=3, weight_quant=True)
    tm.serve(["a?"], imgs[:1], max_new_tokens=2, weight_quant=True)
    assert list(tm._serving_models) == ["int8"] and len(tm._gen_cache) == 2
    view = tm._serving_models["int8"]
    assert view.vision_tower is tm.model.vision_tower
    assert view.mm_projector is tm.model.mm_projector
    assert all(g.model is view for g in tm._gen_cache.values())
    assert type(view.decoder.blocks[0].q_proj).__name__ == "QuantLinear"
    assert torch.equal(tm.model.decoder.blocks[0].q_proj.weight, before)


@pytest.mark.parametrize("kv", [None, False, True])
@pytest.mark.parametrize("wq", [None, False, True, "int4"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_resolve_quant_follows_jax_rule(models, monkeypatch, kv, wq, device):
    """ROADMAP C11: JAX turns quantization on by itself only on a TPU; the
    port runs on none, so auto is off on the CPU and on CUDA alike (the
    model's device is faked: the rule must not read it). Per call and as
    the instance's defaults, every answer is JAX's under JAX_PLATFORMS=cpu."""
    jm, tm = models
    assert jax.default_backend() == "cpu"
    monkeypatch.setattr(tapi.VisperModel, "device", property(lambda self: torch.device(device)))
    assert tm._resolve_quant(kv, wq) == jm._resolve_quant(kv, wq)
    jd = dataclasses.replace(jm, kv_quant=kv, weight_quant=wq)
    td = dataclasses.replace(tm, kv_quant=kv, weight_quant=wq)
    assert td._resolve_quant(None, None) == jd._resolve_quant(None, None)
    assert td._resolve_quant(False, False) == (False, False)
    if kv is None and wq is None:
        assert tm._resolve_quant(kv, wq) == (False, False)


def test_grid_pinpoints_default_equals_jax(models):
    jm, tm = models
    assert tm.grid_pinpoints == jm.grid_pinpoints
    assert tapi.VisperModel(cfg=tm.cfg, model=None).grid_pinpoints == japi.VisperModel(
        cfg=jm.cfg, params=None).grid_pinpoints


def test_generator_cache_keeps_eight(models):
    _, tm = models
    tm = dataclasses.replace(tm)
    gens = [tm._generator(tgen.GenerationConfig(max_new_tokens=n), 1, 128) for n in range(1, 11)]
    assert len(tm._gen_cache) == 8
    assert tm._generator(tgen.GenerationConfig(max_new_tokens=10), 1, 128) is gens[-1]
    assert list(tm._gen_cache.values())[-1] is gens[-1]


def test_chat_session_equals_jax_and_prefills_only_each_turn(models):
    """With a round-trip-stable tokenizer turns 2-3 continue from the cached
    prefix: answers and tracked ids equal JAX's, and each later turn
    prefills only its own tokens."""
    jm, tm = models
    tok = RoundTripTok()
    jm = dataclasses.replace(jm, tokenizer=tok, context_len=512)
    tm = dataclasses.replace(tm, tokenizer=tok, context_len=512)
    img = _images([(40, 40)], seed=4)[0]
    sj, st = jm.chat_session(Image.fromarray(img)), tm.chat_session(img)
    stats = st.engine.stats
    for i, q in enumerate(["what color?", "how many?", "and then?"]):
        before, n_ids = stats["prefill_tokens"], len(st._ids)
        deltas = []
        a_t = st.ask(q, max_new_tokens=3, stream_callback=deltas.append)
        a_j = sj.ask(q, max_new_tokens=3)
        assert a_t == a_j
        assert st._ids == sj._ids
        assert "".join(deltas) == a_t
        if i:
            full = tapi.tokenizer_image_token(st.conv.get_prompt(), tok)
            # the conversation's prompt up to this reply: what was cached plus this turn
            turn = len(tapi.tokenizer_image_token(
                st.conv.get_prompt().rsplit(a_t, 1)[0], tok)) - n_ids
            assert stats["prefill_tokens"] - before == turn < len(full)
    assert st._turns == 3 and st._prefix is not None


def test_chat_session_falls_back_like_jax(models):
    """The fake tokenizer is not round-trip stable: each turn prefills the
    whole history, and the answers still equal JAX's."""
    jm, tm = models
    img = _images([(40, 40)], seed=5)[0]
    sj, st = jm.chat_session(Image.fromarray(img)), tm.chat_session(img)
    for q in ["what color?", "how many?"]:
        assert st.ask(q, max_new_tokens=4) == sj.ask(q, max_new_tokens=4)
    sj, st = jm.chat_session(), tm.chat_session()
    for q in ["hello there", "again please"]:
        assert st.ask(q, max_new_tokens=3) == sj.ask(q, max_new_tokens=3)


@pytest.mark.parametrize("make", [
    lambda c: c.llama3_clip_vlm(), lambda c: c.llama3_clip_vlm(distill=True),
    lambda c: c.vicuna_clip_vlm(distill=True), lambda c: c.with_convnext_tower(c.phi3_clip_vlm()),
    lambda c: c.probe_distill_config("gen", 32), lambda c: c.probe_distill_config("seg", 4),
    lambda c: c.probe_distill_config("depth", 24, pass_text_to_aux=False),
])
def test_presets_equal_jax(make):
    assert tconfig.config_to_json(make(tconfig)) == jconfig.config_to_json(make(jconfig))
    cfg = tconfig.config_from_json(tconfig.config_to_json(make(tconfig)))
    assert tconfig.config_to_json(cfg) == tconfig.config_to_json(make(tconfig))


@pytest.mark.parametrize("name", [
    "ola-vlm-phi3-dsg", "llava-v1.5-vicuna-7b", "ola-llama3-convnext-dsg", "llama3-8b",
    "vicuna-ola",
])
def test_config_for_model_name_equals_jax(name):
    assert (tconfig.config_to_json(tapi.config_for_model_name(name))
            == jconfig.config_to_json(japi.config_for_model_name(name)))


@pytest.mark.parametrize("hf", [
    dict(model_type="llava_llama", vocab_size=128256, hidden_size=4096, num_hidden_layers=32,
         num_attention_heads=32, num_key_value_heads=8, intermediate_size=14336,
         rope_theta=500000.0, max_position_embeddings=8192),
    dict(model_type="llava_phi", vocab_size=32064, hidden_size=3072, num_hidden_layers=32,
         num_attention_heads=32, intermediate_size=8192, image_aspect_ratio="pad",
         image_gen=dict(img_layer_indices=[12, 20], num_tokens=1, output_dim=1024),
         image_depth=dict(depth_layer_indices=[18, 20], depth_loss_weight=0.25),
         image_seg=dict(seg_layer_indices=[10, 18], num_heads=8), num_task_tokens=4),
    dict(model_type="llama", vocab_size=32000, hidden_size=4096, num_hidden_layers=32,
         num_attention_heads=32, intermediate_size=11008, mm_vision_tower="convnext_xxl",
         mm_patch_merge_type="spatial_unpad"),
])
def test_config_from_hf_json_equals_jax(hf):
    assert (tconfig.config_to_json(tapi.config_from_hf_json(hf))
            == jconfig.config_to_json(japi.config_from_hf_json(hf)))


@pytest.mark.parametrize("hf_cfg", [
    {}, {"mm_use_im_patch_token": False}, {"mm_use_im_start_end": True},
])
def test_fixup_tokenizer_equals_jax(hf_cfg):
    class Tok:
        def __init__(self):
            self.added = []

        def add_tokens(self, toks, special_tokens=False):
            self.added.append((tuple(toks), special_tokens))

    a, b = Tok(), Tok()
    assert tapi.fixup_tokenizer(a, hf_cfg) is a
    japi.fixup_tokenizer(b, hf_cfg)
    assert a.added == b.added
    assert tapi.fixup_tokenizer(None, hf_cfg) is None


def test_from_hf_checkpoint_of_a_jax_export_matches_jax(tmp_path):
    """A directory the JAX package wrote (f32 safetensors + visper_config):
    the port's from_hf_checkpoint gives JAX's config and prefill logits."""
    cfg = jconfig.tiny_test_vlm(distill=True)
    params = j_init_vlm(jax.random.PRNGKey(3), cfg)
    j_save_hf_checkpoint(str(tmp_path), params, cfg)
    tok = FakeTok()
    jm = japi.VisperModel.from_hf_checkpoint(str(tmp_path), tokenizer=tok, dtype=jnp.float32)
    tm = tapi.VisperModel.from_hf_checkpoint(str(tmp_path), tokenizer=tok, dtype=torch.float32,
                                             device="cpu")
    assert tconfig.config_to_json(tm.cfg) == jconfig.config_to_json(jm.cfg)
    assert tm.context_len == jm.context_len
    prompt = tm.build_prompt("what is it?")
    plans = tm._plans([prompt], 128)
    batch = tgen.left_pad_plans(plans, 128)
    batch["images"] = tm._pixels(_images([(50, 30)], seed=6))
    gj = jgen.Generator(jm.params, jm.cfg, jgen.GenerationConfig(max_new_tokens=2), 1, 128,
                        cache_dtype=jnp.float32)
    ref, _ = gj._prefill(jm.params, {k: jnp.asarray(v) for k, v in batch.items()})
    gt = tgen.Generator(tm.model, tm.cfg, tgen.GenerationConfig(max_new_tokens=2), 1, 128,
                        cache_dtype=torch.float32, device="cpu")
    out, _ = gt.prefill(batch)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-3)


def test_from_train_checkpoint_copies_the_trainables(tmp_path, models):
    from visper_lm_tpu_torch.train.checkpoint import CheckpointManager

    _, tm = models
    cfg = tm.cfg
    trained = {n: p.detach() + 1.0 for n, p in tm.model.named_parameters()
               if n.startswith("mm_projector.")}

    class State:
        def state_tensors(self):
            return {f"params/{n}": t for n, t in trained.items()}

    CheckpointManager(str(tmp_path)).save(5, State(), cfg)
    base = from_jax_params(jax.tree_util.tree_map(
        np.asarray, j_init_vlm(jax.random.PRNGKey(0), jconfig.tiny_test_vlm(distill=True))),
        cfg, device="cpu")
    m = tapi.VisperModel.from_train_checkpoint(str(tmp_path), base, tokenizer=FakeTok())
    assert m.model is base and tconfig.config_to_json(m.cfg) == tconfig.config_to_json(cfg)
    for n, p in base.named_parameters():
        want = trained.get(n, dict(tm.model.named_parameters())[n])
        assert torch.equal(p, want), n


def test_what_is_not_ported_raises(models):
    _, tm = models
    with pytest.raises(NotImplementedError, match="item 10"):
        tm.get_visual_interpretations("describe", _images([(40, 40)])[0])
    from visper_lm_tpu_torch.models.decoder import Decoder

    # LoRA is ported (models/lora.py); MoE decoders are still to come
    with pytest.raises(NotImplementedError, match="MoE"):
        Decoder(dataclasses.replace(tm.cfg.decoder, moe_experts=4), device="meta")
