"""HF checkpoint import and export (visper_lm_tpu_torch/checkpoint/) vs the
JAX package's and the safetensors package's, on the CPU.

  * the port's safetensors reader against `safetensors` (F32 / F16 / BF16,
    __metadata__, one file and an index with shards) and its writer read
    back by `safetensors`: bit-equal, each tensor in its file dtype;
  * `import_decoder` (Llama and Phi3's fused weights), `import_clip_vision`
    and `import_vlm` (heads, task tokens, logit scales, image_newline) on the
    state dicts of tiny random-init `transformers` models against JAX's
    importers, whose trees `weights` maps onto the port's names: equal;
  * export -> import in memory, and the file round trip in both directions
    with the JAX package's `save_hf_checkpoint` / `load_safetensors`: equal.
"""

import dataclasses
import json
import os

import re

import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

import jax

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.checkpoint import hf_export as jexp
from visper_lm_tpu.checkpoint import hf_import as jimp
from visper_lm_tpu.models.vlm import init_vlm as j_init_vlm

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.checkpoint import hf_export as texp
from visper_lm_tpu_torch.checkpoint import hf_import as timp
from visper_lm_tpu_torch.weights import (
    decoder_tree_to_state_dict,
    from_jax_params,
    jax_tree_to_state_dict,
    vit_tree_to_state_dict,
)

torch.set_num_threads(2)


def _equal(port: dict, ref: dict) -> None:
    """Same names, and each tensor equal to the reference array (as f32)."""
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(port[k].float().numpy(), np.asarray(v, np.float32), err_msg=k)


def _bit_equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w32": torch.randn(3, 5, generator=g),
        "w16": torch.randn(7, generator=g).half(),
        "wbf": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "scalar": torch.randn((), generator=g),
        "odd16": torch.randn(3, generator=g).half(),
        "ids": torch.arange(5, dtype=torch.int64),
    }


# ---------------------------------------------------------------- the format


def test_reader_equals_safetensors(tmp_path):
    sd = _tensors()
    path = str(tmp_path / "a.safetensors")
    save_file(sd, path, metadata={"format": "pt", "note": "x"})
    got = timp.load_safetensors(path)
    _bit_equal(got, load_file(path))
    _bit_equal(got, sd)
    header, start = timp.read_safetensors_header(path)
    assert header["__metadata__"] == {"format": "pt", "note": "x"} and start % 8 == 0


def test_writer_is_read_back_by_safetensors(tmp_path):
    sd = _tensors(1)
    path = str(tmp_path / "b.safetensors")
    texp.save_safetensors(sd, path)
    _bit_equal(load_file(path), sd)
    _bit_equal(timp.load_safetensors(path), sd)
    from safetensors import safe_open
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}


def test_sharded_index_is_read_as_one_state_dict(tmp_path):
    sd = _tensors(2)
    names = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": names[:3],
              "model-00002-of-00002.safetensors": names[3:]}
    for shard, keys in shards.items():
        save_file({k: sd[k] for k in keys}, str(tmp_path / shard))
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {}, "weight_map": {k: s for s, ks in shards.items() for k in ks}}, f)
    _bit_equal(timp.load_sharded_safetensors(str(tmp_path)), sd)
    os.remove(tmp_path / "model.safetensors.index.json")
    with pytest.raises(FileNotFoundError):
        timp.load_sharded_safetensors(str(tmp_path))


def test_as_state_dict_keeps_dtypes():
    import ml_dtypes

    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    sd = timp.as_state_dict({"a": a, "b": a.astype(ml_dtypes.bfloat16),
                             "c": torch.ones(2, dtype=torch.float16, requires_grad=True)})
    assert sd["a"].dtype == torch.float32 and sd["b"].dtype == torch.bfloat16
    assert sd["c"].dtype == torch.float16 and not sd["c"].requires_grad
    assert torch.equal(sd["b"].float(), torch.from_numpy(a))


# ----------------------------------------------------------- tiny HF models


def _llama(seed=0, **kw):
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               max_position_embeddings=256, attention_bias=False, tie_word_embeddings=False)
    cfg.update(kw)
    torch.manual_seed(seed)
    return LlamaForCausalLM(LlamaConfig(**cfg)).eval()


def _phi3(seed=1):
    from transformers import Phi3Config, Phi3ForCausalLM

    torch.manual_seed(seed)
    return Phi3ForCausalLM(Phi3Config(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        tie_word_embeddings=False, pad_token_id=0, bos_token_id=1, eos_token_id=2,
    )).eval()


def _clip(seed=2, hidden=32, layers=2, heads=2, mlp=64, image=28):
    from transformers import CLIPVisionConfig, CLIPVisionModel

    torch.manual_seed(seed)
    return CLIPVisionModel(CLIPVisionConfig(
        hidden_size=hidden, intermediate_size=mlp, num_hidden_layers=layers,
        num_attention_heads=heads, image_size=image, patch_size=14, hidden_act="quick_gelu",
    )).eval()


PHI3 = dict(vocab_size=256, hidden_size=64, num_layers=3, num_heads=4, num_kv_heads=2,
            head_dim=16, mlp_dim=128, max_seq_len=128, family="phi3", dtype="float32")


@pytest.mark.parametrize("family", ["llama", "phi3"])
def test_import_decoder_equals_jax(family):
    if family == "llama":
        hf, kw = _llama(), dataclasses.asdict(tconfig.tiny_test_vlm().decoder)
    else:
        hf, kw = _phi3(), PHI3
    sd = hf.state_dict()
    got = timp.import_decoder(sd, tconfig.DecoderConfig(**kw))
    ref = jimp.import_decoder(jimp.torch_state_dict_to_numpy(sd), jconfig.DecoderConfig(**kw))
    _equal(got, decoder_tree_to_state_dict(ref, kw["num_layers"]))
    if family == "phi3":
        # the fused weights are split into views, not copies
        qkv = sd["model.layers.0.self_attn.qkv_proj.weight"]
        assert got["blocks.0.k_proj.weight"].untyped_storage().data_ptr() == \
            qkv.untyped_storage().data_ptr()


def test_import_clip_vision_equals_jax():
    hf = _clip()
    sd = hf.state_dict()
    vcfg = tconfig.tiny_test_vlm().vision
    got = timp.import_clip_vision(sd, vcfg)
    ref = jimp.import_clip_vision(jimp.torch_state_dict_to_numpy(sd),
                                  jconfig.tiny_test_vlm().vision)
    _equal(got, vit_tree_to_state_dict(ref, vcfg.num_layers))


def _ola_state_dict(seed=0):
    """A full OLA checkpoint's keys: a tiny HF Llama and CLIP tower, and the
    projector, task tokens, heads, logit scales and image_newline of a JAX
    init_vlm tree through JAX's exporter."""
    cfg = jconfig.tiny_test_vlm(distill=True)
    extras = jexp.export_vlm(j_init_vlm(jax.random.PRNGKey(seed), cfg), cfg)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in extras.items()
          if not k.startswith(("model.layers.", "model.embed", "model.norm", "lm_head",
                               "model.vision_tower."))}
    sd.update(_llama(seed).state_dict())
    sd.update({"model.vision_tower.vision_tower." + k: v
               for k, v in _clip(seed).state_dict().items()})
    sd["model.image_newline"] = torch.randn(64, generator=torch.Generator().manual_seed(seed))
    return sd


def test_import_vlm_equals_jax():
    sd = _ola_state_dict()
    assert "model.vision_tower.vision_tower.vision_model.pre_layrnorm.weight" in sd
    got = timp.import_vlm(sd, tconfig.tiny_test_vlm(distill=True))
    ref = jimp.import_vlm(jimp.torch_state_dict_to_numpy(sd), jconfig.tiny_test_vlm(distill=True))
    newline = ref.pop("image_newline")
    np.testing.assert_array_equal(got.pop("image_newline").numpy(), newline)
    _equal(got, jax_tree_to_state_dict(ref, tconfig.tiny_test_vlm(distill=True)))


def test_to_model_builds_the_vlm_and_leaves_out_missing_heads():
    cfg = tconfig.tiny_test_vlm(distill=True)
    sd = timp.import_vlm(_ola_state_dict(1), cfg)
    model = timp.to_model(sd, cfg, device="cpu")
    _bit_equal(model.state_dict(), sd)
    assert model.image_newline.shape == (64,)
    bf = timp.to_model(sd, cfg, device="cpu", dtype=torch.bfloat16)
    assert bf.decoder.embed_tokens.weight.dtype == torch.bfloat16
    no_seg = {k: v for k, v in sd.items() if not k.startswith(("heads.seg.", "logit_scales.seg"))}
    model = timp.to_model(no_seg, cfg, device="cpu")
    assert "seg" not in model.heads and "seg" not in model.logit_scales
    with pytest.raises(KeyError, match="decoder.final_norm.scale"):
        timp.to_model({k: v for k, v in sd.items() if k != "decoder.final_norm.scale"}, cfg,
                      device="cpu")


# ------------------------------------------------------------- round trips


def _port_model(cfg, seed=0):
    from visper_lm_tpu_torch.models.vlm import init_vlm

    return init_vlm(cfg, device="cpu", seed=seed)


@pytest.mark.parametrize("family", ["llama", "phi3"])
def test_export_import_round_trip_is_bit_equal(family):
    cfg = tconfig.tiny_test_vlm(distill=True)
    if family == "phi3":
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, family="phi3"))
    model = _port_model(cfg).to(torch.bfloat16)
    sd = texp.export_vlm(model, cfg)
    assert ("model.layers.0.self_attn.qkv_proj.weight" in sd) == (family == "phi3")
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    _bit_equal(timp.import_vlm(sd, cfg), model.state_dict())


def test_export_equals_jax_export():
    """The port's export of JAX's weights has JAX's keys and values."""
    cfg_j = jconfig.tiny_test_vlm(distill=True)
    cfg_t = tconfig.tiny_test_vlm(distill=True)
    params = j_init_vlm(jax.random.PRNGKey(4), cfg_j)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    ref = jexp.export_vlm(params, cfg_j)
    got = texp.export_vlm(model, cfg_t)
    _equal(got, ref)


def test_file_round_trip_from_the_jax_package(tmp_path):
    cfg_j = jconfig.tiny_test_vlm(distill=True)
    params = j_init_vlm(jax.random.PRNGKey(5), cfg_j)
    jexp.save_hf_checkpoint(str(tmp_path), params, cfg_j)
    cfg_t = tconfig.tiny_test_vlm(distill=True)
    got = timp.import_vlm(timp.load_sharded_safetensors(str(tmp_path)), cfg_t)
    _equal(got, jax_tree_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg_t))


def test_file_round_trip_to_the_jax_package(tmp_path):
    """An f32 checkpoint the port wrote reads into JAX's tree (JAX's reader
    takes numpy arrays, which have no bfloat16) and back into the port."""
    cfg_t = tconfig.tiny_test_vlm(distill=True)
    model = _port_model(cfg_t, seed=6)
    texp.save_hf_checkpoint(str(tmp_path), model, cfg_t)
    with open(tmp_path / "config.json") as f:
        hf_cfg = json.load(f)
    assert hf_cfg["torch_dtype"] == "float32"
    assert jconfig.config_to_json(jconfig.config_from_json(json.dumps(hf_cfg["visper_config"]))) \
        == tconfig.config_to_json(cfg_t)
    ref = jimp.import_vlm(jimp.load_sharded_safetensors(str(tmp_path)),
                          jconfig.tiny_test_vlm(distill=True))
    _equal(model.state_dict(), jax_tree_to_state_dict(ref, cfg_t))


def test_bf16_file_round_trip_is_bit_equal(tmp_path):
    cfg = tconfig.tiny_test_vlm(distill=True)
    model = _port_model(cfg, seed=7).to(torch.bfloat16)
    texp.save_hf_checkpoint(str(tmp_path), model, cfg)
    sd = timp.load_sharded_safetensors(str(tmp_path))
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    back = timp.to_model(timp.import_vlm(sd, cfg), cfg, device="cpu", dtype=None)
    _bit_equal(back.state_dict(), model.state_dict())


def test_what_is_not_ported_raises():
    """Once not ported, now ported: the stream-grads layout (decoder blocks
    as `decoder.blocks_chunks.<c>.<j>.` sub-stacks, here two chunks)
    exports as the stacked layout does, bit for bit."""
    cfg = tconfig.tiny_test_vlm(distill=True)
    model = _port_model(cfg)
    half = cfg.decoder.num_layers // 2

    def chunked_name(k):
        m = re.match(r"decoder\.blocks\.(\d+)\.(.*)", k)
        if m is None:
            return k
        i = int(m.group(1))
        return f"decoder.blocks_chunks.{int(i >= half)}.{i - half * (i >= half)}.{m.group(2)}"

    chunked = {chunked_name(k): v for k, v in model.state_dict().items()}
    assert any(".blocks_chunks.1.0." in k for k in chunked)
    _bit_equal(texp.export_vlm(chunked, cfg), texp.export_vlm(model, cfg))
