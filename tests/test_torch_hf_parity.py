"""The port against `transformers` directly (the counterpart of
tests/test_hf_parity.py): random-init HF models built from configs (no
download), their state dicts through the port's importers, the port's
modules on the CPU in f32.

Logits within 2e-4 (absolute and relative) of LlamaForCausalLM /
Phi3ForCausalLM, the CLIP tower's hidden states within 3e-4 of
CLIPVisionModel's (the tolerances tests/test_hf_parity.py holds the JAX
package to); greedy cache decoding and 3-beam search token-identical to HF
`generate`.
"""

import numpy as np
import pytest
import torch

from visper_lm_tpu_torch.checkpoint.hf_import import import_clip_vision, import_decoder
from visper_lm_tpu_torch.config import DecoderConfig, VisionConfig
from visper_lm_tpu_torch.models.decoder import Decoder, init_kv_cache
from visper_lm_tpu_torch.models.vit import VisionTower, clip_tower_features
from visper_lm_tpu_torch.serve.beam import BeamSearchDecoder
from visper_lm_tpu_torch.serve.speculative import greedy_reference_ids

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def torch_no_grad():
    with torch.no_grad():
        yield


def _load(module_cls, cfg, sd):
    with torch.device("meta"):
        module = module_cls(cfg)
    module.load_state_dict(sd, strict=True, assign=True)
    return module.eval()


def _llama(seed, **kw):
    from transformers import LlamaConfig, LlamaForCausalLM

    hf_cfg = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=2, num_key_value_heads=2, head_dim=16,
                  max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-5,
                  attention_bias=False, tie_word_embeddings=False)
    hf_cfg.update(kw)
    torch.manual_seed(seed)
    hf = LlamaForCausalLM(LlamaConfig(**hf_cfg)).eval()
    cfg = DecoderConfig(
        vocab_size=hf_cfg["vocab_size"], hidden_size=hf_cfg["hidden_size"],
        num_layers=hf_cfg["num_hidden_layers"], num_heads=hf_cfg["num_attention_heads"],
        num_kv_heads=hf_cfg["num_key_value_heads"], head_dim=hf_cfg["head_dim"],
        mlp_dim=hf_cfg["intermediate_size"], rope_theta=hf_cfg["rope_theta"],
        max_seq_len=hf_cfg["max_position_embeddings"], family="llama", dtype="float32",
    )
    return hf, _load(Decoder, cfg, import_decoder(hf.state_dict(), cfg))


def test_llama_logits_parity(torch_no_grad):
    hf, dec = _llama(0, vocab_size=256, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=3, num_attention_heads=4, max_position_embeddings=128)
    ids = torch.tensor([[1, 5, 9, 200, 42, 7, 77, 3]])
    ours = dec(dec.embed_tokens(ids))["logits"]
    np.testing.assert_allclose(ours.numpy(), hf(ids).logits.numpy(), rtol=2e-4, atol=2e-4)


def test_llama3_rope_theta_and_gqa_logits_parity(torch_no_grad):
    """Llama-3's rope_theta 500,000 and a 4:1 query-group ratio."""
    hf, dec = _llama(5, vocab_size=300, hidden_size=64, intermediate_size=96,
                     num_attention_heads=8, num_key_value_heads=2, head_dim=8,
                     rope_theta=500000.0, max_position_embeddings=128)
    ids = torch.tensor([[3, 299, 17, 4, 150, 8, 8, 1, 60, 2]])
    ours = dec(dec.embed_tokens(ids))["logits"]
    np.testing.assert_allclose(ours.numpy(), hf(ids).logits.numpy(), rtol=2e-4, atol=2e-4)


def test_phi3_logits_parity(torch_no_grad):
    from transformers import Phi3Config, Phi3ForCausalLM

    torch.manual_seed(1)
    hf = Phi3ForCausalLM(Phi3Config(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128,
        rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
        pad_token_id=0, bos_token_id=1, eos_token_id=2,
    )).eval()
    cfg = DecoderConfig(
        vocab_size=256, hidden_size=64, num_layers=3, num_heads=4, num_kv_heads=4,
        head_dim=16, mlp_dim=128, rope_theta=10000.0, norm_eps=1e-5,
        max_seq_len=128, family="phi3", dtype="float32",
    )
    dec = _load(Decoder, cfg, import_decoder(hf.state_dict(), cfg))
    ids = torch.tensor([[2, 17, 33, 99, 250, 8]])
    ours = dec(dec.embed_tokens(ids))["logits"]
    np.testing.assert_allclose(ours.numpy(), hf(ids).logits.numpy(), rtol=2e-4, atol=2e-4)


def test_clip_vision_parity(torch_no_grad):
    from transformers import CLIPVisionConfig, CLIPVisionModel

    torch.manual_seed(2)
    hf = CLIPVisionModel(CLIPVisionConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=4, num_attention_heads=4,
        image_size=56, patch_size=14, hidden_act="quick_gelu", layer_norm_eps=1e-5,
    )).eval()
    cfg = VisionConfig(
        image_size=56, patch_size=14, hidden_size=64, num_layers=4, num_heads=4,
        mlp_dim=128, select_layer=-2, select_feature="patch", dtype="float32",
    )
    tower = _load(VisionTower, cfg, import_clip_vision(hf.state_dict(), cfg))
    img = np.random.default_rng(0).normal(size=(2, 3, 56, 56)).astype(np.float32)
    hf_out = hf(torch.tensor(img), output_hidden_states=True)
    nhwc = torch.tensor(img.transpose(0, 2, 3, 1))
    # HF's last_hidden_state is the encoder output before post_layernorm
    last = tower(nhwc, output_layers=[cfg.num_layers - 1], final_norm=False)["taps"]
    np.testing.assert_allclose(last[cfg.num_layers - 1].numpy(),
                               hf_out.last_hidden_state.numpy(), rtol=3e-4, atol=3e-4)
    # the tower's feature select: hidden_states[-2] without the class token
    np.testing.assert_allclose(clip_tower_features(tower, nhwc).numpy(),
                               hf_out.hidden_states[-2][:, 1:].numpy(), rtol=3e-4, atol=3e-4)


def test_decoder_kv_cache_parity_with_hf_generate(torch_no_grad):
    """Greedy continuation through the port's KV cache == HF greedy decode."""
    hf, dec = _llama(3)
    prompt = torch.tensor([[5, 9, 11, 42]])
    ref = hf.generate(prompt, max_new_tokens=6, do_sample=False, pad_token_id=0)[0, 4:]

    cache = init_kv_cache(dec.cfg, 1, 16, dtype=torch.float32, device="cpu")
    out = dec(dec.embed_tokens(prompt), cache=cache, q_offset=0, kv_lengths=torch.tensor([4]))
    tok = out["logits"][:, -1].argmax(-1)
    got = [int(tok[0])]
    for step in range(5):
        out = dec(dec.embed_tokens(tok[:, None]), cache=cache, q_offset=4 + step,
                  positions=torch.full((1, 1), 4 + step), kv_lengths=torch.tensor([5 + step]))
        tok = out["logits"][:, 0].argmax(-1)
        got.append(int(tok[0]))
    assert got == ref.tolist()


def test_beam_search_parity_with_hf_generate(torch_no_grad):
    """num_beams=3 against HF generate on the same weights (no reachable
    EOS: the ranking and reordering alone)."""
    hf, dec = _llama(3)
    prompt = [5, 9, 11, 42]
    ref = hf.generate(torch.tensor([prompt]), max_new_tokens=6, do_sample=False, num_beams=3,
                      pad_token_id=0, eos_token_id=None)[0, len(prompt):].tolist()
    beam = BeamSearchDecoder(dec, num_beams=3, max_len=128, cache_dtype=torch.float32)
    got, score = beam.generate(prompt, max_new_tokens=6)
    assert got == ref
    assert np.isfinite(score)


def test_beam_search_single_beam_is_greedy(torch_no_grad):
    hf, dec = _llama(11, vocab_size=96)
    prompt = [7, 3, 88]
    ref = greedy_reference_ids(dec, prompt, max_new_tokens=10, max_len=128,
                               cache_dtype=torch.float32)
    assert ref == hf.generate(torch.tensor([prompt]), max_new_tokens=10, do_sample=False,
                              pad_token_id=0)[0, 3:].tolist()
    beam = BeamSearchDecoder(dec, num_beams=1, max_len=128, cache_dtype=torch.float32)
    got, _ = beam.generate(prompt, max_new_tokens=10)
    assert got == ref
    # an EOS planted on the greedy path ends the beam there too
    got_eos, _ = beam.generate(prompt, max_new_tokens=10, eos_token_ids=[ref[4]])
    assert got_eos == ref[:4]
