"""Beam search, port vs the JAX package on the CPU.

The target decoder of tests/test_speculative.py (4 layers, width 64, vocab
256, f32 weights and f32 cache) carried over by
`weights.decoder_from_jax_params`. For each case the best hypothesis's tokens
must be identical to JAX's `BeamSearchDecoder` and its normalised score
within rtol 1e-5 (log-softmax sums over 32 steps in another order); one
beam is the greedy path. The cases cover HF's rules: the candidate width
max(2, 1 + n_eos)·B (three eos ids widen it to 4B), EOS retirement only at
rank < num_beams, the length penalty, and the early_stopping=False done test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu.config import DecoderConfig as JDecoderConfig
from visper_lm_tpu.models.decoder import init_decoder
from visper_lm_tpu.serve.beam import BeamSearchDecoder as JBeam
from visper_lm_tpu.serve.speculative import greedy_reference_ids

from visper_lm_tpu_torch.config import DecoderConfig
from visper_lm_tpu_torch.serve.beam import BeamSearchDecoder
from visper_lm_tpu_torch.weights import decoder_from_jax_params

torch.set_num_threads(2)

PROMPT = [5, 17, 101, 33, 7]
_KW = dict(vocab_size=256, hidden_size=64, num_layers=4, num_heads=4, num_kv_heads=2,
           head_dim=16, mlp_dim=128, dtype="float32", max_seq_len=512)


@pytest.fixture(scope="module")
def models():
    params = init_decoder(jax.random.PRNGKey(0), JDecoderConfig(**_KW))
    port = decoder_from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                   DecoderConfig(**_KW), device="cpu")
    greedy = greedy_reference_ids(params, JDecoderConfig(**_KW), PROMPT, max_new_tokens=32,
                                  max_len=512, cache_dtype=jnp.float32)
    return params, port, greedy


# name -> (num_beams, eos rank picks from the greedy run, length_penalty, max_new_tokens)
CASES = {
    "beams4_no_eos": (4, (), 1.0, 32),
    "beams4_eos": (4, (3,), 1.0, 32),
    "beams3_three_eos_wider": (3, (1, 4, 9), 1.0, 24),
    "beams4_penalty_0_5": (4, (5,), 0.5, 24),
    "beams2_penalty_2": (2, (2,), 2.0, 16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_matches_jax(models, case):
    params, port, greedy = models
    beams, eos_picks, penalty, n = CASES[case]
    eos = [greedy[i] for i in eos_picks]
    ref_tokens, ref_score = JBeam(
        params, JDecoderConfig(**_KW), num_beams=beams, max_len=512,
        cache_dtype=jnp.float32, length_penalty=penalty,
    ).generate(PROMPT, max_new_tokens=n, eos_token_ids=eos)
    tokens, score = BeamSearchDecoder(
        port, num_beams=beams, max_len=512, cache_dtype=torch.float32, length_penalty=penalty,
    ).generate(PROMPT, max_new_tokens=n, eos_token_ids=eos)
    assert tokens == ref_tokens
    np.testing.assert_allclose(score, ref_score, rtol=1e-5)


def test_one_beam_is_the_greedy_path(models):
    params, port, greedy = models
    tokens, _ = BeamSearchDecoder(port, num_beams=1, max_len=512,
                                  cache_dtype=torch.float32).generate(PROMPT, max_new_tokens=32)
    assert tokens == greedy


def test_beam_rejects_what_it_cannot_run(models):
    _, port, _ = models
    with pytest.raises(ValueError):
        BeamSearchDecoder(port, num_beams=0)
    with pytest.raises(ValueError):
        BeamSearchDecoder(port, num_beams=2, max_len=128).generate(PROMPT, max_new_tokens=200)
