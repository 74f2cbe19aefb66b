"""The whole serving slice: the port's Generator vs the JAX Generator on the CPU.

tiny_test_vlm(distill=True) with the JAX init_vlm weights carried over by
`weights.from_jax_params`; a batch of 2 prompts with different left pads;
f32 weights and an f32 cache on both sides. Greedy tokens must be identical;
prefill next-token logits agree within atol 1e-4 / rtol 1e-3 (four decoder
layers of f32 sums taken in a different order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.data.collate import build_splice_plan as j_build_splice_plan
from visper_lm_tpu.models.vlm import init_vlm as j_init_vlm
from visper_lm_tpu.serve import generate as jgen

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.constants import IMAGE_TOKEN_INDEX
from visper_lm_tpu_torch.data.collate import build_splice_plan
from visper_lm_tpu_torch.serve import generate as tgen
from visper_lm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

PROMPT_LEN = 128


@pytest.fixture(scope="module")
def slice_setup():
    cfg_j = jconfig.tiny_test_vlm(distill=True)
    cfg_t = tconfig.tiny_test_vlm(distill=True)
    params = j_init_vlm(jax.random.PRNGKey(0), cfg_j)
    model = from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu"
    )
    rng = np.random.default_rng(0)
    raw = [
        [1, 2, 3, IMAGE_TOKEN_INDEX] + list(rng.integers(4, 400, size=5 + 9 * b))
        for b in range(2)
    ]
    kw = dict(num_image_tokens=cfg_t.num_image_tokens, num_task_tokens=2, num_tasks=3)
    plans = [build_splice_plan(ids, None, PROMPT_LEN, **kw) for ids in raw]
    images = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    batch = tgen.left_pad_plans(plans, PROMPT_LEN)
    batch["images"] = images
    return cfg_j, cfg_t, params, model, raw, plans, batch


def test_splice_plans_and_left_pad_match_jax(slice_setup):
    cfg_j, cfg_t, params, model, raw, plans, batch = slice_setup
    kw = dict(num_image_tokens=cfg_t.num_image_tokens, num_task_tokens=2, num_tasks=3)
    j_plans = [j_build_splice_plan(ids, None, PROMPT_LEN, **kw) for ids in raw]
    for p, q in zip(plans, j_plans):
        for f in ("text_ids", "token_type", "src_index", "labels"):
            np.testing.assert_array_equal(getattr(p, f), getattr(q, f))
        assert p.seq_length == q.seq_length
    j_batch = jgen.left_pad_plans(j_plans, PROMPT_LEN)
    for k, v in j_batch.items():
        np.testing.assert_array_equal(batch[k], v)
    assert len(set(batch["pad_offsets"].tolist())) == 2  # different left pads


def test_prefill_logits_match_jax(slice_setup):
    cfg_j, cfg_t, params, model, raw, plans, batch = slice_setup
    gj = jgen.Generator(params, cfg_j, jgen.GenerationConfig(max_new_tokens=4), 2,
                        PROMPT_LEN, cache_dtype=jnp.float32)
    ref, _ = gj._prefill(params, {k: jnp.asarray(v) for k, v in batch.items()})
    gt = tgen.Generator(model, cfg_t, tgen.GenerationConfig(max_new_tokens=4), 2,
                        PROMPT_LEN, cache_dtype=torch.float32, device="cpu")
    out, cache = gt.prefill(batch)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, cfg_t.decoder.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-3)
    assert cache.max_len == gj.max_len


def test_greedy_tokens_match_jax_generator(slice_setup):
    """10 new tokens in chunks of 4 (12 decoded, 2 trimmed): token-identical."""
    cfg_j, cfg_t, params, model, raw, plans, batch = slice_setup
    gen_j = jgen.GenerationConfig(max_new_tokens=10, decode_chunk=4)
    gen_t = tgen.GenerationConfig(max_new_tokens=10, decode_chunk=4)
    ref = jgen.Generator(params, cfg_j, gen_j, 2, PROMPT_LEN,
                         cache_dtype=jnp.float32).generate(dict(batch))
    out = tgen.Generator(model, cfg_t, gen_t, 2, PROMPT_LEN, cache_dtype=torch.float32,
                         device="cpu").generate(dict(batch))
    assert out == ref
    assert all(len(o) == 10 for o in out)


def test_eos_stops_and_streamer_sees_accepted_tokens(slice_setup):
    cfg_j, cfg_t, params, model, raw, plans, batch = slice_setup
    base = tgen.Generator(model, cfg_t, tgen.GenerationConfig(max_new_tokens=6), 2,
                          PROMPT_LEN, cache_dtype=torch.float32, device="cpu")
    first = base.generate(dict(batch))
    eos = first[0][0]
    rows = []
    gen = tgen.Generator(
        model, cfg_t, tgen.GenerationConfig(max_new_tokens=6, eos_token_ids=(eos,)),
        2, PROMPT_LEN, cache_dtype=torch.float32, device="cpu",
    )
    out = gen.generate(dict(batch), streamer=lambda row, acc: rows.append(acc.copy()))
    assert out[0] == [eos]
    assert sum(int(a[0]) for a in rows) == 1
    assert sum(int(a[1]) for a in rows) == len(out[1])


class _LetterTokenizer:
    """Token id -> one letter; enough for stop-string matching."""

    def decode(self, ids, skip_special_tokens=False):
        return "".join(chr(97 + i % 26) for i in ids)


def test_stop_strings_trim_like_jax(slice_setup):
    cfg_j, cfg_t, params, model, raw, plans, batch = slice_setup
    tok = _LetterTokenizer()
    plain = tgen.Generator(model, cfg_t, tgen.GenerationConfig(max_new_tokens=8), 2,
                           PROMPT_LEN, cache_dtype=torch.float32, device="cpu")
    stop = tok.decode(plain.generate(dict(batch))[0][3:5])
    gen_j = jgen.GenerationConfig(max_new_tokens=8, stop_strings=(stop,), decode_chunk=4)
    gen_t = tgen.GenerationConfig(max_new_tokens=8, stop_strings=(stop,), decode_chunk=4)
    ref = jgen.Generator(params, cfg_j, gen_j, 2, PROMPT_LEN,
                         cache_dtype=jnp.float32).generate(dict(batch), tokenizer=tok)
    out = tgen.Generator(model, cfg_t, gen_t, 2, PROMPT_LEN, cache_dtype=torch.float32,
                         device="cpu").generate(dict(batch), tokenizer=tok)
    assert out == ref
    assert stop not in out[0] and len(out[0]) <= 3


def test_sampling_is_seeded_and_in_vocab(slice_setup):
    cfg_j, cfg_t, params, model, raw, plans, batch = slice_setup
    gc = tgen.GenerationConfig(max_new_tokens=5, temperature=0.8, top_p=0.9)
    gen = tgen.Generator(model, cfg_t, gc, 2, PROMPT_LEN, cache_dtype=torch.float32,
                         device="cpu")
    a = gen.generate(dict(batch), seed=1)
    b = gen.generate(dict(batch), seed=1)
    assert a == b
    assert all(0 <= t < cfg_t.decoder.vocab_size for o in a for t in o)


def test_sample_tokens_top_p_keeps_only_the_nucleus():
    logits = torch.log(torch.tensor([[0.6, 0.3, 0.05, 0.05]]))
    gc = tgen.GenerationConfig(temperature=1.0, top_p=0.5)
    g = torch.Generator().manual_seed(0)
    draws = {int(tgen._sample_tokens(logits, gc, g)[0]) for _ in range(50)}
    assert draws == {0}
    greedy = tgen._sample_tokens(torch.tensor([[1.0, 3.0, 3.0]]), tgen.GenerationConfig(), g)
    assert int(greedy[0]) == 1  # first maximal index, as jnp.argmax


def test_generator_needs_a_device_and_rejects_quantized_serving(slice_setup, monkeypatch):
    """Quantized serving is ported: the Generator quantizes its own decoder and
    leaves the caller's VLM weights as they were. Without CUDA and without a
    device it still raises."""
    cfg_j, cfg_t, params, model, raw, plans, batch = slice_setup
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for wq in (True, "int4"):
        gen = tgen.Generator(model, cfg_t, tgen.GenerationConfig(kv_quant=True, weight_quant=wq),
                             2, PROMPT_LEN, device="cpu")
        assert gen.decoder is not model.decoder
        assert gen.decoder.embed_tokens is model.decoder.embed_tokens
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    assert isinstance(model.decoder.blocks[0].q_proj, torch.nn.Linear)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgen.Generator(model, cfg_t, tgen.GenerationConfig(), 2, PROMPT_LEN)
