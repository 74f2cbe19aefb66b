"""Speculative decoding, port vs the JAX package on the CPU.

The tiny decoders of tests/test_speculative.py (target 4 layers at width 64,
draft 2 at 32, vocab 256, f32 weights and f32 caches), carried over by
`weights.decoder_from_jax_params`. Greedy tokens must be identical to JAX's
(`greedy_reference_ids`, `SpeculativeDecoder`, `PromptLookupDecoder`) and to
the port's own greedy oracle, with the same acceptance counts;
`ngram_propose` equal on fixed and random histories. `spec_accept` draws from
a torch.Generator, so its draws are not JAX's: its deterministic outcomes
equal JAX's, and its distribution test is JAX's
test_spec_accept_distribution_exact at the same sample count (200,000) and
total-variation bounds (0.01 at position 0, 0.02 at position 1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu.config import DecoderConfig as JDecoderConfig
from visper_lm_tpu.models.decoder import init_decoder
from visper_lm_tpu.serve import speculative as jspec

from visper_lm_tpu_torch.config import DecoderConfig
from visper_lm_tpu_torch.serve import speculative as tspec
from visper_lm_tpu_torch.weights import decoder_from_jax_params

torch.set_num_threads(2)

PROMPT = [5, 17, 101, 33, 7]
REPEAT = [5, 17, 101, 33, 5, 17, 101, 33, 5, 17]


def _cfgs(layers: int, width: int = 64):
    kw = dict(vocab_size=256, hidden_size=width, num_layers=layers, num_heads=4,
              num_kv_heads=2, head_dim=16, mlp_dim=width * 2, dtype="float32",
              max_seq_len=512)
    return JDecoderConfig(**kw), DecoderConfig(**kw)


@pytest.fixture(scope="module")
def models():
    tcj, tct = _cfgs(4)
    dcj, dct = _cfgs(2, 32)
    tp = init_decoder(jax.random.PRNGKey(0), tcj)
    dp = init_decoder(jax.random.PRNGKey(1), dcj)

    def port(tree, cfg):
        return decoder_from_jax_params(jax.tree_util.tree_map(np.asarray, tree), cfg, device="cpu")

    return dict(tp=tp, tcj=tcj, dp=dp, dcj=dcj, target=port(tp, tct), draft=port(dp, dct))


@pytest.fixture(scope="module")
def greedy_refs(models):
    m = models
    kw = dict(max_len=512, cache_dtype=jnp.float32)
    return {
        "prompt": jspec.greedy_reference_ids(m["tp"], m["tcj"], PROMPT, max_new_tokens=24, **kw),
        "repeat": jspec.greedy_reference_ids(m["tp"], m["tcj"], REPEAT, max_new_tokens=20, **kw),
        "single": jspec.greedy_reference_ids(m["tp"], m["tcj"], [11], max_new_tokens=8, **kw),
    }


def _port_greedy(m, prompt, n, **kw):
    return tspec.greedy_reference_ids(m["target"], prompt, max_new_tokens=n, max_len=512,
                                      cache_dtype=torch.float32, **kw)


def test_greedy_reference_matches_jax(models, greedy_refs):
    assert _port_greedy(models, PROMPT, 24) == greedy_refs["prompt"]
    assert _port_greedy(models, REPEAT, 20) == greedy_refs["repeat"]
    assert _port_greedy(models, [11], 8) == greedy_refs["single"]


@pytest.mark.parametrize("k", [1, 3, 5])
def test_speculative_matches_jax_and_target_greedy(models, greedy_refs, k):
    m = models
    ref, ref_stats = jspec.SpeculativeDecoder(
        m["tp"], m["tcj"], m["dp"], m["dcj"], k=k, max_len=512, cache_dtype=jnp.float32,
    ).generate(PROMPT, max_new_tokens=24)
    out, stats = tspec.SpeculativeDecoder(
        m["target"], m["draft"], k=k, max_len=512, cache_dtype=torch.float32,
    ).generate(PROMPT, max_new_tokens=24)
    assert out == ref == greedy_refs["prompt"]
    assert (stats.proposed, stats.accepted, stats.iterations, stats.generated) == (
        ref_stats.proposed, ref_stats.accepted, ref_stats.iterations, ref_stats.generated)
    assert stats.generated == len(out) and stats.generated >= stats.iterations


def test_self_draft_accepts_everything(models, greedy_refs):
    m, k = models, 4
    out, stats = tspec.SpeculativeDecoder(
        m["target"], m["target"], k=k, max_len=512, cache_dtype=torch.float32,
    ).generate(REPEAT, max_new_tokens=20)
    assert out == greedy_refs["repeat"]
    assert stats.acceptance_rate == pytest.approx(1.0)
    assert stats.tokens_per_target_pass == pytest.approx(k + 1)


def test_eos_stops_mid_chunk_like_jax(models, greedy_refs):
    m = models
    eos = greedy_refs["prompt"][7]
    ref = jspec.greedy_reference_ids(m["tp"], m["tcj"], PROMPT, max_new_tokens=24,
                                     eos_token_ids=[eos], max_len=512, cache_dtype=jnp.float32)
    out, _ = tspec.SpeculativeDecoder(
        m["target"], m["draft"], k=4, max_len=512, cache_dtype=torch.float32,
    ).generate(PROMPT, max_new_tokens=24, eos_token_ids=[eos])
    assert out == ref == _port_greedy(m, PROMPT, 24, eos_token_ids=[eos])
    assert out[-1] == eos


def test_single_token_prompt(models, greedy_refs):
    m = models
    out, _ = tspec.SpeculativeDecoder(
        m["target"], m["draft"], k=2, max_len=512, cache_dtype=torch.float32,
    ).generate([11], max_new_tokens=8)
    assert out == greedy_refs["single"]


@pytest.mark.parametrize("k,n", [(4, 2), (8, 3)])
def test_prompt_lookup_matches_jax(models, greedy_refs, k, n):
    m = models
    ref, ref_stats = jspec.PromptLookupDecoder(
        m["tp"], m["tcj"], k=k, ngram=n, max_len=512, cache_dtype=jnp.float32,
    ).generate(REPEAT, max_new_tokens=20)
    out, stats = tspec.PromptLookupDecoder(
        m["target"], k=k, ngram=n, max_len=512, cache_dtype=torch.float32,
    ).generate(REPEAT, max_new_tokens=20)
    assert out == ref == greedy_refs["repeat"]
    assert (stats.proposed, stats.accepted, stats.iterations) == (
        ref_stats.proposed, ref_stats.accepted, ref_stats.iterations)


def test_ngram_propose_matches_jax():
    cases = [
        ([10, 20, 30, 40, 10, 20], 2, 2), ([10, 20, 30, 40, 10, 20], 2, 5),
        ([1, 2, 9, 1, 2, 7, 1, 2], 2, 1), ([5, 6, 7, 6], 3, 1), ([1, 2, 3], 2, 3), ([4], 3, 2),
    ]
    rng = np.random.default_rng(0)
    for _ in range(200):
        cases.append((rng.integers(0, 6, size=int(rng.integers(1, 40))).tolist(),
                      int(rng.integers(1, 5)), int(rng.integers(1, 9))))
    for hist, n, k in cases:
        assert tspec.ngram_propose(hist, n, k) == jspec.ngram_propose(hist, n, k), (hist, n, k)
    assert tspec.ngram_propose([10, 20, 30, 40, 10, 20], n=2, k=2) == [30, 40]
    assert tspec.ngram_propose([1, 2, 3], n=2, k=3) == []


def test_warp_probs_matches_jax():
    logits = np.random.default_rng(3).standard_normal((3, 40)).astype(np.float32) * 3
    for temperature, top_p in ((1.0, 1.0), (0.7, 0.9), (1.3, 0.5)):
        ref = np.asarray(jspec.warp_probs(jnp.asarray(logits), temperature, top_p))
        got = tspec.warp_probs(torch.from_numpy(logits), temperature, top_p).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-5)
        np.testing.assert_array_equal(got == 0, ref == 0)


def test_spec_accept_outcomes_that_do_not_depend_on_the_draw():
    """Where the rule leaves no choice, the port's (n, fixup) are JAX's:
    p == q accepts every proposal; p(d) = 0 rejects at once and resamples
    from the residual, which here has one token."""
    V, k = 5, 3
    p = np.full((k + 1, V), 0.0, np.float32)
    p[:, 2] = 1.0                                           # the target always says 2
    q_same = p[:k].copy()
    d_same = np.array([2, 2, 2])
    q_other = np.zeros((k, V), np.float32)
    q_other[:, 4] = 1.0
    d_other = np.array([4, 4, 4])
    gen = torch.Generator().manual_seed(0)
    for q, d in ((q_same, d_same), (q_other, d_other)):
        n_j, fix_j = jspec.spec_accept(jnp.asarray(p), jnp.asarray(q), jnp.asarray(d),
                                       jax.random.PRNGKey(0))
        n_t, fix_t = tspec.spec_accept(torch.from_numpy(p), torch.from_numpy(q),
                                       torch.from_numpy(d), gen)
        assert (int(n_t), int(fix_t)) == (int(n_j), int(fix_j))
    n_t, fix_t = tspec.spec_accept(torch.from_numpy(p), torch.zeros((0, V)),
                                   torch.zeros((0,), dtype=torch.long), gen)
    assert (int(n_t), int(fix_t)) == (0, 2)


def test_spec_accept_distribution_exact():
    """JAX's statistical guarantee at its sample count: with proposals drawn
    from q, the emitted token at each position is distributed as the target's
    p (200,000 trials as leading axes of one call)."""
    V, k, M = 13, 3, 200_000
    kp, kq = jax.random.split(jax.random.PRNGKey(7))
    p = np.array(jax.nn.softmax(1.5 * jax.random.normal(kp, (k + 1, V)), axis=-1))
    q = np.array(jax.nn.softmax(1.5 * jax.random.normal(kq, (k, V)), axis=-1))
    gen = torch.Generator().manual_seed(1)
    pt, qt = torch.from_numpy(p), torch.from_numpy(q)
    d = torch.multinomial(qt, M, replacement=True, generator=gen).T          # (M, k)
    n, fix = tspec.spec_accept(pt.expand(M, k + 1, V), qt.expand(M, k, V), d, gen)
    tok0 = torch.where(n > 0, d[:, 0], fix).numpy()
    tok1 = torch.where(n > 1, d[:, 1], fix).numpy()
    n = n.numpy()
    emp0 = np.bincount(tok0, minlength=V) / M
    assert 0.5 * np.abs(emp0 - p[0]).sum() < 0.01
    sel = tok1[n >= 1]
    emp1 = np.bincount(sel, minlength=V) / sel.size
    assert 0.5 * np.abs(emp1 - p[1]).sum() < 0.02


def test_spec_accept_empty_draft_samples_target():
    V, M = 11, 100_000
    p = np.array(jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(3), (1, V))))
    gen = torch.Generator().manual_seed(4)
    n, fix = tspec.spec_accept(torch.from_numpy(p).expand(M, 1, V), torch.zeros((M, 0, V)),
                               torch.zeros((M, 0), dtype=torch.long), gen)
    assert int(n.abs().sum()) == 0
    emp = np.bincount(fix.numpy(), minlength=V) / M
    assert 0.5 * np.abs(emp - p[0]).sum() < 0.01


def test_speculative_sampling_is_seeded(models):
    """Sampling runs, is seed-deterministic, and a self-draft accepts
    everything (u < p/p always)."""
    m = models

    def sample(seed, draft=None, n=16, top_p=0.95):
        return tspec.SpeculativeDecoder(
            m["target"], draft or m["draft"], k=3, max_len=512, cache_dtype=torch.float32,
            temperature=0.9, top_p=top_p,
        ).generate(PROMPT, max_new_tokens=n, seed=seed)

    out1, stats = sample(11)
    assert len(out1) == 16 and stats.generated == 16
    assert sample(11)[0] == out1
    assert sample(12)[0] != out1
    _, st = sample(0, draft=m["target"], n=12, top_p=1.0)
    assert st.acceptance_rate == pytest.approx(1.0)


def test_prompt_lookup_sampling_is_seeded(models):
    m = models

    def sample(seed):
        return tspec.PromptLookupDecoder(
            m["target"], k=4, ngram=2, max_len=512, cache_dtype=torch.float32, temperature=0.8,
        ).generate(REPEAT, max_new_tokens=12, seed=seed)

    out1, stats = sample(5)
    assert len(out1) == 12 and stats.generated == 12
    assert sample(5)[0] == out1
