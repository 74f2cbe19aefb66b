"""Speculative (draft/verify) decoding (counterpart of
visper_lm_tpu/serve/speculative.py).

Greedy by default; with ``temperature > 0`` it runs speculative SAMPLING
(Leviathan et al.'s rejection scheme): each drafted token is accepted with
probability min(1, p(x)/q(x)) and a rejection resamples from
normalize(max(p - q, 0)), so the output distribution is exactly the target's
(warped) sampling distribution whatever the draft.

A small DRAFT decoder proposes k tokens one at a time; the TARGET verifies all
k+1 positions in ONE chunked forward (one read of its weights), and the
longest prefix on which the draft agrees with the target's greedy argmax is
accepted plus one bonus token from the target. At temperature 0 the output is
exactly the target's greedy sequence; draft quality moves the speed, never
the tokens.

  * both decoders read and write their own cache through the decoder's cache
    route with a 0-d tensor offset (as JAX passes a traced int32): a verify
    chunk attends the cache plus the chunk and writes all k+1 slots; even the
    prompt's prefill at offset 0 takes that route, so B1 never runs here;
  * acceptance never shrinks a shape: the host loop tracks the valid length,
    and stale slots past it are masked by the offset and overwritten in place
    by later (monotonically advancing) chunk writes;
  * the draft runs k+1 single-token steps (the last one's logits unused) so
    its cache covers slot p+k like the target's;
  * each cache is one tensor written in place (JAX donates its buffers);
    samples are drawn from an explicit torch.Generator.

Batch 1 (acceptance lengths diverge in a batch); throughput serving is
`serve/generate.Generator` and `serve/engine.Engine`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from visper_lm_tpu_torch.models.decoder import Decoder, KVCache, init_kv_cache


@dataclasses.dataclass
class SpecStats:
    proposed: int = 0          # draft tokens proposed
    accepted: int = 0          # draft tokens accepted by the target
    iterations: int = 0        # verify calls (== target weight reads)
    generated: int = 0         # tokens emitted (accepted + bonus per iter)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def tokens_per_target_pass(self) -> float:
        return self.generated / self.iterations if self.iterations else 0.0


def _safe_log(probs: torch.Tensor) -> torch.Tensor:
    """log(probs) with exact -inf (not a huge negative) at zero entries, so a
    token outside the nucleus can never be drawn."""
    return torch.where(
        probs > 0, torch.log(probs.clamp(min=1e-38)), torch.full_like(probs, float("-inf"))
    )


def _categorical(logp: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One index per row of log-probabilities (..., V), drawn from
    softmax(logp) (jax.random.categorical); a -inf entry is never drawn."""
    probs = torch.softmax(logp, dim=-1).reshape(-1, logp.shape[-1])
    return torch.multinomial(probs, 1, generator=generator).reshape(logp.shape[:-1])


def warp_probs(logits: torch.Tensor, temperature: float, top_p: float) -> torch.Tensor:
    """Temperature + nucleus warp -> probabilities over the last axis, the
    semantics of serve/generate._sample_tokens (the cutoff keeps the smallest
    prefix of descending-probability tokens whose mass reaches top_p)."""
    logits = logits.float() / temperature
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return torch.softmax(logits, dim=-1)


def spec_accept(
    p: torch.Tensor, q: torch.Tensor, d: torch.Tensor, generator: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The speculative-sampling accept/resample rule, on the device.

    p: (..., k+1, V) target probs at the k drafted positions plus the bonus
    slot; q: (..., k, V) draft probs the proposals were drawn from; d: (..., k)
    proposals. Leading axes are independent trials. Returns (n, fixup): n the
    accepted prefix length in [0, k]; fixup the one extra emitted token, a
    residual resample at position n when n < k, else the bonus sample from
    p[k]. The tokens d[:n] + [fixup] are distributed exactly as draws from
    the target's autoregressive distribution."""
    k = d.shape[-1]
    lead = d.shape[:-1]
    bonus = _categorical(_safe_log(p[..., -1, :]), generator)
    if k == 0:  # draft-free iteration (no n-gram match): a plain target step
        return torch.zeros(lead, dtype=torch.long, device=p.device), bonus
    d = d.long()
    # accept iff u < p(x)/q(x)  <=>  u*q < p (robust when q(x) underflows)
    u = torch.rand(lead + (k,), generator=generator, device=p.device)
    p_d = torch.gather(p[..., :k, :], -1, d[..., None])[..., 0]
    q_d = torch.gather(q, -1, d[..., None])[..., 0]
    accept = u * q_d < p_d
    n = accept.long().cumprod(dim=-1).sum(dim=-1)     # leading accepts
    res = (p[..., :k, :] - q).clamp(min=0.0)
    res_sum = res.sum(dim=-1, keepdim=True)
    # the residual mass is > 0 whenever a rejection can happen; the where()
    # only guards float underflow on near-identical p, q
    res = torch.where(res_sum > 1e-12, res / res_sum.clamp(min=1e-20), p[..., :k, :])
    row = n.clamp(max=k - 1)
    res_row = torch.gather(res, -2, row[..., None, None].expand(*lead, 1, res.shape[-1]))[..., 0, :]
    resample = _categorical(_safe_log(res_row), generator)
    return n, torch.where(n < k, resample, bonus)


def _device(decoder: Decoder) -> torch.device:
    return decoder.embed_tokens.weight.device


@torch.no_grad()
def _chunk_forward(
    decoder: Decoder, tokens: Sequence[int], cache: KVCache, offset: int
) -> torch.Tensor:
    """Feed a (1, t) token chunk at `offset` into the cache; (t, V) f32 logits."""
    dev = _device(decoder)
    toks = torch.as_tensor(np.asarray(tokens, np.int64)[None, :], device=dev)
    # a 0-d position takes the decoder's cache route, as JAX's traced int32
    q_offset = torch.full((), offset, dtype=torch.long, device=dev)
    out = decoder(
        decoder.embed_tokens(toks), kv_lengths=(q_offset + toks.shape[1]).reshape(1),
        cache=cache, q_offset=q_offset,
    )
    return out["logits"][0]


class SpeculativeDecoder:
    """Draft/verify decoder for one sequence (batch 1): greedy-exact at
    temperature 0, distribution-exact speculative sampling above it."""

    def __init__(
        self,
        target: Decoder,
        draft: Decoder,
        *,
        k: int = 4,
        max_len: int = 2048,
        cache_dtype: torch.dtype = torch.bfloat16,
        temperature: float = 0.0,
        top_p: float = 1.0,
    ):
        if target.cfg.vocab_size != draft.cfg.vocab_size:
            raise ValueError("draft and target must share the tokenizer/vocab")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.target, self.draft = target, draft
        self.k = k
        self.max_len = -(-max_len // 128) * 128
        self.cache_dtype = cache_dtype
        self.temperature = float(temperature)
        self.top_p = float(top_p)

    def _init_cache(self, decoder: Decoder) -> KVCache:
        return init_kv_cache(decoder.cfg, 1, self.max_len, dtype=self.cache_dtype,
                             device=_device(decoder))

    @torch.no_grad()
    def generate(
        self,
        prompt_ids: Sequence[int],
        *,
        max_new_tokens: int = 128,
        eos_token_ids: Sequence[int] = (),
        seed: int = 0,
    ) -> Tuple[List[int], SpecStats]:
        """Speculative decode: greedy-exact (temperature 0) or
        distribution-exact sampling. Returns (generated ids, stats)."""
        sampling = self.temperature > 0.0
        dev = _device(self.target)
        generator = torch.Generator(device=dev).manual_seed(seed)
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens + self.k + 1 > self.max_len:
            raise ValueError("prompt + max_new_tokens + k + 1 exceeds max_len; raise max_len")
        eos = {int(t) for t in eos_token_ids}
        t_cache = self._init_cache(self.target)
        d_cache = self._init_cache(self.draft)

        # prefill both on the prompt minus its last token; the last prompt
        # token is the first `last` fed through the verify chunk
        p = len(prompt) - 1
        if p:
            _chunk_forward(self.target, prompt[:-1], t_cache, 0)
            _chunk_forward(self.draft, prompt[:-1], d_cache, 0)
        last = prompt[-1]

        out: List[int] = []
        stats = SpecStats()
        while len(out) < max_new_tokens:
            # ---- draft k proposals (k+1 steps; see the module docstring) ----
            drafts: List[int] = []
            q_rows: List[torch.Tensor] = []
            tok = last
            for i in range(self.k + 1):
                logits = _chunk_forward(self.draft, [tok], d_cache, p + i)[-1]
                if i == self.k:
                    break
                if sampling:
                    probs = warp_probs(logits, self.temperature, self.top_p)
                    drafts.append(int(_categorical(_safe_log(probs), generator)))
                    q_rows.append(probs)
                else:
                    drafts.append(int(torch.argmax(logits)))
                tok = drafts[-1]
            # ---- one target pass verifies all k+1 positions ----
            logits = _chunk_forward(self.target, [last] + drafts, t_cache, p)
            if sampling:
                probs = warp_probs(logits, self.temperature, self.top_p)
                n_dev, fixup = spec_accept(
                    probs, torch.stack(q_rows), torch.as_tensor(drafts, device=dev), generator
                )
                n = int(n_dev)
                emitted = drafts[:n] + [int(fixup)]
            else:
                greedy = torch.argmax(logits, dim=-1).cpu().tolist()
                n = 0
                while n < self.k and drafts[n] == greedy[n]:
                    n += 1
                emitted = drafts[:n] + [greedy[n]]

            stats.proposed += self.k
            stats.accepted += n
            stats.iterations += 1
            for e in emitted:
                out.append(e)
                stats.generated += 1
                if e in eos or len(out) >= max_new_tokens:
                    return out, stats
            p += n + 1
            last = out[-1]
        return out, stats


def ngram_propose(
    history: Sequence[int], n: int, k: int, min_match: int = 1
) -> List[int]:
    """Prompt-lookup proposal: find the MOST RECENT earlier occurrence of the
    last `n`-gram (falling back to shorter suffixes down to `min_match`) in
    `history` and copy up to k following tokens. Returns [] when nothing
    matches: the caller takes a plain target step."""
    h = list(history)
    for m in range(min(n, len(h) - 1), min_match - 1, -1):
        suffix = h[-m:]
        # scan right to left over earlier positions (the most recent wins)
        for start in range(len(h) - m - 1, -1, -1):
            if h[start:start + m] == suffix:
                cont = h[start + m : start + m + k]
                if cont:
                    return cont
    return []


class PromptLookupDecoder:
    """Draft-free speculative decoding: proposals are n-gram matches against
    the token history (prompt + generated), not a draft model's. An
    iteration costs one target chunk forward whether it verifies 1 or k+1
    positions. Greedy-exact like SpeculativeDecoder; with temperature > 0 a
    proposal is a point-mass draft (q = one_hot(d)), still distribution-exact."""

    def __init__(
        self,
        target: Decoder,
        *,
        k: int = 8,
        ngram: int = 3,
        max_len: int = 2048,
        cache_dtype: torch.dtype = torch.bfloat16,
        temperature: float = 0.0,
        top_p: float = 1.0,
    ):
        self.target = target
        self.k, self.n = k, ngram
        self.max_len = -(-max_len // 128) * 128
        self.cache_dtype = cache_dtype
        self.temperature = float(temperature)
        self.top_p = float(top_p)

    @torch.no_grad()
    def generate(
        self,
        prompt_ids: Sequence[int],
        *,
        max_new_tokens: int = 128,
        eos_token_ids: Sequence[int] = (),
        seed: int = 0,
    ) -> Tuple[List[int], SpecStats]:
        sampling = self.temperature > 0.0
        dev = _device(self.target)
        generator = torch.Generator(device=dev).manual_seed(seed)
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens + self.k + 1 > self.max_len:
            raise ValueError("prompt + max_new_tokens + k + 1 exceeds max_len; raise max_len")
        eos = {int(t) for t in eos_token_ids}
        cache = init_kv_cache(self.target.cfg, 1, self.max_len, dtype=self.cache_dtype,
                              device=dev)
        p = len(prompt) - 1
        if p:
            _chunk_forward(self.target, prompt[:-1], cache, 0)
        last = prompt[-1]

        out: List[int] = []
        stats = SpecStats()
        while len(out) < max_new_tokens:
            drafts = ngram_propose(prompt + out, self.n, self.k)
            logits = _chunk_forward(self.target, [last] + drafts, cache, p)
            if sampling:
                probs = warp_probs(logits, self.temperature, self.top_p)
                d = torch.as_tensor(drafts, dtype=torch.long, device=dev)
                q = torch.nn.functional.one_hot(d, self.target.cfg.vocab_size).float()
                n_dev, fixup = spec_accept(probs, q, d, generator)
                n = int(n_dev)
                emitted = drafts[:n] + [int(fixup)]
            else:
                greedy = torch.argmax(logits, dim=-1).cpu().tolist()
                n = 0
                while n < len(drafts) and drafts[n] == greedy[n]:
                    n += 1
                emitted = drafts[:n] + [greedy[n]]

            stats.proposed += len(drafts)
            stats.accepted += n
            stats.iterations += 1
            for e in emitted:
                out.append(e)
                stats.generated += 1
                if e in eos or len(out) >= max_new_tokens:
                    return out, stats
            p += n + 1
            last = out[-1]
        return out, stats


@torch.no_grad()
def greedy_reference_ids(
    decoder: Decoder,
    prompt_ids: Sequence[int],
    *,
    max_new_tokens: int = 128,
    eos_token_ids: Sequence[int] = (),
    max_len: int = 2048,
    cache_dtype: torch.dtype = torch.bfloat16,
) -> List[int]:
    """Plain one-token-at-a-time greedy decode (the exactness oracle)."""
    max_len = -(-max_len // 128) * 128
    cache = init_kv_cache(decoder.cfg, 1, max_len, dtype=cache_dtype, device=_device(decoder))
    prompt = [int(t) for t in prompt_ids]
    eos = {int(t) for t in eos_token_ids}
    out = [int(torch.argmax(_chunk_forward(decoder, prompt, cache, 0)[-1]))]
    p = len(prompt)
    while len(out) < max_new_tokens and out[-1] not in eos:
        out.append(int(torch.argmax(_chunk_forward(decoder, [out[-1]], cache, p)[-1])))
        p += 1
    return out
