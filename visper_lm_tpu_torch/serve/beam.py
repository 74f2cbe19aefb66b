"""Beam search over the KV-cache decode path (counterpart of
visper_lm_tpu/serve/beam.py).

  * beams ride the BATCH axis of one KV cache; each step (1) reorders the
    cache rows to each surviving beam's parent with one `index_select` on
    the batch axis (axis 2 of the (L, S, B, Nkv, H) layout), written back
    into the cache tensors, (2) advances all beams one token through the
    decoder's cache route (a 0-d tensor offset, as JAX's traced int32, so
    even the prompt's prefill never reaches B1), and (3) takes the top
    max(2, 1 + n_eos)·B of the B·V candidate continuations with `torch.topk`
    on the device (HF's width rule: with k eos ids the top 2B could all be
    EOS and starve the live beams); only those scalars reach the host;
  * the hypothesis bookkeeping is host logic with HF's semantics: candidates
    ranked sorted, an EOS candidate retires only at rank < num_beams, scores
    normalised by generated_len ** length_penalty, and with
    early_stopping=False the search ends when the worst finished score beats
    best_sum_logprobs / cur_generated_len ** length_penalty
    (transformers BeamSearchScorer.process / BeamHypotheses.is_done);
  * num_beams=1 is the greedy path;
  * on a tensor-parallel decoder the cache holds the rank's nkv/tp heads
    (the reorder is the same gather) and `_select` reads the gathered
    logits, so every rank of the group keeps the same beams.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from visper_lm_tpu_torch.models.decoder import Decoder, KVCache, init_kv_cache


@dataclasses.dataclass
class _Hypothesis:
    tokens: List[int]      # generated tokens (no prompt, no trailing EOS)
    sum_logprobs: float
    score: float           # sum_logprobs / generated_len ** length_penalty


class BeamSearchDecoder:
    """Length-normalised beam search for one sequence (beams = batch rows)."""

    def __init__(
        self,
        decoder: Decoder,
        *,
        num_beams: int,
        max_len: int = 2048,
        cache_dtype: torch.dtype = torch.bfloat16,
        length_penalty: float = 1.0,
    ):
        if num_beams < 1:
            raise ValueError(f"num_beams must be >= 1, got {num_beams}")
        self.decoder = decoder
        self.cfg = decoder.cfg
        self.num_beams = num_beams
        self.length_penalty = float(length_penalty)
        self.max_len = -(-max_len // 128) * 128
        self.cache_dtype = cache_dtype
        self.device = decoder.embed_tokens.weight.device

    def _select(self, logits: torch.Tensor, beam_scores: torch.Tensor, width: int):
        """Top `width` of the B·V candidate continuations on the device:
        (scores, parents, tokens) on the host."""
        logp = torch.log_softmax(logits.float(), dim=-1)
        flat = (beam_scores[:, None] + logp).reshape(-1)
        top_scores, top_idx = torch.topk(flat, width)
        v = self.cfg.vocab_size
        picked = torch.stack([top_idx // v, top_idx % v]).cpu().numpy()
        return top_scores.cpu().numpy(), picked[0], picked[1]

    def _forward(self, tokens: torch.Tensor, cache: KVCache, offset: int) -> torch.Tensor:
        """The last position's logits (B, V) of a (B, t) chunk at `offset`."""
        q_offset = torch.full((), offset, dtype=torch.long, device=self.device)
        out = self.decoder(
            self.decoder.embed(tokens),
            kv_lengths=(q_offset + tokens.shape[1]).expand(tokens.shape[0]),
            cache=cache, q_offset=q_offset,
        )
        return out["logits"][:, -1]

    @torch.no_grad()
    def generate(
        self,
        prompt_ids: Sequence[int],
        *,
        max_new_tokens: int = 128,
        eos_token_ids: Sequence[int] = (),
    ) -> Tuple[List[int], float]:
        """Returns (best generated ids without EOS, normalised score)."""
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len; raise max_len")
        eos = {int(t) for t in eos_token_ids}
        B = self.num_beams
        # candidates per beam: HF's max(2, 1 + n_eos)
        width = max(2, 1 + len(eos)) * B
        cache = init_kv_cache(self.cfg, B, self.max_len, dtype=self.cache_dtype,
                              device=self.device, tp=self.decoder.tp_size)
        # beam 0 seeds the search; the others start unreachable, so step 1
        # expands B distinct continuations of the same prompt
        beam_scores = torch.tensor([0.0] + [-1e9] * (B - 1), device=self.device)
        toks = torch.as_tensor(np.tile(np.asarray(prompt, np.int64), (B, 1)), device=self.device)
        scores, parents, tokens = self._select(self._forward(toks, cache, 0), beam_scores, width)

        beams: List[List[int]] = [[] for _ in range(B)]
        finished: List[_Hypothesis] = []
        p = len(prompt)
        for step in range(max_new_tokens):
            gen_len = step + 1
            next_rows: List[Tuple[float, int, int]] = []
            for rank in range(len(scores)):
                s, par, tok = float(scores[rank]), int(parents[rank]), int(tokens[rank])
                if tok in eos:
                    # HF: an EOS candidate ranked past the top B could never
                    # have survived as a beam
                    if rank >= B:
                        continue
                    self._add_hypothesis(finished, beams[par], s, gen_len)
                else:
                    next_rows.append((s, par, tok))
                    if len(next_rows) == B:
                        break
            if len(next_rows) != B:
                raise RuntimeError("the candidate list ran out of non-EOS continuations")

            last = step == max_new_tokens - 1
            done = self._is_done(finished, float(scores[0]), gen_len)
            if done or last:
                if not done:
                    # length limit: live beams retire as they are (HF finalize)
                    for s, par, tok in next_rows:
                        self._add_hypothesis(finished, beams[par] + [tok], s, gen_len)
                break

            beams = [beams[par] + [tok] for _, par, tok in next_rows]
            beam_scores = torch.tensor([s for s, _, _ in next_rows], device=self.device)
            order = torch.tensor([par for _, par, _ in next_rows], device=self.device)
            # the previous step's selection: one gather on the batch axis
            for c in (cache.k, cache.v):
                c.copy_(c.index_select(2, order))
            step_toks = torch.tensor([[t] for _, _, t in next_rows], device=self.device)
            scores, parents, tokens = self._select(
                self._forward(step_toks, cache, p + step), beam_scores, width
            )

        best = max(finished, key=lambda h: h.score)
        return list(best.tokens), best.score

    def _add_hypothesis(self, finished: List[_Hypothesis], tokens: List[int],
                        sum_logprobs: float, gen_len: int) -> None:
        score = sum_logprobs / (gen_len ** self.length_penalty)
        finished.append(_Hypothesis(list(tokens), sum_logprobs, score))
        if len(finished) > self.num_beams:
            finished.remove(min(finished, key=lambda h: h.score))

    def _is_done(self, finished: List[_Hypothesis], best_sum_logprobs: float,
                 gen_len: int) -> bool:
        """early_stopping=False heuristic (BeamHypotheses.is_done)."""
        if len(finished) < self.num_beams:
            return False
        worst = min(h.score for h in finished)
        return worst >= best_sum_logprobs / (gen_len ** self.length_penalty)
