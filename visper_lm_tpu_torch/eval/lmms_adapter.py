"""lmms-eval harness adapter (the port's counterpart of
visper_lm_tpu/eval/lmms_adapter.py).

The reference vendors a full lmms-eval fork whose llava model class is patched to
import ola_vlm (lmms-eval/lmms_eval/models/llava.py:26-29). Instead of vendoring ~280
files, this module provides `VisperLmms`, a model implementing the harness's `lmms`
interface (generate_until / loglikelihood / loglikelihood_rolling, api/model.py:203)
so an EXTERNAL lmms-eval installation can evaluate VisperModel checkpoints:

    from lmms_eval import evaluator
    from visper_lm_tpu_torch.eval.lmms_adapter import VisperLmms
    results = evaluator.simple_evaluate(model=VisperLmms(model), tasks=["realworldqa"])

Behavioral parity points:
  * `fix_text` strips '<|end|>' from Phi3 outputs (reference llava.py:199-201);
  * requests are length-sorted and batched (the harness's Collator pattern,
    llava.py:277-432), decode is greedy at temperature 0;
  * generation failures yield "" rather than aborting (llava.py:408-411); each
    one is kept in `errors` as (chunk index, repr of the exception) and
    reported on stderr, so a kernel that fails to build or launch is seen.

The model side runs on the VisperModel's device: `generate_until` through
`VisperModel.chat` (its prefill is the flash-attention kernel on CUDA),
`loglikelihood` through the VLM forward on the right-padded spliced sequence
and `loglikelihood_rolling` through the decoder with `kv_lengths`, both the
kernel on CUDA unless `use_kernel=False` (the plain path). The log-softmax of
the f32 logits is taken on the host in numpy, as in the JAX package.
"""

from __future__ import annotations

import sys
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def fix_text(text: str) -> str:
    return text.replace("<|end|>", "").strip()


class VisperLmms:
    """lmms-eval model wrapper around a VisperModel."""

    def __init__(self, model, batch_size: int = 8, max_new_tokens: int = 128,
                 use_kernel: Optional[bool] = None):
        self.model = model
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        self.use_kernel = use_kernel
        # harness attributes
        self.task_dict: dict = {}
        # generate_until's caught failures: (chunk index, repr(exception))
        self.errors: List[Tuple[int, str]] = []

    # -- lmms interface -----------------------------------------------------
    @property
    def rank(self) -> int:
        return 0

    @property
    def world_size(self) -> int:
        return 1

    def _visual(self, doc_to_visual, doc_id, task, split):
        doc = self.task_dict[task][split][doc_id] if self.task_dict else None
        return doc_to_visual(doc) if doc is not None else doc_to_visual(doc_id)

    def generate_until(self, requests: List[Any]) -> List[str]:
        """requests: lmms-eval Instances with .args = (context, gen_kwargs,
        doc_to_visual, doc_id, task, split). Sorted by context length, batched."""
        parsed = []
        for i, req in enumerate(requests):
            context, gen_kwargs, doc_to_visual, doc_id, task, split = req.args
            parsed.append((i, context, gen_kwargs, doc_to_visual, doc_id, task, split))

        order = sorted(parsed, key=lambda r: -len(r[1]))
        results: List[Optional[str]] = [None] * len(requests)

        for start in range(0, len(order), self.batch_size):
            chunk = order[start : start + self.batch_size]
            questions, images = [], []
            for (_, context, gen_kwargs, doc_to_visual, doc_id, task, split) in chunk:
                visuals = self._visual(doc_to_visual, doc_id, task, split)
                if isinstance(visuals, list):
                    visual = visuals[0] if visuals else None
                else:
                    visual = visuals
                questions.append(context)
                images.append(visual)
            max_new = self.max_new_tokens
            if chunk and isinstance(chunk[0][2], dict):
                max_new = chunk[0][2].get("max_new_tokens", self.max_new_tokens)
            try:
                outs = self.model.chat(questions, images, max_new_tokens=max_new)
            except Exception as e:   # the harness answers "" and goes on (llava.py:408-411)
                index = start // self.batch_size
                self.errors.append((index, repr(e)))
                print(f"VisperLmms.generate_until: chunk {index} failed: {e!r}", file=sys.stderr)
                outs = [""] * len(chunk)
            for (idx, *_), text in zip(chunk, outs):
                results[idx] = fix_text(text)
        return [r if r is not None else "" for r in results]

    @torch.no_grad()
    def continuation_logprobs(self, requests: List[Any]) -> List[Tuple[np.ndarray, bool]]:
        """Each request's per-token log-probabilities of its continuation
        (n_cont,) f64 and whether every token is the greedy one. args:
        (context, continuation, doc_to_visual, doc_id, task, split)."""
        from visper_lm_tpu_torch.data.collate import build_splice_plan
        from visper_lm_tpu_torch.data.mm_utils import process_images, tokenizer_image_token
        from visper_lm_tpu_torch.models.vlm import vlm_forward

        model = self.model
        dev = model.device
        out: List[Tuple[np.ndarray, bool]] = []
        for req in requests:
            context, continuation, doc_to_visual, doc_id, task, split = req.args
            visuals = self._visual(doc_to_visual, doc_id, task, split)
            visual = visuals[0] if isinstance(visuals, list) and visuals else visuals

            prompt = model.build_prompt(context)
            ctx_ids = tokenizer_image_token(prompt, model.tokenizer)
            cont_ids = [
                t for t in model.tokenizer(continuation).input_ids
                if t != getattr(model.tokenizer, "bos_token_id", None)
            ]
            full = ctx_ids + cont_ids

            d = model.cfg.distill
            spliced = (
                len(full) + model.cfg.num_image_tokens
                + (d.num_task_tokens * len(d.task_order()) if d else 0)
            )
            pad_to = -(-spliced // 128) * 128
            plan = build_splice_plan(
                full, None, pad_to,
                num_image_tokens=model.cfg.num_image_tokens,
                num_task_tokens=d.num_task_tokens if d else 0,
                num_tasks=len(d.task_order()) if d else 0,
            )
            pixels = process_images(
                [visual], image_aspect_ratio="square",
                image_size=model.cfg.vision.image_size,
            )
            batch = {
                "text_ids": torch.as_tensor(plan.text_ids, device=dev)[None],
                "token_type": torch.as_tensor(plan.token_type, device=dev)[None],
                "src_index": torch.as_tensor(plan.src_index, device=dev)[None],
                "seq_lengths": torch.tensor([plan.seq_length], device=dev),
                "images": torch.as_tensor(np.asarray(pixels, np.float32), device=dev),
            }
            fwd = vlm_forward(model.model, model.cfg, batch, use_kernel=self.use_kernel, tap=False)
            logits = fwd["logits"][0].float().cpu().numpy()
            n_cont = len(cont_ids)
            end = plan.seq_length
            lps = []
            greedy = True
            for j in range(n_cont):
                pos = end - n_cont + j - 1  # logits at pos predict token pos+1
                probs = logits[pos] - np.logaddexp.reduce(logits[pos])
                tok = cont_ids[j]
                lps.append(probs[tok])
                greedy = greedy and (int(np.argmax(logits[pos])) == tok)
            out.append((np.asarray(lps, np.float64), bool(greedy)))
        return out

    def loglikelihood(self, requests: List[Any]) -> List[Tuple[float, bool]]:
        """Scored continuation likelihoods for multiple-choice tasks."""
        return [(float(np.sum(lps.astype(np.float32))), greedy)
                for lps, greedy in self.continuation_logprobs(requests)]

    @torch.no_grad()
    def loglikelihood_rolling(self, requests: List[Any]) -> List[float]:
        """Full-string log-likelihood (text-only perplexity surface of the lmms
        interface, api/model.py:203). Each request's args is (string,) or
        (string, doc_to_visual, doc_id, task, split); scored token-by-token with
        the whole string as continuation after BOS."""

        model = self.model
        decoder = model.model.decoder
        dev = model.device
        out: List[float] = []
        for req in requests:
            text = req.args[0] if isinstance(req.args, tuple) else req.args
            ids = list(model.tokenizer(text).input_ids)
            bos = getattr(model.tokenizer, "bos_token_id", None)
            if bos is not None and (not ids or ids[0] != bos):
                ids = [bos] + ids
            if len(ids) < 2:
                out.append(0.0)
                continue
            pad_to = -(-len(ids) // 128) * 128
            arr = np.zeros((1, pad_to), np.int64)
            arr[0, : len(ids)] = ids
            embeds = decoder.embed(torch.as_tensor(arr, device=dev))
            fwd = decoder(embeds, kv_lengths=torch.tensor([len(ids)], device=dev),
                          use_kernel=self.use_kernel)
            logits = fwd["logits"][0].float().cpu().numpy()
            total = 0.0
            for pos in range(len(ids) - 1):
                lp = logits[pos] - np.logaddexp.reduce(logits[pos])
                total += float(lp[ids[pos + 1]])
            out.append(total)
        return out
