"""Batched multimodal generation: KV-cache prefill + chunked decode
(counterpart of visper_lm_tpu/serve/generate.py).

  * prompts are LEFT-padded to a static length so every sample's next slot is
    batch-uniform; pad slots are masked with kv_starts and rope positions are
    shifted so each sample's first real token is position 0;
  * prefill is one multimodal forward that fills the KV cache (the flash
    kernel on CUDA);
  * decode runs `decode_chunk` tokens per chunk with the tokens, the step and
    the slot it writes kept on the device and one host sync per chunk; stop
    conditions are checked at chunk boundaries and over-generated tokens are
    trimmed;
  * greedy (temperature 0: first-max argmax) or temperature/top-p sampling
    from a torch.Generator;
  * quantized serving: an int8 KV cache (`kv_quant`) and w8a16 or w4a16
    decoder weights (`weight_quant`, optionally AWQ-calibrated), quantized
    into the Generator's own decoder; the caller's model is left as it is.

The distillation heads do not run during generation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from visper_lm_tpu_torch import constants
from visper_lm_tpu_torch.config import VLMConfig
from visper_lm_tpu_torch.data.collate import SplicePlan
from visper_lm_tpu_torch.device import resolve_device
from visper_lm_tpu_torch.models.decoder import (
    KVCache,
    QuantKVCache,
    init_kv_cache,
    init_quant_kv_cache,
    quantize_decoder,
)
from visper_lm_tpu_torch.models.vlm import VLM, encode_images, splice_embeddings


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 128
    temperature: float = 0.0
    top_p: float = 1.0
    eos_token_ids: Tuple[int, ...] = ()
    stop_strings: Tuple[str, ...] = ()
    decode_chunk: int = 16            # tokens decoded between host syncs
    # int8 KV cache with per-(token, head) scales (half the bf16 cache bytes)
    kv_quant: bool = False
    # serving weights: True / "int8" = w8a16 per-output-channel int8 decoder
    # linears; "int4" = w4a16 group-wise int4 through the w4 kernel on CUDA
    # (a quality trade-off). The Generator quantizes its own copy.
    weight_quant: object = False
    # AWQ calibration for "int4": serve.calibrate.decoder_act_rms's dict;
    # ignored for other weight_quant modes
    calibration: object = None


def left_pad_plans(plans: Sequence[SplicePlan], pad_to: int) -> Dict[str, np.ndarray]:
    """Stack plans left-padded to pad_to. Returns batch dict + pad_offsets."""
    b = len(plans)
    text_ids = np.zeros((b, pad_to), dtype=np.int32)
    token_type = np.full((b, pad_to), constants.SEG_PAD, dtype=np.int32)
    src_index = np.zeros((b, pad_to), dtype=np.int32)
    offsets = np.zeros((b,), dtype=np.int32)
    for i, p in enumerate(plans):
        n = p.seq_length
        if n > pad_to:
            raise ValueError(f"plan {i} has {n} tokens, more than pad_to={pad_to}")
        off = pad_to - n
        offsets[i] = off
        text_ids[i, off:] = p.text_ids[:n]
        token_type[i, off:] = p.token_type[:n]
        src_index[i, off:] = p.src_index[:n]
    return {
        "text_ids": text_ids,
        "token_type": token_type,
        "src_index": src_index,
        "pad_offsets": offsets,
    }


def right_pad_plans(plans: Sequence[SplicePlan], pad_to: int) -> Dict[str, np.ndarray]:
    """Stack plans right-padded to pad_to (prefix-continuation prefill: the
    valid tokens sit flush against the cached prefix, so padding goes at the
    end; `seq_lengths` marks where each sample's real tokens stop)."""
    b = len(plans)
    text_ids = np.zeros((b, pad_to), dtype=np.int32)
    token_type = np.full((b, pad_to), constants.SEG_PAD, dtype=np.int32)
    src_index = np.zeros((b, pad_to), dtype=np.int32)
    seq_lengths = np.zeros((b,), dtype=np.int32)
    for i, p in enumerate(plans):
        n = p.seq_length
        if n > pad_to:
            raise ValueError(f"plan {i} has {n} tokens, more than pad_to={pad_to}")
        seq_lengths[i] = n
        text_ids[i, :n] = p.text_ids[:n]
        token_type[i, :n] = p.token_type[:n]
        src_index[i, :n] = p.src_index[:n]
    return {
        "text_ids": text_ids,
        "token_type": token_type,
        "src_index": src_index,
        "seq_lengths": seq_lengths,
    }


def _sample_tokens(
    logits: torch.Tensor, gen_cfg: GenerationConfig, generator: torch.Generator
) -> torch.Tensor:
    """(B, V) f32 logits -> (B,) int64 tokens."""
    if gen_cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)  # first maximal index, as jnp.argmax
    logits = logits / gen_cfg.temperature
    if gen_cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < gen_cfg.top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class Generator:
    """Prefill + chunked decode for a fixed (batch, prompt_len, max_len)."""

    def __init__(
        self,
        model: VLM,
        cfg: VLMConfig,
        gen_cfg: GenerationConfig,
        batch_size: int,
        prompt_len: int,
        cache_dtype: torch.dtype = torch.bfloat16,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        param = next(model.parameters())
        if param.device.type != self.device.type:
            raise ValueError(f"model is on {param.device}, generator on {self.device}")
        self.model = model
        self.cfg = cfg
        self.gen_cfg = gen_cfg
        self.batch_size = batch_size
        self.prompt_len = prompt_len
        chunk = max(gen_cfg.decode_chunk, 1)
        n_chunks = -(-gen_cfg.max_new_tokens // chunk)
        # cache length rounded up to a multiple of 128, as in the JAX package
        self.max_len = -(-(prompt_len + n_chunks * chunk + 1) // 128) * 128
        self.cache_dtype = cache_dtype
        self.decoder = model.decoder
        if gen_cfg.weight_quant:
            # truthy and not "int4" means int8, as in the JAX Generator
            mode = "int4" if gen_cfg.weight_quant == "int4" else "int8"
            calibration = gen_cfg.calibration if mode == "int4" else None
            self.decoder = quantize_decoder(model.decoder, mode, act_rms=calibration)

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    @torch.no_grad()
    def prefill(
        self, batch: Dict[str, Any], *, use_kernel: Optional[bool] = None
    ) -> Tuple[torch.Tensor, Union[KVCache, QuantKVCache]]:
        """Multimodal forward over the left-padded prompts that fills a new
        cache. Returns the last position's logits (B, vocab) f32 and the cache.
        use_kernel=False forces the plain version of every kernel on the path
        (flash attention and the w4 matmul), for comparisons."""
        batch = self._to_device(batch)
        model, cfg = self.model, self.cfg
        if "image_features" in batch:
            image_features = batch["image_features"]
        else:
            image_features = encode_images(model, batch["images"])
        embeds = splice_embeddings(
            model, batch["text_ids"].long(), batch["token_type"], batch["src_index"].long(),
            image_features,
        )
        offsets = batch["pad_offsets"].long()
        positions = (
            torch.arange(self.prompt_len, device=self.device)[None, :] - offsets[:, None]
        ).clamp(min=0)
        if self.gen_cfg.kv_quant:
            cache = init_quant_kv_cache(
                cfg.decoder, self.batch_size, self.max_len, device=self.device
            )
        else:
            cache = init_kv_cache(
                cfg.decoder, self.batch_size, self.max_len, dtype=self.cache_dtype,
                device=self.device,
            )
        out = self.decoder(
            embeds,
            positions=positions,
            kv_lengths=torch.full((self.batch_size,), self.prompt_len, device=self.device),
            kv_starts=offsets,
            cache=cache, q_offset=0, use_kernel=use_kernel, compute_logits=False,
        )
        # only the LAST position's logits are needed
        return self.decoder.logits(out["hidden"][:, -1], use_kernel), out["cache"]

    @torch.no_grad()
    def _decode_chunk(
        self, cache: Union[KVCache, QuantKVCache], token: torch.Tensor,
        step: Union[int, torch.Tensor], offsets: torch.Tensor, generator: torch.Generator,
    ) -> torch.Tensor:
        """Decode decode_chunk tokens on the device (no host sync). Returns (chunk, B).

        The step and the slot it writes are 0-d device tensors, as JAX's
        `_step_impl` takes `step` traced: nothing of the chunk depends on a
        host value but its length."""
        decoder = self.decoder
        step = torch.as_tensor(step, device=self.device)
        tokens = []
        for _ in range(max(self.gen_cfg.decode_chunk, 1)):
            slot = self.prompt_len + step
            emb = decoder.embed_tokens(token[:, None])
            positions = (slot - offsets)[:, None]
            out = decoder(
                emb, positions=positions, kv_lengths=(slot + 1).expand(self.batch_size),
                kv_starts=offsets, cache=cache, q_offset=slot,
            )
            token = _sample_tokens(out["logits"][:, 0], self.gen_cfg, generator)
            tokens.append(token)
            step = step + 1
        return torch.stack(tokens)

    @torch.no_grad()
    def generate(
        self,
        batch: Dict[str, Any],
        *,
        tokenizer=None,
        seed: int = 0,
        streamer=None,
    ) -> List[Any]:
        """Generated token ids per sample (without the prompt); decoded strings
        when stop_strings and a tokenizer are given."""
        gen_cfg = self.gen_cfg
        generator = torch.Generator(device=self.device).manual_seed(seed)
        offsets = torch.as_tensor(batch["pad_offsets"]).long().to(self.device)

        logits, cache = self.prefill(batch)
        token = _sample_tokens(logits, gen_cfg, generator)

        eos = set(gen_cfg.eos_token_ids)
        outputs: List[List[int]] = [[] for _ in range(self.batch_size)]
        finished = np.zeros((self.batch_size,), dtype=bool)

        def absorb(toks_np: np.ndarray) -> None:
            """toks_np: (n, B) tokens to append, respecting finished/eos/limits.

            streamer(row, accepted) is called per row with accepted[i] = True
            iff row[i] was appended to sample i's output."""
            for row in toks_np:
                accepted = np.zeros((self.batch_size,), dtype=bool)
                for i in range(self.batch_size):
                    if not finished[i] and len(outputs[i]) < gen_cfg.max_new_tokens:
                        outputs[i].append(int(row[i]))
                        accepted[i] = True
                        if int(row[i]) in eos:
                            finished[i] = True
                if streamer is not None and accepted.any():
                    streamer(row, accepted)
            if gen_cfg.stop_strings and tokenizer is not None:
                for i in range(self.batch_size):
                    if not finished[i]:
                        text = tokenizer.decode(outputs[i], skip_special_tokens=False)
                        if any(s in text for s in gen_cfg.stop_strings):
                            finished[i] = True

        absorb(token.cpu().numpy()[None])
        step = torch.zeros((), dtype=torch.long, device=self.device)

        def _need_more() -> bool:
            lens = [len(o) for i, o in enumerate(outputs) if not finished[i]]
            return bool(lens) and max(lens) < gen_cfg.max_new_tokens

        while _need_more():
            chunk_tokens = self._decode_chunk(cache, token, step, offsets, generator)
            toks_np = chunk_tokens.cpu().numpy()  # the chunk's one host sync
            token = chunk_tokens[-1]
            step = step + toks_np.shape[0]
            absorb(toks_np)

        if gen_cfg.stop_strings and tokenizer is not None:
            cleaned = []
            for ids in outputs:
                text = tokenizer.decode(ids, skip_special_tokens=False)
                for s in gen_cfg.stop_strings:
                    idx = text.find(s)
                    if idx >= 0:
                        text = text[:idx]
                cleaned.append(text)
            return cleaned
        return outputs


def greedy_decode_text(
    model: VLM,
    cfg: VLMConfig,
    plans: Sequence[SplicePlan],
    images: np.ndarray,
    tokenizer,
    *,
    max_new_tokens: int = 128,
    stop_strings: Sequence[str] = (),
    eos_token_ids: Sequence[int] = (),
    kv_quant: Optional[bool] = None,
    weight_quant: object = None,
    device: Optional[Union[str, torch.device]] = None,
) -> List[str]:
    """plans + images -> decoded strings, prompts left-padded to the next
    multiple of 128. kv_quant / weight_quant default to the quantized serving
    configuration (int8 KV + w8a16) when CUDA is present, bf16 otherwise."""
    if kv_quant is None:
        kv_quant = torch.cuda.is_available()
    if weight_quant is None:
        weight_quant = torch.cuda.is_available()
    longest = max(p.seq_length for p in plans)
    pad_to = -(-longest // 128) * 128
    batch = left_pad_plans(plans, pad_to)
    batch["images"] = images
    gen_cfg = GenerationConfig(
        max_new_tokens=max_new_tokens,
        eos_token_ids=tuple(eos_token_ids),
        stop_strings=tuple(stop_strings),
        kv_quant=bool(kv_quant),
        # keep "int4" intact: bool() would turn it into w8a16
        weight_quant=weight_quant if isinstance(weight_quant, str) else bool(weight_quant),
    )
    gen = Generator(model, cfg, gen_cfg, len(plans), pad_to, device=device)
    out = gen.generate(batch, tokenizer=tokenizer)
    if stop_strings:
        return [t.strip() for t in out]
    return [tokenizer.decode(ids, skip_special_tokens=True).strip() for ids in out]
