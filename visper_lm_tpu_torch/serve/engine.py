"""Continuous-batching serving engine: a slot-based KV cache with in-flight
joins (counterpart of visper_lm_tpu/serve/engine.py).

  * a fixed pool of decode SLOTS: the decode step's batch is always
    `num_slots` wide, occupied or not;
  * each slot holds one in-flight request at its OWN sequence position: the
    decoder writes new K/V at per-slot cache positions (a (B,) `q_offset`,
    models/decoder.write_cache_chunk, dropping writes past the cache) and
    masks per-slot valid ranges (ops/attention.mha_plain_cache takes a (B,)
    cache length);
  * when a request finishes its slot is refilled from the queue at once: a
    prefill at a bucketed prompt length (batch 1, or a group of compatible
    requests in one batched prefill) whose K/V column is copied into the
    shared cache;
  * a decode QUANTUM of `decode_quantum` tokens per slot runs between two
    host syncs: the (Q, B) tokens reach the host once, stop detection and
    slot retirement happen at quantum boundaries, and a just-admitted slot's
    first token rides along with that sync;
  * prefix caching (`prefill_prefix`, `harvest`, `Request.prefix`) and chunked
    prefill run only a suffix over a cached prefix, through the decoder's
    cache route with a 0-d tensor offset;
  * speculative decoding per slot (greedy): host-driven n-gram proposals
    verified in one (B, spec_k+1) forward (`spec_k`), or `spec_quantum`
    propose/verify/accept rounds from a (B, S) device history between syncs.

JAX's jitted programs (prefill-insert, grouped prefill-insert, suffix, step,
quantum, speculative step and quantum) are plain methods here, and its donated
buffers are tensors written in place. The prefill runs the flash kernel (B1)
and, at weight_quant="int4", every decoder linear runs the w4 kernel (B5).
Host-to-device copies of request data go through pinned memory without a
stream sync, and device scalars are made by fills, so the engine's reads of
device values are the only host syncs (`stats["host_syncs"]`).
`stats["prefill_tokens"]` counts the prompt tokens prefilled (a suffix over a
prefix counts only the suffix).

On a tensor-parallel model (parallel/tensor.py) the caches hold the rank's
nkv/tp heads and every logits read is the gathered vocabulary, so each rank
of the group runs the same schedule and samples the same tokens.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from visper_lm_tpu_torch.config import VLMConfig
from visper_lm_tpu_torch.constants import SEG_TEXT
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
from visper_lm_tpu_torch.serve.generate import (
    GenerationConfig,
    _sample_tokens,
    left_pad_plans,
    right_pad_plans,
)
from visper_lm_tpu_torch.serve.speculative import ngram_propose
from visper_lm_tpu_torch.utils.diagnostics import span

Cache = Union[KVCache, QuantKVCache]


@dataclasses.dataclass
class EngineConfig:
    num_slots: int = 8                 # decode batch width
    max_len: int = 2048                # shared KV cache length per slot
    prompt_bucket: int = 128           # prompt lengths round up to a multiple
    # chunked prefill: prompts longer than this prefill in <= chunk pieces
    # through the prefix-continuation path, at most ONE piece per engine step,
    # so occupied slots keep decoding between pieces (None: single shot).
    # Rounded up to a prompt_bucket multiple, so a piece carries no left pad.
    prefill_chunk: Optional[int] = None
    # tokens decoded per slot between two host syncs; stop detection and slot
    # retirement happen at quantum boundaries (absorb discards tokens past a
    # stop). 1 reproduces per-token scheduling.
    decode_quantum: int = 8
    temperature: float = 0.0
    top_p: float = 1.0
    kv_quant: bool = False             # int8 KV cache (as in Generator)
    weight_quant: object = False       # False | True/"int8" | "int4"
    calibration: object = None         # AWQ act-RMS dict for "int4"
    # slot-wise speculative decoding (greedy only): every engine step verifies
    # a (B, spec_k+1) chunk of n-gram proposals from each slot's own history;
    # rejected KV slots are masked by the per-slot lengths and overwritten by
    # the next chunk write. Token-exact against the plain step.
    spec_k: int = 0                    # drafted tokens per step (0 = off)
    spec_ngram: int = 3                # n-gram length for prompt lookup
    # speculative quantum: this many propose/verify/accept rounds per engine
    # step from a device token history, one host sync per step
    spec_quantum: int = 0
    # grouped admission: up to this many compatible queued requests (same
    # modality and shapes, no prefix handle) admit in ONE batched prefill at
    # the group's bucket; sizes round down to powers of two. 1 disables it;
    # ignored while chunked prefill is on.
    admit_group: int = 8
    # admission hysteresis: when a larger compatible group could form than the
    # free slots hold, defer admission up to this many steps so retirements
    # pool into one group admission (occupied slots keep decoding). 0: eager.
    admit_defer: int = 4


@dataclasses.dataclass
class PrefixHandle:
    """A prefilled, reusable KV prefix (a shared system prompt or chat
    history): `cache` is a batch-1, full-length (L, S, 1, ...) cache in the
    engine's layout with valid K/V at slots [start, length). Read only: many
    requests may continue from one handle, and `Engine.prefill_prefix(...,
    prefix=handle)` extends it into a new handle."""

    cache: Cache
    length: int        # one past the last valid kv slot
    start: int         # first valid kv slot (left-pad offset of the base turn)


@dataclasses.dataclass
class Request:
    plan: SplicePlan
    images: Optional[np.ndarray] = None        # (1, H, W, 3) or None (text only)
    image_features: Optional[Any] = None       # (1, N, hidden) array or tensor
    # continue from a cached prefix: plan then covers ONLY the new tokens
    prefix: Optional[PrefixHandle] = None
    max_new_tokens: int = 128
    eos_token_ids: Tuple[int, ...] = ()
    stop_strings: Tuple[str, ...] = ()
    uid: Any = None
    # called with each sampled token id as it lands (host-side streaming)
    stream_callback: Optional[Callable[[int], None]] = None
    # filled by the engine:
    output_ids: List[int] = dataclasses.field(default_factory=list)
    submit_t: float = 0.0
    first_token_t: float = 0.0
    done_t: float = 0.0
    # where the request's KV lives when it finishes, so harvest() can lift it
    # into a PrefixHandle before the slot is reused
    slot: Optional[int] = None
    slot_gen: int = -1
    final_kv_len: int = 0
    final_kv_start: int = 0
    # engine-internal: the request is mid chunked prefill (its `prefix` is the
    # engine's chunk progress, not a caller's handle)
    _chunking: bool = False
    # engine-internal: token history for prompt-lookup proposals (prompt text
    # ids + generated ids; spec_k > 0 only)
    _history: List[int] = dataclasses.field(default_factory=list)


def _arrays(cache: Cache) -> Tuple[torch.Tensor, ...]:
    if isinstance(cache, QuantKVCache):
        return cache.k, cache.v, cache.k_scale, cache.v_scale
    return cache.k, cache.v


class Engine:
    """Continuous-batching decode engine over a shared slot-major KV cache."""

    def __init__(
        self,
        model: VLM,
        cfg: VLMConfig,
        ecfg: EngineConfig,
        tokenizer=None,
        *,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        param = next(model.parameters())
        if param.device.type != self.device.type:
            raise ValueError(f"model is on {param.device}, engine on {self.device}")
        if ecfg.spec_k and ecfg.temperature != 0.0:
            raise ValueError("engine speculative decoding is greedy-only (temperature 0); "
                             "sampling uses the plain step or serve/speculative.py")
        self.model = model
        self.cfg = cfg
        self.ecfg = ecfg
        self.tokenizer = tokenizer
        self.decoder = model.decoder
        if ecfg.weight_quant:
            # truthy and not "int4" means int8, as in the JAX engine
            mode = "int4" if ecfg.weight_quant == "int4" else "int8"
            calibration = ecfg.calibration if mode == "int4" else None
            self.decoder = quantize_decoder(model.decoder, mode, act_rms=calibration)
        self._gen_cfg = GenerationConfig(temperature=ecfg.temperature, top_p=ecfg.top_p)
        self._generator = torch.Generator(device=self.device).manual_seed(0)

        B, S = ecfg.num_slots, ecfg.max_len
        self.cache = self._new_cache(B, S)
        # per-slot device state: empty slots mask everything (kv_starts = S)
        self.lengths = self._full((B,), 0)         # valid kv length (write position)
        self.kv_starts = self._full((B,), S)       # first valid slot
        self.tokens = self._full((B,), 0)          # last sampled token
        # host mirrors: every host decision (stop checks, capacity, harvest
        # bookkeeping) reads these, never the device state
        self.lengths_host = np.zeros((B,), np.int64)
        self.kv_starts_host = np.full((B,), S, np.int64)
        self.tokens_host = np.zeros((B,), np.int64)
        # slots whose prefill-sampled first token awaits the next quantum sync
        self._pending_first = [False] * B
        self.slot_req: List[Optional[Request]] = [None] * B
        self.slot_gen = [0] * B           # bumps on every fill (harvest guard)
        self.queue: collections.deque[Request] = collections.deque()
        # requests finished since the last run() drain
        self.finished: List[Request] = []
        self._chunk: Optional[int] = None
        if ecfg.prefill_chunk:
            b = ecfg.prompt_bucket
            self._chunk = min(-(-ecfg.prefill_chunk // b) * b, ecfg.max_len)
        if ecfg.spec_k and ecfg.spec_quantum > 0:
            # device token history (text prompt + emitted tokens) for in-graph
            # prompt-lookup proposals; one row per slot
            self.hist = self._full((B, S), 0)
            self.hist_len = self._full((B,), 0)
        self.stats = {"steps": 0, "decoded_tokens": 0, "slot_steps": 0,
                      "prefills": 0, "spec_proposed": 0, "spec_accepted": 0,
                      "group_admissions": 0, "admit_dispatches": 0, "host_syncs": 0,
                      "prefill_tokens": 0}
        self._admit_deferred = 0

    # ------------------------------------------------------------ device I/O

    def _full(self, shape, value: int) -> torch.Tensor:
        """A long tensor made on the device by a fill: no host copy."""
        return torch.full(shape, value, dtype=torch.long, device=self.device)

    def _upload(self, x: Any) -> torch.Tensor:
        """Host data to the device without a stream sync (pinned, non-blocking)."""
        if torch.is_tensor(x):
            return x.to(self.device)
        t = torch.as_tensor(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _to_host(self, x: torch.Tensor) -> np.ndarray:
        """The engine's one kind of host sync: a device value read back (the
        `engine.sync` span holds the read alone, not the conversion)."""
        self.stats["host_syncs"] += 1
        with span("engine.sync"):
            x = x.cpu()
        return x.numpy()

    def _new_cache(self, batch: int, length: int) -> Cache:
        """int8 with scales (kv_quant), else bf16 whatever the model's dtype,
        as JAX's engine keeps it."""
        d, split = self.cfg.decoder, self.decoder.tp_size
        if self.ecfg.kv_quant:
            return init_quant_kv_cache(d, batch, length, device=self.device, tp=split)
        return init_kv_cache(d, batch, length, dtype=torch.bfloat16, device=self.device, tp=split)

    def _image_inputs(self, batch: Dict[str, Any], images: Sequence[Any],
                      features: Sequence[Any]) -> None:
        """Each row's image features (arrays or device tensors) or images, as
        the first row has them, into batch on the device."""
        if features[0] is not None:
            batch["image_features"] = torch.cat([self._upload(f) for f in features])
        elif images[0] is not None:
            batch["images"] = self._upload(np.concatenate(images))

    # ---------------------------------------------------------------- prefill

    @torch.no_grad()
    def _embed(self, batch: Dict[str, Any]) -> torch.Tensor:
        if "image_features" in batch:
            image_features = batch["image_features"]
        elif "images" in batch:
            image_features = encode_images(self.model, batch["images"])
        else:
            image_features = None
        return splice_embeddings(
            self.model, batch["text_ids"].long(), batch["token_type"],
            batch["src_index"].long(), image_features,
        )

    @torch.no_grad()
    def _prefill(
        self, batch: Dict[str, Any], pad_to: int, cache_len: int,
        use_kernel: Optional[bool] = None,
    ) -> Tuple[torch.Tensor, Cache]:
        """Left-padded prefill of k prompts at the bucket pad_to into a new
        (L, cache_len, k, ...) cache: the flash kernel's route (q_offset the
        int 0). Returns the last position's logits (k, V) f32 and the cache.
        use_kernel=False runs the plain versions, for comparisons."""
        embeds = self._embed(batch)
        k = embeds.shape[0]
        offsets = batch["pad_offsets"].long()
        positions = (
            torch.arange(pad_to, device=self.device)[None, :] - offsets[:, None]
        ).clamp(min=0)
        cache = self._new_cache(k, cache_len)
        out = self.decoder(
            embeds, positions=positions, kv_lengths=self._full((k,), pad_to),
            kv_starts=offsets, cache=cache, q_offset=0, use_kernel=use_kernel,
            compute_logits=False,
        )
        return self.decoder.logits(out["hidden"][:, -1], use_kernel), cache

    def _left_batch(self, reqs: Sequence[Request], pad_to: int) -> Dict[str, Any]:
        batch = {k: self._upload(v) for k, v in
                 left_pad_plans([r.plan for r in reqs], pad_to).items()}
        self._image_inputs(batch, [r.images for r in reqs], [r.image_features for r in reqs])
        return batch

    @torch.no_grad()
    def prefill_logits(self, req: Request, use_kernel: Optional[bool] = None) -> torch.Tensor:
        """The (1, V) f32 next-token logits of a batch-1 prefill of `req`'s
        prompt, as an admission computes them (no slot is touched)."""
        pad_to = self._bucket(req.plan.seq_length)
        logits, _ = self._prefill(self._left_batch([req], pad_to), pad_to, pad_to, use_kernel)
        return logits

    @torch.no_grad()
    def _run_suffix(self, prefix: PrefixHandle, plan: SplicePlan, images, image_features):
        """Batch-1 continuation prefill: only the new tokens, right-padded to
        a bucket, over a copy of the prefix cache at a 0-d tensor offset (the
        cache route). Returns (last valid token's logits, the full cache,
        new length). The right-padded tail computes values nobody reads:
        extras are causally masked for the real queries, cache reads stop at
        the lengths, and later writes overwrite those slots."""
        pad_to = self._bucket(plan.seq_length)
        if prefix.length + pad_to > self.ecfg.max_len:
            raise ValueError("prefix + suffix bucket exceeds cache capacity")
        batch = {k: self._upload(v) for k, v in right_pad_plans([plan], pad_to).items()}
        self._image_inputs(batch, [images], [image_features])
        embeds = self._embed(batch)
        cache = type(prefix.cache)(*(c.clone() for c in _arrays(prefix.cache)))
        positions = (prefix.length - prefix.start) + torch.arange(pad_to, device=self.device)[None]
        q_offset = torch.full((), prefix.length, dtype=torch.long, device=self.device)
        out = self.decoder(
            embeds, positions=positions, kv_lengths=q_offset + batch["seq_lengths"].long(),
            kv_starts=self._full((1,), prefix.start), cache=cache, q_offset=q_offset,
            compute_logits=False,
        )
        logits = self.decoder.logits(out["hidden"][:, plan.seq_length - 1])
        return logits, cache, prefix.length + plan.seq_length

    # ---------------------------------------------------------- prefix cache

    def prefill_prefix(
        self,
        plan: SplicePlan,
        images: Optional[np.ndarray] = None,
        image_features: Optional[Any] = None,
        prefix: Optional[PrefixHandle] = None,
    ) -> PrefixHandle:
        """Prefill `plan` into a reusable KV prefix handle.

        Without `prefix`: a fresh base prefix (bucketed, left-padded: no
        garbage slots). With `prefix`: extends it with `plan`'s tokens (chat
        history growth) into a new handle; the older one stays valid."""
        self.stats["prefill_tokens"] += plan.seq_length
        if prefix is None:
            pad_to = self._bucket(plan.seq_length)
            req = Request(plan=plan, images=images, image_features=image_features)
            _, cache = self._prefill(self._left_batch([req], pad_to), pad_to,
                                     self.ecfg.max_len)
            return PrefixHandle(cache=cache, length=pad_to, start=pad_to - plan.seq_length)
        _, cache, new_len = self._run_suffix(prefix, plan, images, image_features)
        return PrefixHandle(cache=cache, length=new_len, start=prefix.start)

    @torch.no_grad()
    def _insert(self, slots: Sequence[int], kv: Cache, firsts: torch.Tensor,
                new_lens: Sequence[int], new_starts: Sequence[int]) -> None:
        """Copy prefilled K/V columns (batch i of kv) into the shared cache at
        slots[i] and set the slots' device state. Slots past kv's length keep
        what they held: they lie at or past the slot's length and are masked."""
        n = kv.k.shape[1]
        for c, u in zip(_arrays(self.cache), _arrays(kv)):
            for i, slot in enumerate(slots):
                c[:, :n, slot].copy_(u[:, :, i])
        for i, slot in enumerate(slots):
            # fill_ takes the int as a kernel argument; item assignment of a
            # host int copies it to the device and synchronises
            self.lengths[slot].fill_(new_lens[i])
            self.kv_starts[slot].fill_(new_starts[i])
            self.tokens[slot].copy_(firsts[i])

    # ------------------------------------------------------------------ step

    @torch.no_grad()
    def _decode(self, tokens: torch.Tensor, lengths: torch.Tensor, n: int):
        """n decode tokens for every slot (occupied or not) at its own
        position. Returns ((n, B) tokens, last tokens, lengths); slots at
        capacity stop advancing (their writes are dropped anyway)."""
        out = []
        with span("engine.decode", n=n, slots=tokens.shape[0]):
            for _ in range(n):
                emb = self.decoder.embed(tokens[:, None])
                o = self.decoder(
                    emb, positions=(lengths - self.kv_starts)[:, None], kv_lengths=lengths + 1,
                    kv_starts=self.kv_starts, cache=self.cache, q_offset=lengths,
                )
                tokens = _sample_tokens(o["logits"][:, 0], self._gen_cfg, self._generator)
                lengths = (lengths + 1).clamp(max=self.ecfg.max_len)
                out.append(tokens)
            return torch.stack(out), tokens, lengths

    @torch.no_grad()
    def _verify(self, chunk: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """One (B, k+1) target forward at every slot's own positions (one
        weight read serves up to k+1 tokens a slot); the argmax at each."""
        k1 = chunk.shape[1]
        emb = self.decoder.embed(chunk)
        positions = (lengths - self.kv_starts)[:, None] + torch.arange(k1, device=self.device)
        out = self.decoder(
            emb, positions=positions, kv_lengths=lengths + k1, kv_starts=self.kv_starts,
            cache=self.cache, q_offset=lengths,
        )
        return torch.argmax(out["logits"], dim=-1)

    def _propose(self, hist: torch.Tensor, hlen: torch.Tensor) -> torch.Tensor:
        """Per row, the most recent earlier occurrence of the last m-gram
        (m = spec_ngram..1, `ngram_propose`'s rule) and the k tokens after it
        as a (B, k) draft, -1 where nothing matches (a -1 never equals an
        argmax). Slices clamp into the row as JAX's dynamic_slice does."""
        k, n = self.ecfg.spec_k, self.ecfg.spec_ngram
        b, h = hist.shape
        idx = torch.arange(h, device=self.device)
        best = self._full((b,), -1)
        mstar = self._full((b,), 0)
        for m in range(n, 0, -1):
            ar = torch.arange(m, device=self.device)
            win = hist[:, (idx[:, None] + ar[None, :]) % h]                  # (B, H, m)
            sfx_start = (hlen - m).clamp(min=0).clamp(max=h - m)
            suffix = torch.gather(hist, 1, sfx_start[:, None] + ar[None, :])  # (B, m)
            ok = ((win == suffix[:, None, :]).all(dim=2)
                  & (idx[None, :] < (hlen - m)[:, None]) & (hlen >= m + 1)[:, None])
            b_m = torch.where(ok, idx[None, :], -1).amax(dim=1)
            take = (best < 0) & (b_m >= 0)
            mstar = torch.where(take, m, mstar)
            best = torch.where(take, b_m, best)
        start = (best + mstar).clamp(min=0)
        ak = torch.arange(k, device=self.device)
        draft = torch.gather(hist, 1, start.clamp(max=h - k)[:, None] + ak[None, :])
        valid = (best >= 0)[:, None] & (start[:, None] + ak[None, :] < hlen[:, None])
        return torch.where(valid, draft, -1)

    @torch.no_grad()
    def _spec_rounds(self):
        """spec_quantum rounds of device proposals, a (B, k+1) verify, greedy
        acceptance and history / length advance, with no host read. Returns
        (emitted (R, B, k+1), n_emit (R, B), n_prop (R, B))."""
        k, S = self.ecfg.spec_k, self.ecfg.max_len
        toks, lens, hist, hl = self.tokens, self.lengths, self.hist, self.hist_len
        jidx = torch.arange(k + 1, device=self.device)[None, :]
        emitted_r, n_emit_r, n_prop_r = [], [], []
        for _ in range(self.ecfg.spec_quantum):
            drafts = self._propose(hist, hl)                                 # (B, k)
            chunk = torch.cat([toks[:, None], drafts], dim=1)
            am = self._verify(chunk.clamp(min=0), lens)                      # (B, k+1)
            n_acc = (drafts == am[:, :-1]).long().cumprod(dim=1).sum(dim=1)
            bonus = torch.gather(am, 1, n_acc[:, None])
            drafts_p = torch.cat([drafts, torch.full_like(drafts[:, :1], -1)], dim=1)
            emitted = torch.where(
                jidx < n_acc[:, None], drafts_p,
                torch.where(jidx == n_acc[:, None], bonus, -1),
            )
            n_emit = n_acc + 1
            # rejected KV slots stay masked by the per-slot lengths and are
            # overwritten by the next (monotonically advancing) chunk write
            lens = (lens + n_emit).clamp(max=S)
            at = hl.clamp(max=S - (k + 1))[:, None] + jidx
            hist.scatter_(1, at, emitted)
            hl = hl + n_emit
            toks = bonus[:, 0]
            emitted_r.append(emitted)
            n_emit_r.append(n_emit)
            n_prop_r.append((drafts >= 0).sum(dim=1))
        self.tokens, self.lengths, self.hist_len = toks, lens, hl
        return torch.stack(emitted_r), torch.stack(n_emit_r), torch.stack(n_prop_r)

    # ------------------------------------------------------------- host logic

    def submit(self, req: Request) -> None:
        req.submit_t = time.perf_counter()
        self.queue.append(req)

    def _bucket(self, n: int) -> int:
        b = self.ecfg.prompt_bucket
        return min(-(-n // b) * b, self.ecfg.max_len)

    @torch.no_grad()
    def _encode_images_once(self, images) -> torch.Tensor:
        return encode_images(self.model, self._upload(images))

    def _chunk_plan(self, plan: SplicePlan, a: int, b: int) -> SplicePlan:
        return SplicePlan(
            text_ids=plan.text_ids[a:b], token_type=plan.token_type[a:b],
            src_index=plan.src_index[a:b], labels=plan.labels[a:b],
            seq_length=b - a,
        )

    def _needs_chunk(self, req: Request) -> bool:
        """True while `req`'s remaining prompt must advance by one more chunk
        before it can take a slot. A request with a caller's prefix handle is
        never chunked (its plan is already a suffix)."""
        return bool(
            self._chunk
            and req.plan.seq_length > self._chunk
            and (req.prefix is None or req._chunking)
        )

    def _advance_chunk(self, req: Request) -> None:
        """Prefill ONE chunk of `req`'s prompt into its chunk-progress handle
        (the request stays queued). The final <= chunk tokens stay as the
        request's suffix: their prefill seeds its first token at admission."""
        chunk = self._chunk
        if req.image_features is None and req.images is not None:
            # encode once; every chunk splices from the same feature rows
            req.image_features = self._encode_images_once(req.images)
            req.images = None
        n = req.plan.seq_length
        head = self._chunk_plan(req.plan, 0, chunk)
        if self.ecfg.spec_k:
            req._history.extend(self._plan_text_ids(head))
        req.prefix = self.prefill_prefix(
            head, image_features=req.image_features, prefix=req.prefix,
        )
        req.plan = self._chunk_plan(req.plan, chunk, n)
        req._chunking = True

    @staticmethod
    def _plan_text_ids(plan: SplicePlan) -> List[int]:
        tt = np.asarray(plan.token_type)[: plan.seq_length]
        ids = np.asarray(plan.text_ids)[: plan.seq_length]
        return [int(t) for t in ids[tt == SEG_TEXT]]

    def _seed_history(self, slot: int, req: Request, first: int) -> None:
        """The slot's device history row: the FULL prompt's text ids (every
        chunk's, which req._history holds) + the first token."""
        ids = list(req._history) + [first]
        if len(ids) > self.ecfg.max_len:
            ids = ids[-self.ecfg.max_len:]
        row = np.full((self.ecfg.max_len,), -1, np.int64)
        row[: len(ids)] = ids
        self.hist[slot].copy_(self._upload(row))
        self.hist_len[slot].fill_(len(ids))

    def _take_firsts(self, slots: Sequence[int], reqs: Sequence[Request],
                     firsts: torch.Tensor) -> None:
        """First tokens of just-filled slots: absorbed now (one sync for the
        group) when speculation or per-token scheduling needs their values on
        the host, else at the next quantum's sync."""
        if not (self.ecfg.spec_k or self.ecfg.decode_quantum <= 1):
            for slot in slots:
                self._pending_first[slot] = True
            return
        firsts_host = self._to_host(firsts)
        for i, (slot, req) in enumerate(zip(slots, reqs)):
            self.tokens_host[slot] = int(firsts_host[i])
            if self.ecfg.spec_k:
                req._history.extend(self._plan_text_ids(req.plan))
            if self.ecfg.spec_k and self.ecfg.spec_quantum > 0:
                self._seed_history(slot, req, int(firsts_host[i]))
            self._absorb(slot, int(firsts_host[i]))
            self._pending_first[slot] = False

    def _occupy(self, slot: int, req: Request, new_len: int, new_start: int, now: float) -> None:
        self.lengths_host[slot] = new_len
        self.kv_starts_host[slot] = new_start
        self.slot_gen[slot] += 1
        self.slot_req[slot] = req
        req.first_token_t = now

    @torch.no_grad()
    def _fill_slot(self, slot: int, req: Request) -> None:
        plan = req.plan
        if req.prefix is not None:
            logits, kv, new_len = self._run_suffix(
                req.prefix, plan, req.images, req.image_features
            )
            new_start = req.prefix.start
        else:
            if plan.seq_length > self.ecfg.max_len:
                raise ValueError("prompt exceeds the cache")
            pad_to = self._bucket(plan.seq_length)
            logits, kv = self._prefill(self._left_batch([req], pad_to), pad_to, pad_to)
            new_len, new_start = pad_to, pad_to - plan.seq_length
        first = _sample_tokens(logits, self._gen_cfg, self._generator)
        self._insert([slot], kv, first, [new_len], [new_start])
        self._occupy(slot, req, new_len, new_start, time.perf_counter())
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += plan.seq_length
        self.stats["admit_dispatches"] += 1
        self._take_firsts([slot], [req], first)

    @torch.no_grad()
    def _fill_slots(self, slots: List[int], reqs: List[Request]) -> None:
        """Grouped admission of len(slots) compatible requests in one batched
        prefill; the host bookkeeping is _fill_slot's for each slot."""
        plans = [r.plan for r in reqs]
        if any(p.seq_length > self.ecfg.max_len for p in plans):
            raise ValueError("prompt exceeds the cache")
        pad_to = self._bucket(max(p.seq_length for p in plans))
        logits, kv = self._prefill(self._left_batch(reqs, pad_to), pad_to, pad_to)
        firsts = _sample_tokens(logits, self._gen_cfg, self._generator)
        new_starts = [pad_to - p.seq_length for p in plans]
        self._insert(slots, kv, firsts, [pad_to] * len(slots), new_starts)
        now = time.perf_counter()
        for slot, req, start in zip(slots, reqs, new_starts):
            self._occupy(slot, req, pad_to, start, now)
        self.stats["prefills"] += len(slots)
        self.stats["prefill_tokens"] += sum(p.seq_length for p in plans)
        self.stats["admit_dispatches"] += 1
        self.stats["group_admissions"] += 1
        self._take_firsts(slots, reqs, firsts)

    def _absorb(self, slot: int, token: int, slot_len: Optional[int] = None) -> None:
        """Append a sampled token to the slot's request; retire it on a stop.
        `slot_len` overrides the capacity check's view of the slot's kv length
        (the speculative path emits several tokens before the mirror moves)."""
        req = self.slot_req[slot]
        if req is None:
            return
        req.output_ids.append(token)
        if self.ecfg.spec_k:
            req._history.append(token)
        if req.stream_callback is not None:
            req.stream_callback(token)
        self.stats["decoded_tokens"] += 1
        if slot_len is None:
            slot_len = int(self.lengths_host[slot])
        done = (
            token in req.eos_token_ids
            or len(req.output_ids) >= req.max_new_tokens
            or self.ecfg.max_len - slot_len <= 1
        )
        if not done and req.stop_strings and self.tokenizer is not None:
            text = self.tokenizer.decode(req.output_ids, skip_special_tokens=False)
            done = any(s in text for s in req.stop_strings)
        if done:
            req.done_t = time.perf_counter()
            # the cache holds K/V for the prompt and every output token but the
            # last (the next step would have written it)
            req.slot = slot
            req.slot_gen = self.slot_gen[slot]
            req.final_kv_len = slot_len
            req.final_kv_start = int(self.kv_starts_host[slot])
            self.finished.append(req)
            self.slot_req[slot] = None

    def harvest(self, req: Request) -> Optional[PrefixHandle]:
        """Lift a finished request's slot K/V into a reusable PrefixHandle
        covering its prompt and output_ids[:-1] (the last token's K/V was never
        written: put it at the head of the next suffix). None if the slot has
        been refilled since (the K/V is gone): re-prefill instead."""
        if req.slot is None or self.slot_gen[req.slot] != req.slot_gen:
            return None
        cache = type(self.cache)(*(c[:, :, req.slot:req.slot + 1].clone()
                                   for c in _arrays(self.cache)))
        return PrefixHandle(cache=cache, length=req.final_kv_len, start=req.final_kv_start)

    @staticmethod
    def _group_compatible(a: Request, b: Request) -> bool:
        """Requests that can share one batched admission: no prefix handle,
        the same modality (both images / both features / both text only)
        with identical array shapes."""
        if a.prefix is not None or b.prefix is not None:
            return False

        def sig(r):
            if r.image_features is not None:
                return ("feat", tuple(np.shape(r.image_features)))
            if r.images is not None:
                return ("img", tuple(np.shape(r.images)))
            return ("text",)

        return sig(a) == sig(b)

    def _admit(self) -> None:
        """Move queued requests into free slots. With chunked prefill, at most
        ONE prefill unit (a chunk advance or a slot fill) runs per call, so
        occupied slots keep decoding between pieces; otherwise compatible
        requests admit in groups (one batched prefill each). The
        `engine.admit` span holds the prefill work and carries the number of
        requests it admitted."""
        if self._chunk:
            for slot in range(self.ecfg.num_slots):
                if self.slot_req[slot] is None and self.queue:
                    req = self.queue[0]
                    if self._needs_chunk(req):
                        with span("engine.admit", requests=0):
                            self._advance_chunk(req)
                        return  # the request stays queued; decode interleaves
                    with span("engine.admit", requests=1):
                        self._fill_slot(slot, self.queue.popleft())
                    return  # one prefill unit per step
            return
        free = [s for s in range(self.ecfg.num_slots) if self.slot_req[s] is None]
        if free and self.queue and self.ecfg.admit_defer:
            # hysteresis: if a bigger compatible group could form than the free
            # slots hold, keep decoding and pool the retirements
            head = self.queue[0]
            n_compat = 1
            # capped at num_slots: the group a full retirement could take
            cap = min(len(self.queue), max(self.ecfg.admit_group, 1), self.ecfg.num_slots)
            while n_compat < cap and self._group_compatible(head, self.queue[n_compat]):
                n_compat += 1
            occupied = self.ecfg.num_slots - len(free)
            if (occupied > 0 and len(free) < n_compat
                    and self._admit_deferred < self.ecfg.admit_defer):
                self._admit_deferred += 1
                return
        self._admit_deferred = 0
        if not (free and self.queue):
            return
        # every pass of the loop takes as many requests as slots
        with span("engine.admit", requests=min(len(free), len(self.queue))):
            while free and self.queue:
                head = self.queue[0]
                limit = min(len(free), max(self.ecfg.admit_group, 1))
                n = 1
                while (n < limit and n < len(self.queue)
                       and self._group_compatible(head, self.queue[n])):
                    n += 1
                while n & (n - 1):      # round down to a power of two
                    n &= n - 1
                if n == 1:
                    self._fill_slot(free.pop(0), self.queue.popleft())
                else:
                    reqs = [self.queue.popleft() for _ in range(n)]
                    self._fill_slots([free.pop(0) for _ in range(n)], reqs)

    def step(self) -> None:
        """Admit queued requests into free slots, then decode one QUANTUM of
        tokens per slot (or verify a speculative chunk per slot when spec_k
        is on): one host sync per quantum, not per token. All of it in the
        `engine.step` span."""
        with span("engine.step"):
            self._step()

    def _step(self) -> None:
        self._admit()
        if not any(r is not None for r in self.slot_req):
            return
        if self.ecfg.spec_k and self.ecfg.spec_quantum > 0 and self._spec_capacity_ok(
            margin=self.ecfg.spec_quantum * (self.ecfg.spec_k + 1)
        ):
            self._spec_quantum_step()
            return
        if self.ecfg.spec_k and self._spec_capacity_ok():
            self._spec_decode_step()
            return
        q = max(self.ecfg.decode_quantum, 1)
        in_tokens = self.tokens
        toks_stack, self.tokens, self.lengths = self._decode(in_tokens, self.lengths, q)
        if q == 1:
            toks = self._to_host(toks_stack)                   # (1, B)
            in_toks = None
        else:
            # ONE sync for the quantum's tokens AND any deferred first tokens
            joined = self._to_host(torch.cat([in_tokens[None, :], toks_stack], dim=0))
            in_toks, toks = joined[0], joined[1:]
        self.tokens_host = toks[-1].copy()
        base = self.lengths_host.copy()
        self.lengths_host = np.minimum(base + toks.shape[0], self.ecfg.max_len)
        self.stats["steps"] += 1
        for slot in range(self.ecfg.num_slots):
            if self.slot_req[slot] is None:
                continue
            if self._pending_first[slot] and in_toks is not None:
                self._pending_first[slot] = False
                self.stats["slot_steps"] += 1
                self._absorb(slot, int(in_toks[slot]), slot_len=int(base[slot]))
                if self.slot_req[slot] is None:
                    continue
            for j in range(toks.shape[0]):
                self.stats["slot_steps"] += 1
                self._absorb(slot, int(toks[j, slot]),
                             slot_len=int(min(base[slot] + j + 1, self.ecfg.max_len)))
                if self.slot_req[slot] is None:
                    # retired mid-quantum: later tokens are discarded (their
                    # K/V lands outside the harvest range)
                    break

    def _spec_capacity_ok(self, margin: Optional[int] = None) -> bool:
        """A verify chunk writes spec_k+1 K/V slots per occupied slot; near the
        cache end take the plain step instead, so a valid slot is never
        overwritten."""
        k1 = margin if margin is not None else self.ecfg.spec_k + 1
        for slot, req in enumerate(self.slot_req):
            if req is not None and int(self.lengths_host[slot]) + k1 > self.ecfg.max_len:
                return False
        return True

    def _spec_quantum_step(self) -> None:
        """spec_quantum speculative rounds on the device, then every emitted
        token absorbed from ONE host sync."""
        emitted, n_emit, n_prop = self._spec_rounds()
        r_, b_, k1 = emitted.shape
        flat = self._to_host(torch.cat(
            [emitted.reshape(r_, -1), n_emit, n_prop], dim=1))          # one sync
        em = flat[:, : b_ * k1].reshape(r_, b_, k1)
        ne, npp = flat[:, b_ * k1 : b_ * k1 + b_], flat[:, b_ * k1 + b_ :]
        cur = self.lengths_host.astype(np.int64).copy()
        self.stats["steps"] += 1
        active0 = [r is not None for r in self.slot_req]
        for r in range(r_):
            for slot in range(self.ecfg.num_slots):
                req = self.slot_req[slot]
                cnt = int(ne[r, slot])
                if req is not None:
                    if active0[slot]:
                        self.stats["spec_proposed"] += int(npp[r, slot])
                        self.stats["spec_accepted"] += cnt - 1
                    for j in range(cnt):
                        self.stats["slot_steps"] += 1
                        self._absorb(slot, int(em[r, slot, j]),
                                     slot_len=int(min(cur[slot] + j + 1, self.ecfg.max_len)))
                        if self.slot_req[slot] is None:
                            break
                # the device advanced EVERY slot, occupied or not: mirror it
                cur[slot] = min(cur[slot] + cnt, self.ecfg.max_len)
        self.lengths_host = cur
        self.tokens_host = np.array(
            [em[-1, s, max(int(ne[-1, s]) - 1, 0)] for s in range(self.ecfg.num_slots)],
            np.int64,
        )

    def _spec_decode_step(self) -> None:
        """One speculative engine step: host n-gram proposals per slot, one
        batched (B, k+1) verify forward, per-slot greedy acceptance. The
        emitted tokens are the target's greedy tokens (drafts only move how
        many land per weight read)."""
        k = self.ecfg.spec_k
        B = self.ecfg.num_slots
        toks_host = self.tokens_host.copy()
        chunk = np.zeros((B, k + 1), np.int64)
        proposals: List[List[int]] = []
        for slot in range(B):
            req = self.slot_req[slot]
            prop = ngram_propose(req._history, self.ecfg.spec_ngram, k) if req is not None else []
            proposals.append(list(prop))
            chunk[slot, 0] = toks_host[slot]
            chunk[slot, 1 : 1 + len(prop)] = prop
        am = self._to_host(self._verify(self._upload(chunk), self.lengths))
        lengths = self.lengths_host.astype(np.int64).copy()
        new_tokens = toks_host.copy()
        self.stats["steps"] += 1
        for slot in range(B):
            req = self.slot_req[slot]
            if req is None:
                continue
            self.stats["slot_steps"] += 1
            prop = proposals[slot]
            n_acc = 0
            while n_acc < len(prop) and prop[n_acc] == int(am[slot, n_acc]):
                n_acc += 1
            self.stats["spec_proposed"] += len(prop)
            self.stats["spec_accepted"] += n_acc
            # accepted drafts verbatim + one bonus token from the target
            emitted = prop[:n_acc] + [int(am[slot, n_acc])]
            base = int(lengths[slot])
            adv = 0
            for j, t in enumerate(emitted):
                self._absorb(slot, int(t), slot_len=base + j + 1)
                adv = j + 1
                if self.slot_req[slot] is None:
                    break
            lengths[slot] = base + adv
            new_tokens[slot] = emitted[adv - 1]
        self.lengths_host = lengths.copy()
        self.lengths = self._upload(lengths)
        self.tokens_host = new_tokens.copy()
        self.tokens = self._upload(new_tokens)

    def run(self, requests: Sequence[Request]) -> List[Request]:
        """Serve requests to completion; returns the requests that finished
        during THIS call, in finish order (`finished` is cleared on entry, so
        a long-lived engine keeps no request history)."""
        self.finished = []
        for r in requests:
            self.submit(r)
        while self.queue or any(r is not None for r in self.slot_req):
            self.step()
        out = self.finished
        self.finished = []
        return out

    def decode_texts(self, requests: Sequence[Request]) -> Dict[Any, str]:
        """uid -> decoded text (stop strings trimmed) for finished requests."""
        out = {}
        for r in requests:
            text = self.tokenizer.decode(r.output_ids, skip_special_tokens=True)
            for s in r.stop_strings:
                idx = text.find(s)
                if idx >= 0:
                    text = text[:idx]
            out[r.uid] = text.strip()
        return out
