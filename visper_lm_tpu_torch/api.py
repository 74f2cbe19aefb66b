"""User-facing model API (counterpart of visper_lm_tpu/api.py):

    model = VisperModel.from_hf_checkpoint(dir, tokenizer=...)    # HF-layout checkpoints
    model = VisperModel.from_train_checkpoint(dir, base_vlm, tokenizer=...)
    texts = model.chat([...questions...], [images], max_new_tokens=128)
    texts = model.serve([...questions...], [images])              # continuous batching
    session = model.chat_session(image); session.ask("...")       # multi-turn, prefix-cached

Images are HWC uint8 arrays (or PIL images where PIL is installed;
data/mm_utils.py). The tokenizer is any object with the HF surface the api
uses: `tokenizer(text).input_ids`, `decode(ids, skip_special_tokens=)`,
`bos_token_id`, `eos_token_id` and, for `fixup_tokenizer`, `add_tokens`.

The model runs where its parameters are (CUDA for a user; tests pass
device="cpu"). Serving is bf16 unless the caller asks for quantization, by
the JAX package's rule (it turns int8 KV + w8a16 on by itself only on a TPU,
and the port runs on none): `kv_quant=True` for the int8 KV cache,
`weight_quant=True` for w8a16, `weight_quant="int4"` for w4a16 (the w4
kernel). Each quantized decoder is made once per (mode, calibration) and
shared by every Generator and Engine the model opens: one copy, not one per
prompt shape.

Images: "square" / "pad" preprocess at the tower's input size (shortest-edge
resize + centre crop + CLIP normalization): CLIP-L's 336, or the ConvNeXt
trunk's `cfg.convnext.image_size`, as the JAX package's training CLI sizes
ConvNeXt data (its chat uses the CLIP size whatever the tower: ROADMAP C12).
"anyres" tiles each image on its best grid of
`grid_pinpoints` (data/mm_utils.py), encodes base and tiles in one batch and
splices them by host-computed gather indices (data/anyres.py); in a batch,
tile counts are padded to the largest with zero tiles, whose rows are never
gathered, and each sample's image_newline index is moved to the padded
buffer's newline row.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from visper_lm_tpu_torch import conversation as conversation_lib
from visper_lm_tpu_torch.config import (
    CLIP_VIT_L_336,
    CONVNEXT_XXL_768,
    DecoderConfig,
    DistillConfig,
    DistillTaskConfig,
    ProjectorConfig,
    ResamplerConfig,
    VLMConfig,
    config_from_json,
    llama3_clip_vlm,
    phi3_clip_vlm,
    vicuna_clip_vlm,
    with_convnext_tower,
)
from visper_lm_tpu_torch.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_PATCH_TOKEN,
    DEFAULT_IMAGE_TOKEN,
)
from visper_lm_tpu_torch.data.anyres import anyres_index_plan
from visper_lm_tpu_torch.data.collate import build_splice_plan
from visper_lm_tpu_torch.data.mm_utils import (
    image_size,
    process_images,
    to_rgb_array,
    tokenizer_image_token,
)
from visper_lm_tpu_torch.models.decoder import quantize_decoder
from visper_lm_tpu_torch.models.vlm import VLM
from visper_lm_tpu_torch.serve.engine import Engine, EngineConfig, Request
from visper_lm_tpu_torch.serve.generate import GenerationConfig, Generator, left_pad_plans

def config_for_model_name(model_name: str, distill: Optional[bool] = None) -> VLMConfig:
    """Model-zoo dispatch by substring: 'phi' -> Phi3 family, 'vicuna' /
    'v1.5' -> Vicuna-7b, else Llama3-8b; 'dsg' / 'ola' -> distillation heads;
    'convnext' -> the ConvNeXt-XXL tower."""
    name = model_name.lower()
    if distill is None:
        distill = "dsg" in name or "ola" in name
    if "phi" in name:
        cfg = phi3_clip_vlm(distill=distill)
    elif "vicuna" in name or "v1.5" in name:
        cfg = vicuna_clip_vlm(distill=distill)
    else:
        cfg = llama3_clip_vlm(distill=distill)
    if "convnext" in name:
        cfg = with_convnext_tower(cfg)
    return cfg


def config_from_hf_json(hf: Dict[str, Any]) -> VLMConfig:
    """A VLMConfig from a reference checkpoint's self-describing config.json
    (the decoder fields, the tower, the image_{gen,seg,depth} dicts with
    1-indexed layer lists)."""
    mt = hf.get("model_type", "")
    decoder = DecoderConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf["hidden_size"] // hf["num_attention_heads"],
        mlp_dim=hf["intermediate_size"],
        rope_theta=hf.get("rope_theta", 10000.0),
        norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_seq_len=min(hf.get("max_position_embeddings", 4096), 4096),
        family="phi3" if "phi" in mt else "llama",
    )
    use_convnext = "convnext" in hf.get("mm_vision_tower", "clip").lower()
    mm_hidden = hf.get("mm_hidden_size", 3072 if use_convnext else 1024)

    tasks = []
    spec_keys = {"gen": "image_gen", "seg": "image_seg", "depth": "image_depth"}
    dims = {"gen": (1024, 1), "seg": (1536, 576), "depth": (1024, 576)}
    for task, key in spec_keys.items():
        d = hf.get(key)
        if not d:
            continue
        stem = "img" if task == "gen" else task
        layers = d.get(f"{stem}_layer_indices")
        head = ResamplerConfig(
            depth=d.get("depth", 1),
            dim_head=d.get("dim_head", 32),
            num_heads=d.get("num_heads", 4),
            num_tokens=d.get("num_tokens", dims[task][1]),
            output_dim=d.get("output_dim", dims[task][0]),
            ff_mult=d.get("ff_mult", 1),
        )
        tdim, ttok = dims[task]
        tasks.append(DistillTaskConfig(
            task=task,
            layer_indices=(tuple(int(i) - 1 for i in layers) if layers
                           else (decoder.num_layers - 1,)),
            loss_weight=float(d.get(f"{stem}_loss_weight", 0.5)),
            head=head,
            target_dim=tdim,
            target_tokens=ttok,
        ))
    distill = None
    if tasks:
        distill = DistillConfig(
            num_task_tokens=hf.get("num_task_tokens", 8),
            contrastive_loss_weight=hf.get("contrastive_loss_weight", 0.3),
            tasks=tuple(tasks),
        )

    if "phi" in mt:
        template, sys_tokens = "llava_phi_3", 13
    elif decoder.vocab_size >= 100000:
        template, sys_tokens = "llava_llama_3", 38
    else:
        template, sys_tokens = "vicuna_v1", 26

    return VLMConfig(
        decoder=decoder,
        vision=CLIP_VIT_L_336,
        projector=ProjectorConfig(input_dim=mm_hidden, output_dim=decoder.hidden_size),
        distill=distill,
        conv_template=template,
        num_sys_tokens=sys_tokens,
        image_aspect_ratio=hf.get("image_aspect_ratio", "square"),
        mm_patch_merge_type=hf.get("mm_patch_merge_type", "flat"),
        use_convnext_tower=use_convnext,
        convnext=CONVNEXT_XXL_768 if use_convnext else None,
    )


def fixup_tokenizer(tokenizer, hf_config: Dict[str, Any]):
    """Register the image patch / start / end special tokens the checkpoint
    was trained with."""
    if tokenizer is None:
        return tokenizer
    if hf_config.get("mm_use_im_patch_token", True):
        tokenizer.add_tokens([DEFAULT_IMAGE_PATCH_TOKEN], special_tokens=True)
    if hf_config.get("mm_use_im_start_end", False):
        tokenizer.add_tokens([DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN], special_tokens=True)
    return tokenizer


def _hashable(v):
    """Plain config values by content; arrays and calibration dicts by
    identity (pass the same object to share a cached Generator)."""
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(u) for u in v)
    if isinstance(v, dict):
        return tuple(sorted((k, id(u)) for k, u in v.items()))
    return id(v)


@dataclasses.dataclass
class VisperModel:
    """A VLM with its config and tokenizer (JAX `VisperModel`: `model` is the
    port's VLM where JAX holds a param tree)."""

    cfg: VLMConfig
    model: Optional[VLM]
    tokenizer: Any = None
    context_len: int = 4096
    # the anyres grids (LLaVA's image_grid_pinpoints), JAX's default
    grid_pinpoints: Any = "[[336,672],[672,336],[672,672],[1008,336],[336,1008]]"
    # serving quantization: None = auto, which is off on every device the port
    # runs on (JAX turns it on only on a TPU); per call through
    # chat(kv_quant=..., weight_quant=...)
    kv_quant: Optional[bool] = None
    weight_quant: Optional[Union[bool, str]] = None
    # per instance, not init fields: dataclasses.replace starts empty caches
    _gen_cache: "collections.OrderedDict[Any, Generator]" = dataclasses.field(
        default_factory=collections.OrderedDict, init=False, repr=False)
    _serving_models: Dict[Any, VLM] = dataclasses.field(
        default_factory=dict, init=False, repr=False)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _resolve_quant(self, kv, wq):
        auto = False                    # JAX: jax.default_backend() == "tpu"
        kv = self.kv_quant if kv is None else kv
        wq = self.weight_quant if wq is None else wq
        kv = auto if kv is None else bool(kv)
        if wq is None:
            wq = auto
        elif not isinstance(wq, str):           # keep "int4" intact
            wq = bool(wq)
        return kv, wq

    def serving_model(self, weight_quant=False, calibration=None) -> VLM:
        """The VLM a Generator or Engine serves: the model itself, or a view
        sharing its tower, projector and task tokens with a decoder quantized
        once per (mode, calibration) and kept for every later call."""
        if not weight_quant:
            return self.model
        mode = "int4" if weight_quant == "int4" else "int8"   # truthy otherwise: int8, as in JAX
        key = mode if calibration is None else (mode, id(calibration))
        if key not in self._serving_models:
            with torch.device("meta"):
                view = VLM(self.cfg)
            for name, child in self.model.named_children():
                setattr(view, name, child)
            view.image_newline = self.model.image_newline
            view.decoder = quantize_decoder(
                self.model.decoder, mode, act_rms=calibration if mode == "int4" else None)
            self._serving_models[key] = view.eval()
        return self._serving_models[key]

    def _generator(self, gen_cfg: GenerationConfig, batch_size: int, pad_to: int) -> Generator:
        """Generators cached by (shapes, config), at most 8, least recently
        used first out; all share the one quantized decoder per mode."""
        key = (batch_size, pad_to,
               tuple(_hashable(getattr(gen_cfg, f.name)) for f in dataclasses.fields(gen_cfg)))
        gen = self._gen_cache.pop(key, None)
        if gen is None:
            model = self.serving_model(gen_cfg.weight_quant, gen_cfg.calibration)
            # the model's decoder is already quantized: the Generator must not quantize again
            gen = Generator(model, self.cfg, dataclasses.replace(gen_cfg, weight_quant=False),
                            batch_size, pad_to, device=self.device)
        self._gen_cache[key] = gen
        while len(self._gen_cache) > 8:
            self._gen_cache.popitem(last=False)
        return gen

    # ------------------------------------------------------------------ load
    @classmethod
    def from_hf_checkpoint(
        cls, model_dir: str, tokenizer=None, model_name: Optional[str] = None,
        dtype: Optional[torch.dtype] = torch.bfloat16,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "VisperModel":
        """An HF-layout checkpoint directory (model.safetensors or an index
        and its shards, config.json). The config comes from the "visper_config"
        the port's and the JAX package's exporters write, else from the HF
        fields, else from the directory's name. Weights go to `device` (CUDA
        when None) in `dtype` (None keeps the file's)."""
        from visper_lm_tpu_torch.checkpoint.hf_import import (
            import_vlm,
            load_sharded_safetensors,
            to_model,
        )

        model_name = model_name or os.path.basename(os.path.normpath(model_dir))
        cfg_json = os.path.join(model_dir, "config.json")
        hf_cfg: Dict[str, Any] = {}
        if os.path.exists(cfg_json):
            with open(cfg_json) as f:
                hf_cfg = json.load(f)
        if hf_cfg.get("visper_config"):
            cfg = config_from_json(json.dumps(hf_cfg["visper_config"]))
        elif hf_cfg.get("hidden_size"):
            cfg = config_from_hf_json(hf_cfg)
        else:
            cfg = config_for_model_name(model_name)
        model = to_model(import_vlm(load_sharded_safetensors(model_dir), cfg), cfg,
                         device=device, dtype=dtype)
        return cls(cfg=cfg, model=model, tokenizer=fixup_tokenizer(tokenizer, hf_cfg),
                   context_len=int(hf_cfg.get("max_sequence_length", 4096)))

    @classmethod
    def from_train_checkpoint(
        cls, ckpt_dir: str, base: VLM, tokenizer=None, step: Optional[int] = None,
    ) -> "VisperModel":
        """The port's training checkpoints (train/checkpoint.CheckpointManager)
        hold the trainables only: they are copied into `base` (the VLM the
        run started from, e.g. `from_hf_checkpoint(...).model`) in place."""
        from visper_lm_tpu_torch.train.checkpoint import CheckpointManager

        mgr = CheckpointManager(ckpt_dir)
        cfg = mgr.restore_config(step)
        if cfg is None:
            raise ValueError(f"{ckpt_dir} has no config.json to build the model from")
        params = dict(base.named_parameters())

        class _Trainables:
            @torch.no_grad()
            def load_state_tensors(self, tensors, _step):
                for key, t in tensors.items():
                    if key.startswith("params/"):
                        params[key[len("params/"):]].copy_(t)

        mgr.restore(_Trainables(), step)
        return cls(cfg=cfg, model=base, tokenizer=tokenizer)

    # ---------------------------------------------------------------- prompts
    def build_prompt(self, question: str, with_image: bool = True) -> str:
        conv = conversation_lib.conv_templates[self.cfg.conv_template].copy()
        if with_image and DEFAULT_IMAGE_TOKEN not in question:
            question = DEFAULT_IMAGE_TOKEN + "\n" + question
        conv.append_message(conv.roles[0], question)
        conv.append_message(conv.roles[1], None)
        return conv.get_prompt()

    def _plans(self, prompts: Sequence[str], max_len: int,
               feature_indices: Optional[Sequence[np.ndarray]] = None):
        """Splice plans of the prompts; feature_indices gives each image's
        gather indices (anyres) in place of the sequential layout."""
        d = self.cfg.distill
        feature_indices = feature_indices or [None] * len(prompts)
        return [
            build_splice_plan(
                tokenizer_image_token(p, self.tokenizer), None, max_len,
                num_image_tokens=self.cfg.num_image_tokens,
                num_task_tokens=d.num_task_tokens if d else 0,
                num_tasks=len(d.task_order()) if d else 0,
                image_feature_indices=None if idx is None else [idx],
            )
            for p, idx in zip(prompts, feature_indices)
        ]

    def stop_strings(self) -> List[str]:
        conv = conversation_lib.conv_templates[self.cfg.conv_template]
        if conv.sep_style == conversation_lib.SeparatorStyle.TWO:
            return [conv.sep2]
        return [conv.sep]

    def _eos_ids(self) -> List[int]:
        """Stop strings that are one token, and the tokenizer's eos (stops
        checked on every sampled token)."""
        eos_ids = []
        bos = getattr(self.tokenizer, "bos_token_id", None)
        for s in self.stop_strings():
            ids = [i for i in self.tokenizer(s).input_ids if i != bos]
            if len(ids) == 1:
                eos_ids.append(ids[0])
        if getattr(self.tokenizer, "eos_token_id", None) is not None:
            eos_ids.append(self.tokenizer.eos_token_id)
        return eos_ids

    # ---------------------------------------------------------------- images
    def tower_geometry(self) -> Tuple[int, int]:
        """(the tower's input side in pixels, its feature grid's side):
        CLIP-L 336 / 24, the ConvNeXt-XXL trunk 768 / 24. Images are
        preprocessed at the first (JAX's chat takes CLIP's whatever the
        tower: ROADMAP C12)."""
        if self.cfg.use_convnext_tower:
            return self.cfg.convnext.image_size, self.cfg.convnext.image_size // 32
        return self.cfg.vision.image_size, self.cfg.vision.num_patches_per_side

    def _anyres(self) -> bool:
        return self.cfg.image_aspect_ratio == "anyres" and bool(self.grid_pinpoints)

    def _pixels(self, images: Sequence[Any]) -> np.ndarray:
        """(B, S, S, 3) f32 pixels at the tower's size; an anyres config's
        images are squared (a ChatSession's, as JAX's)."""
        aspect = self.cfg.image_aspect_ratio
        if aspect == "anyres":
            aspect = "square"
        return np.asarray(
            process_images(list(images), image_aspect_ratio=aspect,
                           image_size=self.tower_geometry()[0]),
            dtype=np.float32,
        )

    def anyres_inputs(self, images: Sequence[Any]) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Each image's tiles (1 + n_tiles, S, S, 3), base first, and its
        gather indices into its own feature buffer (the newline row at
        (1 + n_tiles) x per_tile)."""
        size, side = self.tower_geometry()
        tiles = process_images(list(images), image_aspect_ratio="anyres", image_size=size,
                               grid_pinpoints=self.grid_pinpoints)
        indices = [
            anyres_index_plan(image_size(to_rgb_array(im)), self.grid_pinpoints, tile_size=size,
                              patch_side=side, merge_type=self.cfg.mm_patch_merge_type)[0]
            for im in images
        ]
        return [np.asarray(t, dtype=np.float32) for t in tiles], indices

    def chat_batch(self, questions: Sequence[str], images: Sequence[Any]) -> Dict[str, np.ndarray]:
        """chat()'s Generator batch: the templated prompts left-padded to the
        next multiple of 128 that holds the longest (image and task tokens
        spliced in), and the preprocessed images. anyres: the tiles padded
        to the batch's most with zero tiles, (B, max_tiles, S, S, 3), each
        sample's newline index moved to max_tiles x per_tile."""
        d = self.cfg.distill
        prompts = [self.build_prompt(q) for q in questions]
        indices = None
        n_image = self.cfg.num_image_tokens
        if self._anyres():
            tiles, own = self.anyres_inputs(images)
            max_tiles = max(t.shape[0] for t in tiles)
            per_tile = self.tower_geometry()[1] ** 2
            pixels = np.zeros((len(tiles), max_tiles) + tiles[0].shape[1:], np.float32)
            indices = []
            for i, (t, idx) in enumerate(zip(tiles, own)):
                pixels[i, : t.shape[0]] = t
                indices.append(np.where(idx == t.shape[0] * per_tile, max_tiles * per_tile, idx))
            n_image = max(len(idx) for idx in indices)
        else:
            pixels = self._pixels(images)
        spliced = max(len(tokenizer_image_token(p, self.tokenizer)) for p in prompts) + (
            n_image + (d.num_task_tokens * len(d.task_order()) if d else 0))
        pad_to = min(-(-spliced // 128) * 128, self.context_len)
        batch = left_pad_plans(self._plans(prompts, pad_to, indices), pad_to)
        batch["images"] = pixels
        return batch

    def requests(self, questions: Sequence[str], images: Sequence[Any],
                 max_new_tokens: int = 128) -> List[Request]:
        """serve()'s engine requests, uid = the question's index; an anyres
        request carries its own tiles (1, 1 + n_tiles, S, S, 3)."""
        if self._anyres():
            tiles, indices = self.anyres_inputs(images)
            pixels = [t[None] for t in tiles]
        else:
            pixels, indices = [self._pixels([im]) for im in images], None
        plans = self._plans([self.build_prompt(q) for q in questions], self.context_len, indices)
        stops, eos_ids = tuple(self.stop_strings()), tuple(self._eos_ids())
        return [
            Request(plan=plan, images=px, max_new_tokens=max_new_tokens,
                    eos_token_ids=eos_ids, stop_strings=stops, uid=i)
            for i, (plan, px) in enumerate(zip(plans, pixels))
        ]

    # --------------------------------------------------------------- generate
    def chat(
        self,
        questions: Sequence[str],
        images: Sequence[Any],
        *,
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        stream_callback: Optional[Any] = None,
        kv_quant: Optional[bool] = None,
        weight_quant: Optional[Union[bool, str]] = None,
    ) -> List[str]:
        """Batched VQA: prompts from the template, images preprocessed, one
        Generator (prefill + chunked decode) over the batch.

        stream_callback(text_delta) streams sample 0's text as it decodes
        (deltas per decode chunk); the full strings are still returned."""
        batch = self.chat_batch(questions, images)
        pad_to = batch["text_ids"].shape[1]
        eos_ids = self._eos_ids()
        kvq, wq = self._resolve_quant(kv_quant, weight_quant)
        gen_cfg = GenerationConfig(
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            eos_token_ids=tuple(eos_ids),
            stop_strings=tuple(self.stop_strings()),
            kv_quant=kvq,
            weight_quant=wq,
        )
        streamer = None
        if stream_callback is not None:
            # smaller decode chunks: lower first-token and update latency
            gen_cfg = dataclasses.replace(gen_cfg, decode_chunk=4)
            streamer = _ChunkStreamer(self.tokenizer, set(eos_ids), gen_cfg.stop_strings,
                                      stream_callback)
        gen = self._generator(gen_cfg, len(questions), pad_to)
        out = gen.generate(batch, tokenizer=self.tokenizer, streamer=streamer)
        if gen_cfg.stop_strings:
            return [t.strip() for t in out]
        return [self.tokenizer.decode(x, skip_special_tokens=True).strip() for x in out]

    def serve(
        self,
        questions: Sequence[str],
        images: Sequence[Any],
        *,
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        num_slots: int = 8,
        cache_len: Optional[int] = None,
        kv_quant: Optional[bool] = None,
        weight_quant: Optional[Union[bool, str]] = None,
        decode_quantum: int = 8,
        spec_k: int = 0,
        spec_quantum: int = 4,
        admit_group: int = 8,
        admit_defer: int = 4,
    ) -> List[str]:
        """Continuous-batching VQA through serve/engine.py: answers in question
        order. A slot refills from the queue as soon as its request retires,
        so mixed-length work keeps the decode batch full; greedy answers
        equal chat()'s. decode_quantum trades first-token latency for host
        syncs; admit_group / admit_defer set grouped admission."""
        reqs = self.requests(questions, images, max_new_tokens)
        kvq, wq = self._resolve_quant(kv_quant, weight_quant)
        if cache_len is None:
            # prompts are left-padded to a 128 bucket inside the engine: the
            # cache covers the bucketed prompt and the decode budget
            bucket = -(-max(r.plan.seq_length for r in reqs) // 128) * 128
            cache_len = min(-(-(bucket + max_new_tokens + 1) // 128) * 128, self.context_len)
        engine = self.engine(EngineConfig(
            num_slots=min(num_slots, len(reqs)), max_len=cache_len, temperature=temperature,
            kv_quant=kvq,
            decode_quantum=decode_quantum,
            spec_k=spec_k if temperature == 0.0 else 0,
            spec_quantum=spec_quantum if temperature == 0.0 else 0,
            admit_group=admit_group, admit_defer=admit_defer,
        ), weight_quant=wq)
        texts = engine.decode_texts(engine.run(reqs))
        return [texts[i] for i in range(len(reqs))]

    def engine(self, ecfg: EngineConfig, weight_quant=False) -> Engine:
        """An Engine over `serving_model(weight_quant)` (the shared quantized
        decoder; ecfg.weight_quant is not used)."""
        return Engine(self.serving_model(weight_quant),
                      self.cfg, dataclasses.replace(ecfg, weight_quant=False),
                      tokenizer=self.tokenizer, device=self.device)

    def chat_session(self, image: Any = None, **kw) -> "ChatSession":
        """A multi-turn chat whose history stays in a KV prefix: each turn
        prefills only its new tokens (see ChatSession)."""
        return ChatSession(self, image, **kw)

    def get_visual_interpretations(self, question: str, image: Any) -> Dict[str, Any]:
        raise NotImplementedError(
            "visual interpretations need the teachers' decoders, which are not "
            "ported yet (ROADMAP queue A, item 10)")


class _ChunkStreamer:
    """chat()'s streamer(row, accepted): sample 0's text, emitted only as
    append-extensions of what was already sent."""

    def __init__(self, tokenizer, eos_ids, stops, callback):
        self.tokenizer, self.eos, self.stops, self.callback = tokenizer, eos_ids, stops, callback
        self.ids: List[int] = []
        self.emitted = ""
        self.done = False

    def __call__(self, row, accepted) -> None:
        if self.done or not accepted[0]:
            return
        tok = int(row[0])
        if tok in self.eos:
            self.done = True
            return
        self.ids.append(tok)
        text = self.tokenizer.decode(self.ids, skip_special_tokens=True)
        for s in self.stops:
            idx = text.find(s)
            if idx >= 0:
                text = text[:idx]
                self.done = True
        if not self.done:
            # a byte-fallback tokenizer decodes a split multi-byte character
            # as U+FFFD until its last byte arrives: hold it back
            text = text.rstrip("�")
        if len(text) > len(self.emitted) and text.startswith(self.emitted):
            self.callback(text[len(self.emitted):])
            self.emitted = text


class ChatSession:
    """Multi-turn chat with the history's KV kept in a serve.engine
    PrefixHandle: each turn prefills only its new tokens (the user message
    and the previous reply's last token), so a turn costs its own tokens,
    not the history's.

    The handle is reused only when the newly templated prompt's ids extend
    the session's cached ids (a tokenizer may merge across a boundary); on a
    mismatch the turn prefills the whole prompt, so the answer never depends
    on the tokenizer's prefix stability.

        session = model.chat_session(image)
        a1 = session.ask("What is in the image?")
        a2 = session.ask("What color is it?")        # prefills only this turn
    """

    def __init__(self, model: VisperModel, image: Any = None, *,
                 num_slots: int = 1,
                 kv_quant: Optional[bool] = None,
                 weight_quant: Optional[Union[bool, str]] = None):
        self.model = model
        self.conv = conversation_lib.conv_templates[model.cfg.conv_template].copy()
        self._pixels = None if image is None else model._pixels([image])
        kvq, wq = model._resolve_quant(kv_quant, weight_quant)
        self.engine = model.engine(
            EngineConfig(num_slots=num_slots, max_len=model.context_len, kv_quant=kvq),
            weight_quant=wq)
        self._prefix = None
        self._ids: List[int] = []
        self._turns = 0

    def _plan(self, ids: Sequence[int]):
        d = self.model.cfg.distill
        return build_splice_plan(
            list(ids), None, self.model.context_len,
            num_image_tokens=self.model.cfg.num_image_tokens,
            num_task_tokens=d.num_task_tokens if d else 0,
            num_tasks=len(d.task_order()) if d else 0,
        )

    def _fits(self, prefix_len: int, n_tokens: int, max_new_tokens: int) -> bool:
        bucket = self.engine.ecfg.prompt_bucket
        pad = -(-max(n_tokens, 1) // bucket) * bucket
        return prefix_len + pad + max_new_tokens + 1 <= self.engine.ecfg.max_len

    def ask(self, question: str, *, max_new_tokens: int = 256,
            stream_callback: Optional[Any] = None) -> str:
        model = self.model
        if self._turns == 0 and self._pixels is not None and DEFAULT_IMAGE_TOKEN not in question:
            question = DEFAULT_IMAGE_TOKEN + "\n" + question
        self.conv.append_message(self.conv.roles[0], question)
        self.conv.append_message(self.conv.roles[1], None)
        full_ids = tokenizer_image_token(self.conv.get_prompt(), model.tokenizer)

        n = len(self._ids)
        reuse = (
            self._prefix is not None
            and len(full_ids) > n
            and list(full_ids[:n]) == list(self._ids)
            and self._fits(self._prefix.length, len(full_ids) - n, max_new_tokens)
        )
        delta_ids = list(full_ids[n:]) if reuse else list(full_ids)

        stops = tuple(model.stop_strings())
        streamer = None
        if stream_callback is not None:
            streamer = _TokenStreamer(model.tokenizer, set(model._eos_ids()), stops,
                                      stream_callback)
        req = Request(
            plan=self._plan(delta_ids),
            prefix=self._prefix if reuse else None,
            images=None if reuse else self._pixels,
            max_new_tokens=max_new_tokens,
            eos_token_ids=tuple(model._eos_ids()),
            stop_strings=stops,
            stream_callback=streamer,
        )
        done = self.engine.run([req])[0]
        text = model.tokenizer.decode(done.output_ids, skip_special_tokens=True)
        for s in stops:
            idx = text.find(s)
            if idx >= 0:
                text = text[:idx]
        text = text.strip()
        self.conv.messages[-1][-1] = text

        # grow the prefix by this turn from the slot's K/V (prompt and
        # decoded tokens; no extra forward). The cache holds K/V for all but
        # the last sampled token, so the tracked ids leave it out: the next
        # turn's delta starts with it.
        base_ids = list(self._ids) if reuse else []
        handle = self.engine.harvest(done)
        if handle is not None:
            self._prefix = handle
            self._ids = base_ids + delta_ids + list(done.output_ids)[:-1]
        else:
            # the slot was refilled (not in a one-request session): prefill
            # this turn's tokens into the prefix, or drop the prefix when the
            # extension no longer fits the cache
            turn_ids = delta_ids + list(done.output_ids)
            base_len = self._prefix.length if (reuse and self._prefix) else 0
            if self._fits(base_len, len(turn_ids), max_new_tokens):
                self._prefix = self.engine.prefill_prefix(
                    self._plan(turn_ids),
                    images=None if reuse else self._pixels,
                    prefix=self._prefix if reuse else None,
                )
                self._ids = base_ids + turn_ids
            else:
                self._prefix = None
                self._ids = []
        self._turns += 1
        return text


class _TokenStreamer:
    """ChatSession's per-token streamer: the reply's text, left-stripped so
    the deltas concatenate to what ask() returns."""

    def __init__(self, tokenizer, eos_ids, stops, callback):
        self.tokenizer, self.eos, self.stops, self.callback = tokenizer, eos_ids, stops, callback
        self.ids: List[int] = []
        self.emitted = ""

    def __call__(self, tok: int) -> None:
        if tok in self.eos:
            return
        self.ids.append(tok)
        text = self.tokenizer.decode(self.ids, skip_special_tokens=True)
        for s in self.stops:
            idx = text.find(s)
            if idx >= 0:
                text = text[:idx]
        text = text.lstrip().rstrip("�")
        if len(text) > len(self.emitted) and text.startswith(self.emitted):
            self.callback(text[len(self.emitted):])
            self.emitted = text
