"""Typed configuration (a copy of visper_lm_tpu/config.py: the Phi3-mini,
Llama-3-8B and Vicuna-7B presets, the ConvNeXt and probe helpers, the JSON
functions).

Field names and defaults are the JAX package's, so `dataclasses.asdict` of a
port config equals the JAX one; tests/test_torch_models.py holds them equal.
"""

from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# DSL parsers (reference-compatible)
# ---------------------------------------------------------------------------

_LAYER_DSL_PATTERN = re.compile(r"[a-zA-Z]\d+(?:-\d+)?")
_WEIGHT_DSL_PATTERN = re.compile(r"[a-zA-Z]\d+\.\d+")


def parse_layer_indices_dsl(spec: str) -> Dict[str, List[int]]:
    """Parse e.g. "d18-20_s10-18_g12-20" -> {"depth": [17,19], "seg": [9,17], "gen": [11,19]}.

    A dash separates a LIST of 1-indexed layers (not a range); returned indices
    are 0-indexed.
    """
    out: Dict[str, List[int]] = {}
    key_map = {"d": "depth", "s": "seg", "g": "gen"}
    for match in _LAYER_DSL_PATTERN.findall(spec):
        task = key_map.get(match[0].lower())
        if task is None:
            continue
        out[task] = [int(i) - 1 for i in match[1:].split("-")]
    return out


def parse_loss_weights_dsl(spec: str) -> Dict[str, float]:
    """Parse e.g. "d0.5_s0.5_g0.5" -> {"depth": 0.5, "seg": 0.5, "gen": 0.5}."""
    out = {"depth": 0.5, "seg": 0.5, "gen": 0.5}
    key_map = {"d": "depth", "s": "seg", "g": "gen"}
    for match in _WEIGHT_DSL_PATTERN.findall(spec):
        task = key_map.get(match[0].lower())
        if task is not None:
            out[task] = float(match[1:])
    return out


# ---------------------------------------------------------------------------
# Component configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DecoderConfig:
    """A generic pre-norm decoder-only transformer (covers Llama3-8b & Phi3-mini)."""

    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    mlp_dim: int
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 4096
    tie_embeddings: bool = False
    family: str = "llama"  # "llama" | "phi3"
    dtype: str = "bfloat16"
    # Sparse MLP (ops/moe.py): 0 = dense (every reference model). When > 0 the
    # block's MLP is moe_experts SiLU experts, moe_top_k of them a token, each
    # with a static capacity of moe_capacity_factor x its even share; the
    # Switch load-balance loss enters the train loss with moe_aux_weight.
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


@dataclass(frozen=True)
class VisionConfig:
    """CLIP-style ViT vision encoder."""

    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    norm_eps: float = 1e-5
    use_class_token: bool = True
    use_pre_norm: bool = True
    use_class_embedding_bias: bool = False
    hidden_act: str = "quick_gelu"
    # Feature selection: hidden layer (negative = from the end) and drop CLS.
    select_layer: int = -2
    select_feature: str = "patch"
    dtype: str = "bfloat16"

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side ** 2


@dataclass(frozen=True)
class ProjectorConfig:
    """mm projector: 'linear' | 'mlpNx_gelu' | 'identity'."""

    projector_type: str = "mlp2x_gelu"
    input_dim: int = 1024
    output_dim: int = 4096

    @property
    def mlp_depth(self) -> int:
        m = re.match(r"^mlp(\d+)x_gelu$", self.projector_type)
        return int(m.group(1)) if m else 1


@dataclass(frozen=True)
class ResamplerConfig:
    """Perceiver resampler head hyperparams (the heads are not on the serving path)."""

    depth: int = 1
    dim_head: int = 32
    num_heads: int = 4
    num_tokens: int = 1
    output_dim: int = 1024
    ff_mult: int = 1


@dataclass(frozen=True)
class DistillTaskConfig:
    """Per-task distillation config."""

    task: str                        # "depth" | "seg" | "gen"
    layer_indices: Tuple[int, ...]   # 0-indexed block outputs to tap
    loss_weight: float
    head: ResamplerConfig
    target_dim: int
    target_tokens: int


@dataclass(frozen=True)
class DistillConfig:
    """Distillation config: task tokens, heads, tapped layers and loss weights."""

    mode: str = "gen-depth-seg"
    num_task_tokens: int = 8
    contrastive_loss_weight: float = 0.3
    use_contrastive: bool = True
    pass_text_to_aux: bool = True
    replicate_mask_zero_bug: bool = False
    tasks: Tuple[DistillTaskConfig, ...] = ()

    def task_order(self) -> List[str]:
        return self.mode.split("-")

    def get_task(self, name: str) -> Optional[DistillTaskConfig]:
        for t in self.tasks:
            if t.task == name:
                return t
        return None


@dataclass(frozen=True)
class ConvNeXtConfig:
    """OpenCLIP ConvNeXt-XXL trunk config (models/convnext.py)."""

    image_size: int = 768
    depths: Tuple[int, ...] = (3, 4, 30, 3)
    dims: Tuple[int, ...] = (384, 768, 1536, 3072)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class LoraConfig:
    """LoRA adapter config (models/lora.py): rank, alpha and the targeted
    block linears; B is scaled by alpha / r."""

    r: int = 64
    alpha: int = 16
    targets: Tuple[str, ...] = (
        "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"
    )

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


@dataclass(frozen=True)
class VLMConfig:
    """Full multimodal model config."""

    decoder: DecoderConfig
    vision: VisionConfig
    projector: ProjectorConfig
    distill: Optional[DistillConfig] = None
    conv_template: str = "llava_phi_3"
    num_sys_tokens: int = 13
    num_image_tokens: int = 576
    image_aspect_ratio: str = "square"
    mm_patch_merge_type: str = "flat"
    # the ConvNeXt tower replaces the CLIP one when set; lora: a LoraConfig
    use_convnext_tower: bool = False
    convnext: Optional[Any] = None
    lora: Optional[Any] = None

    @property
    def num_task_tokens_total(self) -> int:
        if self.distill is None or self.distill.num_task_tokens == 0:
            return 0
        return self.distill.num_task_tokens * len(self.distill.task_order())


# ---------------------------------------------------------------------------
# Factory helpers / presets
# ---------------------------------------------------------------------------


def make_distill_config(
    mode: str = "gen-depth-seg",
    layer_indices: str = "d18-20_s10-18_g12-20",
    loss_weights: str = "d0.5_s0.5_g0.5",
    num_task_tokens: int = 8,
    contrastive_loss_weight: float = 0.3,
    **overrides: Any,
) -> DistillConfig:
    """Build a DistillConfig from the reference CLI surface."""
    layers = parse_layer_indices_dsl(layer_indices)
    weights = parse_loss_weights_dsl(loss_weights)
    task_specs = {
        "gen": (ResamplerConfig(num_tokens=1, output_dim=1024), 1024, 1),
        "seg": (ResamplerConfig(num_tokens=576, output_dim=1536), 1536, 576),
        "depth": (ResamplerConfig(num_tokens=576, output_dim=1024), 1024, 576),
    }
    tasks = []
    for task in mode.split("-"):
        if task not in task_specs or task not in layers:
            continue
        head, tdim, ttok = task_specs[task]
        tasks.append(
            DistillTaskConfig(
                task=task,
                layer_indices=tuple(layers[task]),
                loss_weight=weights[task],
                head=head,
                target_dim=tdim,
                target_tokens=ttok,
            )
        )
    return DistillConfig(
        mode=mode,
        num_task_tokens=num_task_tokens,
        contrastive_loss_weight=contrastive_loss_weight,
        tasks=tuple(tasks),
        **overrides,
    )


LLAMA3_8B = DecoderConfig(
    vocab_size=128256,
    hidden_size=4096,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    mlp_dim=14336,
    rope_theta=500000.0,
    norm_eps=1e-5,
    max_seq_len=4096,
    family="llama",
)

PHI3_MINI_4K = DecoderConfig(
    vocab_size=32064,
    hidden_size=3072,
    num_layers=32,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    mlp_dim=8192,
    rope_theta=10000.0,
    norm_eps=1e-5,
    max_seq_len=4096,
    family="phi3",
)

VICUNA_7B = DecoderConfig(
    vocab_size=32000,
    hidden_size=4096,
    num_layers=32,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    mlp_dim=11008,
    rope_theta=10000.0,
    norm_eps=1e-5,
    max_seq_len=4096,
    family="llama",
)

CLIP_VIT_L_336 = VisionConfig(
    image_size=336,
    patch_size=14,
    hidden_size=1024,
    num_layers=24,
    num_heads=16,
    mlp_dim=4096,
    select_layer=-2,
    select_feature="patch",
)

# unCLIP generation teacher: CLIP-ViT-H/14 image encoder @224.
CLIP_VIT_H_224 = VisionConfig(
    image_size=224,
    patch_size=14,
    hidden_size=1280,
    num_layers=32,
    num_heads=16,
    mlp_dim=5120,
    select_layer=-1,
    select_feature="cls",
    hidden_act="gelu",
)

# DINOv2 ViT-L/14 backbone of Depth-Anything-V2.
DINOV2_VIT_L = VisionConfig(
    image_size=336,
    patch_size=14,
    hidden_size=1024,
    num_layers=24,
    num_heads=16,
    mlp_dim=4096,
    norm_eps=1e-6,
    hidden_act="gelu",
    use_pre_norm=False,
)


def phi3_clip_vlm(distill: bool = False, **kwargs: Any) -> VLMConfig:
    return VLMConfig(
        decoder=PHI3_MINI_4K,
        vision=CLIP_VIT_L_336,
        projector=ProjectorConfig(input_dim=1024, output_dim=3072),
        distill=make_distill_config() if distill else None,
        conv_template="llava_phi_3",
        num_sys_tokens=13,
        **kwargs,
    )


CONVNEXT_XXL_768 = ConvNeXtConfig()


def llama3_clip_vlm(distill: bool = False, **kwargs: Any) -> VLMConfig:
    return VLMConfig(
        decoder=LLAMA3_8B,
        vision=CLIP_VIT_L_336,
        projector=ProjectorConfig(input_dim=1024, output_dim=4096),
        distill=make_distill_config() if distill else None,
        conv_template="llava_llama_3",
        num_sys_tokens=38,
        **kwargs,
    )


def vicuna_clip_vlm(distill: bool = False, **kwargs: Any) -> VLMConfig:
    """Vicuna-7b-v1.5 + CLIP-ViT-L; the vicuna_v1 template's system prompt
    is 26 tokens."""
    return VLMConfig(
        decoder=VICUNA_7B,
        vision=CLIP_VIT_L_336,
        projector=ProjectorConfig(input_dim=1024, output_dim=4096),
        distill=make_distill_config() if distill else None,
        conv_template="vicuna_v1",
        num_sys_tokens=26,
        **kwargs,
    )


def with_convnext_tower(cfg: VLMConfig) -> VLMConfig:
    """The OpenCLIP ConvNeXt-XXL@768 tower in place of CLIP-ViT (576 tokens
    x 3072); `vision` stays CLIP-L's, as in the JAX package."""
    return dataclasses.replace(
        cfg,
        use_convnext_tower=True,
        convnext=CONVNEXT_XXL_768,
        projector=dataclasses.replace(cfg.projector, input_dim=3072),
    )


def probe_distill_config(probe_mode: str, num_layers: int, **overrides: Any) -> DistillConfig:
    """Probing: one head per LLM layer for a single task, plain smooth-L1,
    no task tokens, no contrastive loss (models/heads.py has the probe heads)."""
    specs = {
        "gen": (ResamplerConfig(num_tokens=1, output_dim=1024), 1024, 1),
        "seg": (ResamplerConfig(num_tokens=576, output_dim=1536), 1536, 576),
        "depth": (ResamplerConfig(num_tokens=576, output_dim=1024), 1024, 576),
    }
    head, tdim, ttok = specs[probe_mode]
    return DistillConfig(
        mode=probe_mode,
        num_task_tokens=0,
        use_contrastive=False,
        contrastive_loss_weight=0.0,
        tasks=(
            DistillTaskConfig(
                task=probe_mode,
                layer_indices=tuple(range(num_layers)),
                loss_weight=1.0,
                head=head,
                target_dim=tdim,
                target_tokens=ttok,
            ),
        ),
        **overrides,
    )


def tiny_test_vlm(distill: bool = False) -> VLMConfig:
    """A miniature config for CPU tests: same topology, tiny dims."""
    decoder = DecoderConfig(
        vocab_size=512,
        hidden_size=64,
        num_layers=4,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        mlp_dim=128,
        rope_theta=10000.0,
        max_seq_len=256,
        family="llama",
        dtype="float32",
    )
    vision = VisionConfig(
        image_size=28,
        patch_size=14,
        hidden_size=32,
        num_layers=2,
        num_heads=2,
        mlp_dim=64,
        select_layer=-2,
        dtype="float32",
    )
    distill_cfg = None
    if distill:
        distill_cfg = DistillConfig(
            mode="gen-depth-seg",
            num_task_tokens=2,
            contrastive_loss_weight=0.3,
            tasks=(
                DistillTaskConfig(
                    task="gen",
                    layer_indices=(1, 3),
                    loss_weight=0.5,
                    head=ResamplerConfig(num_tokens=1, output_dim=24, dim_head=8, num_heads=2),
                    target_dim=24,
                    target_tokens=1,
                ),
                DistillTaskConfig(
                    task="depth",
                    layer_indices=(3,),
                    loss_weight=0.5,
                    head=ResamplerConfig(num_tokens=4, output_dim=24, dim_head=8, num_heads=2),
                    target_dim=24,
                    target_tokens=4,
                ),
                DistillTaskConfig(
                    task="seg",
                    layer_indices=(2,),
                    loss_weight=0.5,
                    head=ResamplerConfig(num_tokens=4, output_dim=16, dim_head=8, num_heads=2),
                    target_dim=16,
                    target_tokens=4,
                ),
            ),
        )
    return VLMConfig(
        decoder=decoder,
        vision=vision,
        projector=ProjectorConfig(projector_type="mlp2x_gelu", input_dim=32, output_dim=64),
        distill=distill_cfg,
        conv_template="llava_phi_3",
        num_sys_tokens=3,
        num_image_tokens=vision.num_patches,
    )


# ---------------------------------------------------------------------------
# (De)serialization: checkpoints embed the config as JSON (JAX config.py)
# ---------------------------------------------------------------------------

_CONFIG_CLASSES = {
    c.__name__: c
    for c in (
        DecoderConfig,
        VisionConfig,
        ConvNeXtConfig,
        ProjectorConfig,
        LoraConfig,
        ResamplerConfig,
        DistillTaskConfig,
        DistillConfig,
        VLMConfig,
    )
}


def config_to_dict(cfg: Any) -> Any:
    """Nested dicts tagged with "__class__", lists for tuples (JAX's form)."""
    if dataclasses.is_dataclass(cfg):
        body = {
            f.name: config_to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)
        }
        return {"__class__": type(cfg).__name__, **body}
    if isinstance(cfg, (list, tuple)):
        return [config_to_dict(v) for v in cfg]
    return cfg


def config_from_dict(obj: Any) -> Any:
    """Inverse of `config_to_dict`: lists become tuples where the field is a Tuple."""
    if isinstance(obj, dict) and "__class__" in obj:
        cls = _CONFIG_CLASSES[obj["__class__"]]
        kwargs = {k: config_from_dict(v) for k, v in obj.items() if k != "__class__"}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for k, v in kwargs.items():
            if isinstance(v, list) and fields[k].type.startswith("Tuple"):
                kwargs[k] = tuple(v)
        return cls(**kwargs)
    if isinstance(obj, list):
        vals = [config_from_dict(v) for v in obj]
        return tuple(vals) if any(dataclasses.is_dataclass(v) for v in vals) else vals
    return obj


def dataclass_from_dict(cls, d: Dict[str, Any]) -> Any:
    """A flat config dataclass from an untagged JSON dict (`dataclasses.asdict`'s
    form): lists become tuples, unknown keys are dropped."""
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in fields})


def config_to_json(cfg: Any) -> str:
    return json.dumps(config_to_dict(cfg), indent=2)


def config_from_json(text: str) -> Any:
    return config_from_dict(json.loads(text))
