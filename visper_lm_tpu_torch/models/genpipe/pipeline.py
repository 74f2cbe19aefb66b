"""The StableUnCLIPImg2ImgPipeline's loop: an image embedding -> pixels
(counterpart of visper_lm_tpu/models/genpipe/pipeline.py).

The reference calls `pipe(image_embeds=emb, num_inference_steps=25)` with the
scheduler swapped to DPM-Solver multistep:

  1. noise-augment the CLIP-H image embedding (the normalizer's scale ->
     DDPM add_noise at noise_level 0 -> unscale) and append the sinusoidal
     noise-level embedding;
  2. encode the empty prompt with the CLIP text encoder (classifier-free
     guidance: the unconditional text is the same, its class conditioning
     zeros);
  3. run the UNet over DPM-Solver++(2M) steps from pure noise at guidance 10,
     the two halves as one 2B batch;
  4. VAE-decode the latents to RGB.

The draws are kept apart from the arithmetic: `denoise` takes its `latents`
and `noise_image_embeddings` its `noise`, and `generate_from_embeds` draws
both from a torch.Generator seeded with `seed` unless the caller passes
them (the JAX package draws with jax.random, whose numbers torch cannot
reproduce). The scheduler runs in f32 on f32 latents whatever the
pipeline's dtype; the UNet, text encoder and VAE run in their own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from visper_lm_tpu_torch.config import dataclass_from_dict
from visper_lm_tpu_torch.device import resolve_device
from visper_lm_tpu_torch.models.genpipe.clip_text import (
    CLIPText,
    CLIPTextConfig,
    clip_text_forward,
    empty_prompt_ids,
)
from visper_lm_tpu_torch.models.genpipe.schedulers import (
    DPMConfig,
    NoiseAugConfig,
    add_noise,
    data_prediction,
    dpm_step,
    make_dpm_step_coeffs,
    make_dpm_tables,
)
from visper_lm_tpu_torch.models.genpipe.unet import (
    GroupNorm,
    UNet,
    UNetConfig,
    timestep_embedding,
    unet_forward,
)
from visper_lm_tpu_torch.models.genpipe.vae import VAEConfig, VAEDecoder, vae_decode
from visper_lm_tpu_torch.utils.param import host_array, init_weights_


@dataclasses.dataclass(frozen=True)
class GenPipeConfig:
    embed_dim: int = 1024
    text: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    dpm: DPMConfig = dataclasses.field(default_factory=DPMConfig)
    noise_aug: NoiseAugConfig = dataclasses.field(default_factory=NoiseAugConfig)
    guidance_scale: float = 10.0  # StableUnCLIPImg2ImgPipeline's default


SD21_UNCLIP = GenPipeConfig()


def tiny_genpipe_config() -> GenPipeConfig:
    """A CPU-sized pipeline of the same topology."""
    return GenPipeConfig(
        embed_dim=32,
        text=CLIPTextConfig(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                            mlp_dim=64, max_positions=8, bos_token_id=126, eos_token_id=127,
                            pad_token_id=0),
        unet=UNetConfig(block_out_channels=(16, 32), layers_per_block=1, cross_attention_dim=32,
                        attention_head_dim=(2, 2), cross_attn_levels=(True, False), norm_groups=4,
                        projection_class_embeddings_input_dim=64, sample_size=8),
        vae=VAEConfig(block_out_channels=(8, 16), norm_groups=4),
        dpm=DPMConfig(),
    )


class Normalizer(nn.Module):
    """The image normalizer's (1, embed_dim) mean and std."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.mean = nn.Parameter(torch.zeros(1, dim, device=device, dtype=dtype))
        self.std = nn.Parameter(torch.ones(1, dim, device=device, dtype=dtype))


class GenPipe(nn.Module):
    """JAX `init_genpipe`'s tree: text, unet, vae, normalizer (f32, as JAX keeps it)."""

    def __init__(self, cfg: GenPipeConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.text = CLIPText(cfg.text, **kw)
        self.unet = UNet(cfg.unet, **kw)
        self.vae = VAEDecoder(cfg.vae, **kw)
        self.normalizer = Normalizer(cfg.embed_dim, device=device, dtype=torch.float32)


def init_genpipe(cfg: GenPipeConfig, *, device=None, dtype=torch.float32, seed: int = 0) -> GenPipe:
    """A frozen GenPipe with seeded random weights on `device` (CUDA when
    None), JAX `init_genpipe`'s distributions: linear and conv kernels
    U(+-1/sqrt(fan_in)) with zero bias, the token embedding N(0, 0.02^2), the
    position embedding 0, norms 1 / 0, the normalizer mean 0 and std 1."""
    device = resolve_device(device)
    with torch.device("meta"):
        pipe = GenPipe(cfg, dtype=dtype)
    pipe = pipe.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        init_weights_(pipe, gen)
        for m in pipe.modules():
            if isinstance(m, nn.Conv2d):
                bound = m.weight[0].numel() ** -0.5
                m.weight.uniform_(-bound, bound, generator=gen)
                m.bias.zero_()
            elif isinstance(m, GroupNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
        pipe.text.position_embedding.zero_()
        pipe.normalizer.mean.zero_()
        pipe.normalizer.std.fill_(1.0)
    return pipe.requires_grad_(False).eval()


def noise_image_embeddings(pipe: GenPipe, cfg: GenPipeConfig, image_embeds: torch.Tensor,
                           noise_level: int, noise: torch.Tensor) -> torch.Tensor:
    """StableUnCLIP's noise augmentation with the given N(0, 1) `noise` (the
    embeddings' shape) -> the (B, 2 x embed_dim) class conditioning, f32."""
    mean, std = pipe.normalizer.mean.float(), pipe.normalizer.std.float()
    emb = (image_embeds.float() - mean) / std
    emb = add_noise(cfg.noise_aug, emb, noise.to(emb), noise_level)
    emb = emb * std + mean
    level = torch.full((emb.shape[0],), float(noise_level), device=emb.device)
    return torch.cat([emb, timestep_embedding(level, cfg.embed_dim)], dim=-1)


@torch.no_grad()
def denoise(pipe: GenPipe, cfg: GenPipeConfig, latents: torch.Tensor,
            class_labels: torch.Tensor, text_states: torch.Tensor,
            guidance_scale: float, num_inference_steps: int) -> torch.Tensor:
    """JAX `_denoise_fn`'s loop: each step one UNet call on the 2B batch
    [uncond | cond], guidance, the x0 prediction and the DPM-Solver++(2M)
    update in f32; then the VAE. latents (B, S, S, 4); class_labels and
    text_states (2B, ...). Returns (B, 8S, 8S, 3) in [0, 1], f32."""
    coeffs = {k: torch.from_numpy(v).to(latents.device)
              for k, v in make_dpm_step_coeffs(make_dpm_tables(cfg.dpm, num_inference_steps)).items()}
    lat = latents.float()
    x0_prev = torch.zeros_like(lat)
    for i in range(num_inference_steps):
        ci = {k: v[i] for k, v in coeffs.items()}
        out = unet_forward(pipe.unet, cfg.unet, torch.cat([lat, lat], dim=0), ci["timesteps"],
                           text_states, class_labels).float()
        out_u, out_c = out.chunk(2, dim=0)
        model_out = out_u + guidance_scale * (out_c - out_u)
        x0 = data_prediction(cfg.dpm, model_out, lat, ci["alpha"], ci["sigma"])
        lat = dpm_step(ci, lat, x0, x0_prev)
        x0_prev = x0
    return vae_decode(pipe.vae, cfg.vae, lat).float()


@torch.no_grad()
def generate_from_embeds(
    pipe: GenPipe,
    cfg: GenPipeConfig,
    image_embeds,                 # (B, embed_dim) or (B, 1, embed_dim): a head's output
    *,
    num_inference_steps: int = 25,
    guidance_scale: Optional[float] = None,
    noise_level: int = 0,
    seed: int = 0,
    latents: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """Images (B, H, W, 3) in [0, 1] from predicted CLIP-H embeddings: the
    reference's `pipe(image_embeds=emb.squeeze(1), num_inference_steps=25)`.
    The augmentation noise and the initial latents are drawn in that order
    from a torch.Generator seeded with `seed` on the pipeline's device,
    unless given."""
    p0 = next(pipe.parameters())
    dev, dtype = p0.device, p0.dtype
    emb = torch.as_tensor(np.asarray(image_embeds) if not torch.is_tensor(image_embeds)
                          else image_embeds).to(device=dev, dtype=torch.float32)
    if emb.ndim == 3:
        emb = emb.squeeze(1)
    b = emb.shape[0]
    gs = cfg.guidance_scale if guidance_scale is None else guidance_scale
    size, chans = cfg.unet.sample_size, cfg.unet.in_channels
    gen = torch.Generator(device=dev).manual_seed(seed)
    if noise is None:
        noise = torch.randn(emb.shape, generator=gen, device=dev)
    if latents is None:
        latents = torch.randn((b, size, size, chans), generator=gen, device=dev)
    latents = latents.to(device=dev, dtype=torch.float32) * make_dpm_tables(
        cfg.dpm, num_inference_steps).init_noise_sigma
    class_cond = noise_image_embeddings(pipe, cfg, emb, noise_level, noise.to(dev))
    class_labels = torch.cat([torch.zeros_like(class_cond), class_cond], dim=0).to(dtype)
    text_states = clip_text_forward(pipe.text, cfg.text, empty_prompt_ids(cfg.text, dev))
    text_states = text_states.expand(2 * b, *text_states.shape[1:])
    images = denoise(pipe, cfg, latents, class_labels, text_states, float(gs), num_inference_steps)
    return images.cpu().numpy()


# ----------------------------------------------------------------- importers
# diffusers state dicts -> the JAX package's tree layout (numpy)


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(host_array(w).T)


def _conv(sd, p: str) -> Dict[str, np.ndarray]:
    out = {"kernel": np.ascontiguousarray(host_array(sd[f"{p}.weight"]).transpose(2, 3, 1, 0))}
    if f"{p}.bias" in sd:
        out["bias"] = host_array(sd[f"{p}.bias"])
    return out


def _lin(sd, p: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _t(sd[f"{p}.weight"])}
    if f"{p}.bias" in sd:
        out["bias"] = host_array(sd[f"{p}.bias"])
    return out


def _norm(sd, p: str) -> Dict[str, np.ndarray]:
    return {"scale": host_array(sd[f"{p}.weight"]), "bias": host_array(sd[f"{p}.bias"])}


def _import_resnet(sd, p: str) -> Dict[str, Any]:
    out = {"norm1": _norm(sd, f"{p}.norm1"), "conv1": _conv(sd, f"{p}.conv1"),
           "norm2": _norm(sd, f"{p}.norm2"), "conv2": _conv(sd, f"{p}.conv2")}
    if f"{p}.time_emb_proj.weight" in sd:
        out["time_emb_proj"] = _lin(sd, f"{p}.time_emb_proj")
    if f"{p}.conv_shortcut.weight" in sd:
        out["conv_shortcut"] = _conv(sd, f"{p}.conv_shortcut")
    return out


def _import_spatial_transformer(sd, p: str) -> Dict[str, Any]:
    tb = f"{p}.transformer_blocks.0"

    def attn(name):
        return {"q": _lin(sd, f"{tb}.{name}.to_q"), "k": _lin(sd, f"{tb}.{name}.to_k"),
                "v": _lin(sd, f"{tb}.{name}.to_v"), "o": _lin(sd, f"{tb}.{name}.to_out.0")}

    return {
        "norm": _norm(sd, f"{p}.norm"),
        "proj_in": _lin(sd, f"{p}.proj_in"),
        "proj_out": _lin(sd, f"{p}.proj_out"),
        "block": {
            "norm1": _norm(sd, f"{tb}.norm1"), "attn1": attn("attn1"),
            "norm2": _norm(sd, f"{tb}.norm2"), "attn2": attn("attn2"),
            "norm3": _norm(sd, f"{tb}.norm3"),
            "ff_in": _lin(sd, f"{tb}.ff.net.0.proj"), "ff_out": _lin(sd, f"{tb}.ff.net.2"),
        },
    }


def import_unet(sd: Mapping[str, Any], cfg: UNetConfig) -> Dict[str, Any]:
    """A diffusers UNet2DConditionModel state dict -> the unet tree."""
    n = len(cfg.block_out_channels)
    down = []
    for lvl in range(n):
        blk: Dict[str, Any] = {"resnets": [], "attentions": []}
        for i in range(cfg.layers_per_block):
            blk["resnets"].append(_import_resnet(sd, f"down_blocks.{lvl}.resnets.{i}"))
            if cfg.cross_attn_levels[lvl]:
                blk["attentions"].append(
                    _import_spatial_transformer(sd, f"down_blocks.{lvl}.attentions.{i}"))
        if f"down_blocks.{lvl}.downsamplers.0.conv.weight" in sd:
            blk["downsample"] = _conv(sd, f"down_blocks.{lvl}.downsamplers.0.conv")
        down.append(blk)
    up = []
    for j in range(n):              # diffusers' up_blocks are deepest first already
        lvl = n - 1 - j
        blk = {"resnets": [], "attentions": []}
        for i in range(cfg.layers_per_block + 1):
            blk["resnets"].append(_import_resnet(sd, f"up_blocks.{j}.resnets.{i}"))
            if cfg.cross_attn_levels[lvl]:
                blk["attentions"].append(
                    _import_spatial_transformer(sd, f"up_blocks.{j}.attentions.{i}"))
        if f"up_blocks.{j}.upsamplers.0.conv.weight" in sd:
            blk["upsample"] = _conv(sd, f"up_blocks.{j}.upsamplers.0.conv")
        up.append(blk)
    return {
        "conv_in": _conv(sd, "conv_in"),
        "time_embedding": {"linear_1": _lin(sd, "time_embedding.linear_1"),
                           "linear_2": _lin(sd, "time_embedding.linear_2")},
        "class_embedding": {"linear_1": _lin(sd, "class_embedding.linear_1"),
                            "linear_2": _lin(sd, "class_embedding.linear_2")},
        "down": down,
        "mid": {"resnet1": _import_resnet(sd, "mid_block.resnets.0"),
                "attn": _import_spatial_transformer(sd, "mid_block.attentions.0"),
                "resnet2": _import_resnet(sd, "mid_block.resnets.1")},
        "up": up,
        "conv_norm_out": _norm(sd, "conv_norm_out"),
        "conv_out": _conv(sd, "conv_out"),
    }


def import_vae_decoder(sd: Mapping[str, Any], cfg: VAEConfig) -> Dict[str, Any]:
    up = []
    for j in range(len(cfg.block_out_channels)):
        blk: Dict[str, Any] = {"resnets": [
            _import_resnet(sd, f"decoder.up_blocks.{j}.resnets.{i}")
            for i in range(cfg.layers_per_block + 1)]}
        if f"decoder.up_blocks.{j}.upsamplers.0.conv.weight" in sd:
            blk["upsample"] = _conv(sd, f"decoder.up_blocks.{j}.upsamplers.0.conv")
        up.append(blk)
    a = "decoder.mid_block.attentions.0"
    return {
        "post_quant_conv": _conv(sd, "post_quant_conv"),
        "conv_in": _conv(sd, "decoder.conv_in"),
        "mid": {
            "resnet1": _import_resnet(sd, "decoder.mid_block.resnets.0"),
            "attn": {"norm": _norm(sd, f"{a}.group_norm"), "q": _lin(sd, f"{a}.to_q"),
                     "k": _lin(sd, f"{a}.to_k"), "v": _lin(sd, f"{a}.to_v"),
                     "o": _lin(sd, f"{a}.to_out.0")},
            "resnet2": _import_resnet(sd, "decoder.mid_block.resnets.1"),
        },
        "up": up,
        "conv_norm_out": _norm(sd, "decoder.conv_norm_out"),
        "conv_out": _conv(sd, "decoder.conv_out"),
    }


def import_clip_text(sd: Mapping[str, Any], cfg: CLIPTextConfig) -> Dict[str, Any]:
    """A transformers CLIPTextModel state dict -> the text tree (blocks stacked)."""
    p = "text_model"
    blocks = []
    for i in range(cfg.num_layers):
        lp = f"{p}.encoder.layers.{i}"
        blocks.append({
            "ln1": _norm(sd, f"{lp}.layer_norm1"),
            "q_proj": _lin(sd, f"{lp}.self_attn.q_proj"),
            "k_proj": _lin(sd, f"{lp}.self_attn.k_proj"),
            "v_proj": _lin(sd, f"{lp}.self_attn.v_proj"),
            "o_proj": _lin(sd, f"{lp}.self_attn.out_proj"),
            "ln2": _norm(sd, f"{lp}.layer_norm2"),
            "fc1": _lin(sd, f"{lp}.mlp.fc1"),
            "fc2": _lin(sd, f"{lp}.mlp.fc2"),
        })

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return np.stack(items)

    return {
        "token_embedding": {"embedding": host_array(sd[f"{p}.embeddings.token_embedding.weight"])},
        "position_embedding": host_array(sd[f"{p}.embeddings.position_embedding.weight"]),
        "blocks": stack(blocks),
        "final_ln": _norm(sd, f"{p}.final_layer_norm"),
    }


def import_genpipe(cfg: GenPipeConfig, *, unet_sd: Mapping[str, Any], vae_sd: Mapping[str, Any],
                   text_sd: Mapping[str, Any], normalizer_sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The pipeline's tree from the four diffusers component state dicts
    (unet/, vae/, text_encoder/, image_normalizer/ of
    stable-diffusion-2-1-unclip); `weights.genpipe_from_jax_params` loads it."""
    return {
        "text": import_clip_text(text_sd, cfg.text),
        "unet": import_unet(unet_sd, cfg.unet),
        "vae": import_vae_decoder(vae_sd, cfg.vae),
        "normalizer": {"mean": host_array(normalizer_sd["mean"]).reshape(1, -1),
                       "std": host_array(normalizer_sd["std"]).reshape(1, -1)},
    }


def genpipe_config_to_dict(cfg: GenPipeConfig) -> Dict[str, Any]:
    """The JSON form of a config (the teachers-dir bundle's genpipe.json)."""
    return dataclasses.asdict(cfg)


def genpipe_config_from_dict(d: Mapping[str, Any]) -> GenPipeConfig:
    """The inverse of genpipe_config_to_dict (JSON lists -> tuples)."""
    return GenPipeConfig(
        embed_dim=d.get("embed_dim", 1024),
        text=dataclass_from_dict(CLIPTextConfig, d.get("text", {})),
        unet=dataclass_from_dict(UNetConfig, d.get("unet", {})),
        vae=dataclass_from_dict(VAEConfig, d.get("vae", {})),
        dpm=dataclass_from_dict(DPMConfig, d.get("dpm", {})),
        noise_aug=dataclass_from_dict(NoiseAugConfig, d.get("noise_aug", {})),
        guidance_scale=d.get("guidance_scale", 10.0),
    )
