"""The unCLIP image-synthesis pipeline of SD-2.1-unclip (counterpart of
visper_lm_tpu/models/genpipe): a predicted 1 x 1024 CLIP-H image embedding ->
pixels, for the demo's gen visualisation.

  clip_text.py   the OpenCLIP-ViT-H text encoder (empty-prompt conditioning)
  unet.py        UNet2DConditionModel (class_embed_type 'projection' over
                 [image embedding | noise-level embedding])
  vae.py         the AutoencoderKL decoder (latents -> 768 x 768 RGB)
  schedulers.py  DDPM noise augmentation and DPM-Solver++(2M)
  pipeline.py    generate_from_embeds, the seeded init and the importers
"""

from visper_lm_tpu_torch.models.genpipe.pipeline import (  # noqa: F401
    SD21_UNCLIP,
    GenPipe,
    GenPipeConfig,
    denoise,
    generate_from_embeds,
    genpipe_config_from_dict,
    genpipe_config_to_dict,
    import_genpipe,
    init_genpipe,
    noise_image_embeddings,
    tiny_genpipe_config,
)
