"""Model-level constants (copied from visper_lm_tpu/constants.py).

Values must match the JAX package exactly: they are baked into tokenized
datasets and splice plans.
"""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"

# Number of system-prompt tokens preceding the image span in the PT-stage
# prompt layout, per base LLM family.
NUM_SYS_TOKENS = {
    "llama3": 38,
    "vicuna": 26,
    "phi3": 13,
}

# CLIP-ViT-L/14 @ 336px produces 24x24 = 576 patch tokens.
NUM_IMAGE_TOKENS = 576

# Token-type codes of the static-shape multimodal splice plan.
SEG_PAD = 0
SEG_TEXT = 1
SEG_IMAGE = 2
SEG_TASK = 3
