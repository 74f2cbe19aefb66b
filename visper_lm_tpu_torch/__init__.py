"""PyTorch/CUDA port of visper_lm_tpu for NVIDIA Hopper (H100).

The JAX package `visper_lm_tpu` is the reference this package is held against;
nothing here imports it or JAX. The first slice is batched multimodal serving:
Phi3-mini-4k + CLIP-ViT-L/14-336 prefill (through the hand-written CUDA
flash-attention forward, `ops/flash_attention.py`) and chunked greedy decode
(`serve/generate.py`).

Entry points take an explicit `device`; with none given they run on CUDA and
raise when CUDA is absent (`device.resolve_device`).
"""
