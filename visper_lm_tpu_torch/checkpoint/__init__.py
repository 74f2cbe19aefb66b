"""HF-layout checkpoints: safetensors files and the reference's key names."""
