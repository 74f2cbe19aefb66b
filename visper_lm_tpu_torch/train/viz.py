"""Training-time visualisations (counterpart of visper_lm_tpu/train/viz.py):
the reference's wandb image logging as a trainer-side hook that runs outside
the train step on the current weights and writes PNG grids under
<output_dir>/viz/. PNGs go through the port's own writer
(`data.image_io.write_png`): the card has no PIL.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from visper_lm_tpu_torch.data.image_io import write_png


def save_image_grid(images: Sequence[np.ndarray], path: str, cols: int = 8) -> None:
    """Tile (H, W, 3) or (H, W) uint8 / float-in-[0, 1] arrays into one PNG
    on a white canvas (make_grid without the caption text)."""
    imgs = []
    for im in images:
        arr = np.asarray(im)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        imgs.append(arr)
    h = max(i.shape[0] for i in imgs)
    w = max(i.shape[1] for i in imgs)
    cols = min(cols, len(imgs))
    rows = -(-len(imgs) // cols)
    canvas = np.full((rows * h, cols * w, 3), 255, np.uint8)
    for idx, im in enumerate(imgs):
        r, c = divmod(idx, cols)
        canvas[r * h:r * h + im.shape[0], c * w:c * w + im.shape[1]] = im
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, canvas)


class DistillVizHook:
    """Depth-map grids from the current depth-head predictions, every
    `every` steps (the reference renders depth / seg every 1000 steps).

    hook(step, state, batch): state is the trainer's `TrainStep` (its
    `model`), batch a device batch (images, text_ids, token_type, src_index,
    seq_lengths; a leading micro-batch axis is cut to its first micro-batch).
    Renders `normalized_depth(dpt, [pred] * 4)` for each tapped depth layer
    into depth_l<i>_step<step>.png and returns the (layers, B, H, W) maps, or
    None when it does not render."""

    def __init__(self, cfg, output_dir: str, dpt=None, every: int = 1000):
        self.cfg = cfg
        self.dir = os.path.join(output_dir, "viz")
        self.dpt = dpt
        self.every = every

    @torch.no_grad()
    def __call__(self, step: int, state, batch: Dict[str, Any]) -> Optional[np.ndarray]:
        if self.every <= 0 or step % self.every != 0:
            return None
        if self.cfg.distill is None or self.dpt is None:
            return None
        if self.cfg.distill.get_task("depth") is None:
            return None
        from visper_lm_tpu_torch.models.teachers.dpt import normalized_depth
        from visper_lm_tpu_torch.models.vlm import predict_task_embeddings, vlm_forward

        model = state.model
        device = next(model.parameters()).device
        accum = torch.as_tensor(batch["text_ids"]).ndim == 3
        dbatch = {}
        for k in ("images", "text_ids", "token_type", "src_index", "seq_lengths"):
            if k in batch:
                v = torch.as_tensor(batch[k])
                dbatch[k] = (v[0] if accum else v).to(device)
        out = vlm_forward(model, self.cfg, dbatch, tap=True, compute_logits=False)
        preds = predict_task_embeddings(model, self.cfg, out["taps"], out["tap_layers"])
        maps = torch.stack([normalized_depth(self.dpt, [p] * 4) for p in preds["depth"]])
        maps = maps.cpu().numpy()
        for li in range(maps.shape[0]):
            save_image_grid(list(maps[li]), os.path.join(self.dir, f"depth_l{li}_step{step}.png"))
        return maps
