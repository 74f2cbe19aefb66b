"""The train step on one device (counterpart of visper_lm_tpu/train/train_step.py).

`make_loss_fn` is the JAX loss: the multimodal forward with layer taps, NTP on
the full logits, the distillation heads against teacher targets (computed in
the step by `teacher_fn`, or given in the batch as `{task}_target`), smooth-L1
+ contrastive. `make_train_step` freezes what the stage does not train
(`requires_grad_(False)`: in PT the decoder, the vision tower and the
teachers) and returns a `TrainStep` that holds the trainables and the AdamW
state: `step(batch) -> metrics` runs forward, backward and the update.

Not ported yet: remat, the chunked cross-entropy (raises where the JAX step
would take it), gradient accumulation, ZeRO / offloaded optimizer state and
stream-grads, f32 master weights.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from visper_lm_tpu_torch.config import VLMConfig
from visper_lm_tpu_torch.models.vlm import VLM, predict_task_embeddings, vlm_forward
from visper_lm_tpu_torch.train.losses import distill_losses, ntp_loss
from visper_lm_tpu_torch.train.optimizer import AdamW, OptimizerConfig, trainable_mask

TeacherFn = Callable[[nn.ModuleDict, Dict[str, Any]], Dict[str, torch.Tensor]]


def make_loss_fn(
    cfg: VLMConfig, *, teacher_fn: Optional[TeacherFn] = None, use_kernel: Optional[bool] = None,
):
    """loss_fn(model, batch, teachers=None) -> (total, metrics), batch tensors
    on the model's device. use_kernel=False forces plain attention in the
    decoder and in the teachers' window attention."""

    def loss_fn(model: VLM, batch: Dict[str, torch.Tensor], teachers=None):
        b, t = batch["labels"].shape
        if b * t * cfg.decoder.vocab_size >= 2 ** 27:
            raise NotImplementedError(
                "the chunked cross-entropy (ntp_loss_chunked) is not ported yet: "
                f"B*T*vocab = {b * t * cfg.decoder.vocab_size} >= 2**27"
            )
        out = vlm_forward(model, cfg, batch, use_kernel=use_kernel)
        text_loss = ntp_loss(out["logits"], batch["labels"])
        metrics: Dict[str, torch.Tensor] = {"text_loss": text_loss}
        total = text_loss
        if cfg.distill is not None and out["taps"]:
            preds = predict_task_embeddings(model, cfg, out["taps"], out["tap_layers"])
            targets = {
                tc.task: batch[f"{tc.task}_target"]
                for tc in cfg.distill.tasks if f"{tc.task}_target" in batch
            }
            if teacher_fn is not None:
                # frozen teachers inside the step, no gradient
                targets.update({k: v.detach() for k, v in teacher_fn(teachers, batch).items()})
            ones = torch.ones((b,), dtype=torch.float32, device=batch["labels"].device)
            task_masks = {tc.task: batch.get(f"{tc.task}_mask", ones) for tc in cfg.distill.tasks}
            dloss, dmetrics = distill_losses(
                cfg, preds, targets, task_masks, dict(model.logit_scales.items()),
            )
            total = total + dloss
            metrics.update(dmetrics)
        metrics["loss"] = total
        return total, metrics

    return loss_fn


class TrainStep:
    """One device's train state, built by `make_train_step`: the model
    (trainables updated in place), the frozen teachers, the optimizer state.
    Call it with a batch of numpy arrays or tensors; it returns the step's
    metrics as floats."""

    def __init__(self, model: VLM, teacher_params: Optional[nn.ModuleDict],
                 trainable: Dict[str, nn.Parameter], optimizer: AdamW, loss_fn):
        self.model = model
        self.teacher_params = teacher_params
        self.device = next(model.parameters()).device
        self.trainable = trainable
        self.optimizer = optimizer
        self.loss_fn = loss_fn

    def to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def loss_and_grads(
        self, batch: Dict[str, Any]
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Forward and backward without an update: (metrics as tensors,
        {trainable name: grad}); a trainable the loss does not reach gets zeros."""
        batch = self.to_device(batch)
        for p in self.trainable.values():
            p.grad = None
        total, metrics = self.loss_fn(self.model, batch, self.teacher_params)
        total.backward()
        grads = {
            n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in self.trainable.items()
        }
        for p in self.trainable.values():
            p.grad = None
        return {k: v.detach() for k, v in metrics.items()}, grads

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, float]:
        metrics, grads = self.loss_and_grads(batch)
        metrics["grad_norm"] = self.optimizer.step(grads)
        return {k: float(v) for k, v in metrics.items()}


def make_train_step(
    cfg: VLMConfig,
    opt_cfg: OptimizerConfig,
    model: VLM,
    *,
    teacher_fn: Optional[TeacherFn] = None,
    teacher_params: Optional[nn.ModuleDict] = None,
) -> TrainStep:
    """The single-device step: `step(batch) -> metrics`. The model's
    trainable parameters (by the stage's policy) are updated in place; every
    other parameter, and the teachers, are frozen (`requires_grad_(False)`)."""
    mask = trainable_mask(model.named_parameters(), opt_cfg.stage)
    trainable = {n: p for n, p in model.named_parameters() if mask[n]}
    for n, p in model.named_parameters():
        p.requires_grad_(mask[n])
    if teacher_params is not None:
        teacher_params.requires_grad_(False)
    return TrainStep(
        model, teacher_params, trainable, AdamW(trainable.items(), opt_cfg),
        make_loss_fn(cfg, teacher_fn=teacher_fn),
    )
