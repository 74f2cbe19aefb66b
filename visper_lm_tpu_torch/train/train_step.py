"""The train step on one device (counterpart of visper_lm_tpu/train/train_step.py).

`make_loss_fn` is the JAX loss: the multimodal forward with layer taps and,
by default, every decoder block rematerialised (`remat`, `remat_policy`:
models/decoder.py), NTP on the full logits or, where B * T * vocab >= 2^27,
the chunked cross-entropy, the distillation heads against teacher targets
(computed in the step by `teacher_fn`, or given in the batch as
`{task}_target`), smooth-L1 + contrastive. `make_train_step` freezes what the
stage does not train (`requires_grad_(False)`: in PT the decoder, the vision
tower and the teachers) and returns a `TrainStep` that holds the trainables,
the AdamW state (with f32 master weights when the optimizer config asks) and
the step count: `step(batch) -> metrics` runs forward, backward and the
update, over `accum_steps` micro-batches when that is above 1 (JAX
`make_step_fn`).

ZeRO, the offloaded optimizer state, gradient streaming, sharded teachers
and meshes of more than one device are not ported: asking for them raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from visper_lm_tpu_torch.config import VLMConfig
from visper_lm_tpu_torch.models.vlm import VLM, predict_task_embeddings, vlm_forward
from visper_lm_tpu_torch.train.losses import distill_losses, ntp_loss, ntp_loss_chunked
from visper_lm_tpu_torch.train.optimizer import AdamW, OptimizerConfig, trainable_mask

TeacherFn = Callable[[nn.ModuleDict, Dict[str, Any]], Dict[str, torch.Tensor]]


def uses_chunked_ce(cfg: VLMConfig, batch_size: int, seq_len: int) -> bool:
    """JAX's switch: the chunked cross-entropy once the (B, T, vocab) f32
    logits reach 2^27 elements."""
    return batch_size * seq_len * cfg.decoder.vocab_size >= 2 ** 27


def make_loss_fn(
    cfg: VLMConfig,
    *,
    teacher_fn: Optional[TeacherFn] = None,
    remat: bool = True,
    remat_policy: Optional[str] = None,
    use_kernel: Optional[bool] = None,
):
    """loss_fn(model, batch, teachers=None) -> (total, metrics), batch tensors
    on the model's device. use_kernel=False forces plain attention in the
    decoder and in the teachers' window attention."""

    def loss_fn(model: VLM, batch: Dict[str, torch.Tensor], teachers=None):
        b, t = batch["labels"].shape
        chunked = uses_chunked_ce(cfg, b, t)
        out = vlm_forward(
            model, cfg, batch, use_kernel=use_kernel, compute_logits=not chunked,
            remat=remat, remat_policy=remat_policy,
        )
        if chunked:
            dec = model.decoder
            head = dec.embed_tokens.weight if dec.lm_head is None else dec.lm_head.weight
            text_loss = ntp_loss_chunked(out["hidden"], head, batch["labels"])
        else:
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
    (trainables updated in place), the frozen teachers, the optimizer state
    and `step`, the number of updates taken. Call it with a batch of numpy
    arrays or tensors (with a leading micro-batch axis of `accum_steps` when
    that is above 1); it returns the step's metrics as floats."""

    def __init__(self, model: VLM, teacher_params: Optional[nn.ModuleDict],
                 trainable: Dict[str, nn.Parameter], optimizer: AdamW, loss_fn,
                 accum_steps: int = 1):
        self.model = model
        self.teacher_params = teacher_params
        self.device = next(model.parameters()).device
        self.trainable = trainable
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.accum_steps = accum_steps
        self.step = 0

    def to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        """What a checkpoint keeps besides `step`: {"params/<name>": each
        trainable, "opt/<key>": the optimizer's moments and master weights}."""
        out = {f"params/{n}": p for n, p in self.trainable.items()}
        out.update({f"opt/{k}": t for k, t in self.optimizer.state_tensors().items()})
        return out

    @torch.no_grad()
    def load_state_tensors(self, tensors: Dict[str, torch.Tensor], step: int) -> None:
        """Copy a `state_tensors` dict into the trainables and the optimizer
        state, and set the step (the optimizer's update count with it)."""
        for n, p in self.trainable.items():
            p.copy_(torch.as_tensor(tensors[f"params/{n}"]))
        self.optimizer.load_state_tensors(
            {k[len("opt/"):]: v for k, v in tensors.items() if k.startswith("opt/")}, step,
        )
        self.step = int(step)

    def loss_and_grads(
        self, batch: Dict[str, Any]
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Forward and backward of one micro-batch without an update:
        (metrics as tensors, {trainable name: grad}); a trainable the loss
        does not reach gets zeros."""
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

    def accumulated_grads(
        self, batch: Dict[str, Any]
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """JAX `accum_grads`: the micro-batches along the leading axis one
        after another, their gradients summed in f32; returns (metrics
        averaged over the micro-batches, the mean gradient in each
        parameter's dtype)."""
        gsum = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in self.trainable.items()}
        per_micro = []
        for i in range(self.accum_steps):
            metrics, grads = self.loss_and_grads({k: v[i] for k, v in batch.items()})
            for n, g in grads.items():
                gsum[n] += g.float()
            per_micro.append(metrics)
            del grads
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean(0) for k in per_micro[0]}
        grads = {
            n: (g / self.accum_steps).to(self.trainable[n].dtype) for n, g in gsum.items()
        }
        return metrics, grads

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, float]:
        if self.accum_steps > 1:
            metrics, grads = self.accumulated_grads(batch)
        else:
            metrics, grads = self.loss_and_grads(batch)
        metrics["grad_norm"] = self.optimizer.step(grads)
        self.step += 1
        return {k: float(v) for k, v in metrics.items()}


def make_train_step(
    cfg: VLMConfig,
    opt_cfg: OptimizerConfig,
    model: VLM,
    *,
    teacher_fn: Optional[TeacherFn] = None,
    teacher_params: Optional[nn.ModuleDict] = None,
    remat: bool = True,
    remat_policy: Optional[str] = None,
    accum_steps: int = 1,
    zero_params: bool = False,
    zero_frozen: bool = False,
    offload_opt_state: bool = False,
    shard_teachers: bool = False,
    stream_grads: int = 0,
) -> TrainStep:
    """The single-device step: `step(batch) -> metrics`. The model's
    trainable parameters (by the stage's policy) are updated in place; every
    other parameter, and the teachers, are frozen (`requires_grad_(False)`).
    remat / remat_policy as JAX `make_loss_fn` (every block rematerialised by
    default); accum_steps > 1 takes batches with a leading micro-batch axis.
    ZeRO (zero_params, zero_frozen), offload_opt_state, shard_teachers and
    stream_grads are multi-device or host-memory machinery the port does not
    have: they raise."""
    unported = dict(zero_params=zero_params, zero_frozen=zero_frozen,
                    offload_opt_state=offload_opt_state, shard_teachers=shard_teachers,
                    stream_grads=stream_grads)
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(f"make_train_step: {', '.join(asked)} not ported (one device)")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, not {accum_steps}")
    mask = trainable_mask(model.named_parameters(), opt_cfg.stage)
    trainable = {n: p for n, p in model.named_parameters() if mask[n]}
    for n, p in model.named_parameters():
        p.requires_grad_(mask[n])
    if teacher_params is not None:
        teacher_params.requires_grad_(False)
    return TrainStep(
        model, teacher_params, trainable, AdamW(trainable.items(), opt_cfg),
        make_loss_fn(cfg, teacher_fn=teacher_fn, remat=remat, remat_policy=remat_policy),
        accum_steps=accum_steps,
    )
