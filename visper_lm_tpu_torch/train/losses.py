"""Training losses: next-token prediction + distillation (smooth-L1 +
contrastive); counterpart of visper_lm_tpu/train/losses.py.

  * smooth-L1 (huber beta=1) elementwise, masked by the per-sample has-image
    flag, mean over ALL elements (the mask zeroes samples, the denominator
    stays full);
  * batch-contrastive with the batch's targets as negatives, exp(scale)
    clamped at 100, labels = arange(B) (one card: the batch is global).

`ntp_loss_chunked` is the shifted cross-entropy over chunks of 256
positions, each chunk's f32 logits built inside a checkpoint and rebuilt in
the backward, so the full (B, T, vocab) logits never exist (the train step
takes it where B * T * vocab >= 2^27, as the JAX step does).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from visper_lm_tpu_torch import constants
from visper_lm_tpu_torch.config import VLMConfig


def ntp_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Shifted cross-entropy in f32; labels == IGNORE_INDEX are excluded (mean over valid)."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != constants.IGNORE_INDEX
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    logz = torch.logsumexp(shift_logits, dim=-1)
    gold = torch.gather(shift_logits, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, logz - gold, torch.zeros_like(logz))
    return nll.sum() / valid.sum().clamp(min=1)


def _chunk_nll(h: torch.Tensor, head_weight: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed NLL of one chunk: h (B, C, D), labels (B, C)."""
    logits = torch.matmul(h, head_weight.T).float()               # (B, C, V)
    valid = labels != constants.IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.where(valid, logz - gold, torch.zeros_like(logz)).sum()


def ntp_loss_chunked(
    hidden: torch.Tensor,         # (B, T, D) final-normed decoder states
    head_weight: torch.Tensor,    # (V, D): lm_head.weight, or the tied embedding table
    labels: torch.Tensor,         # (B, T)
    chunk: int = 256,
) -> torch.Tensor:
    """JAX `ntp_loss_chunked`: the shifted cross-entropy of `ntp_loss`
    without the full (B, T, V) logits. The shifted sequence is padded to a
    multiple of `chunk` with IGNORE_INDEX labels; each chunk's logits
    (h @ head_weight.T in the weight's dtype, then f32) live only inside a
    checkpoint and are rebuilt in the backward, which takes the gradient to
    hidden and, when it trains, to head_weight."""
    b, t, d = hidden.shape
    shift_h = hidden[:, :-1]
    shift_labels = labels[:, 1:].long()
    n = t - 1
    pad = (-n) % chunk
    if pad:
        shift_h = F.pad(shift_h, (0, 0, 0, pad))
        shift_labels = F.pad(shift_labels, (0, pad), value=constants.IGNORE_INDEX)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, n + pad, chunk):
        h, lab = shift_h[:, c:c + chunk], shift_labels[:, c:c + chunk]
        if torch.is_grad_enabled() and (h.requires_grad or head_weight.requires_grad):
            total = total + checkpoint(_chunk_nll, h, head_weight, lab,
                                       use_reentrant=False, preserve_rng_state=False)
        else:
            total = total + _chunk_nll(h, head_weight, lab)
    count = (shift_labels != constants.IGNORE_INDEX).sum().clamp(min=1)
    return total / count


def silog_loss(
    depth_est: torch.Tensor, depth_gt: torch.Tensor, variance_focus: float = 0.5
) -> torch.Tensor:
    """JAX `silog_loss`: scale-invariant log depth loss over depth_gt > 0 (0
    when no pixel is valid)."""
    mask = depth_gt > 0
    n = mask.sum()
    count = n.clamp(min=1)
    d = torch.where(
        mask,
        torch.log(depth_est.clamp(min=1e-12)) - torch.log(depth_gt.clamp(min=1e-12)),
        torch.zeros_like(depth_est),
    )
    mean_sq = (d * d).sum() / count
    mean = d.sum() / count
    loss = torch.sqrt((mean_sq - variance_focus * mean * mean).clamp(min=0.0))
    return torch.where(n == 0, torch.zeros_like(loss), loss)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (reduction 'none')."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def contrastive_loss(
    preds: torch.Tensor, targets: torch.Tensor, logit_scale: torch.Tensor
) -> torch.Tensor:
    """Per-sample InfoNCE over the batch -> (B,)."""
    b = preds.shape[0]
    p = preds.reshape(b, -1).float()
    t = targets.reshape(b, -1).float()
    p = p / p.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    t = t / t.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    logits = (p @ t.T) * logit_scale.float().exp().clamp(max=100.0)
    return torch.logsumexp(logits, dim=-1) - torch.diagonal(logits)


def emb_loss(
    preds: torch.Tensor,                      # (B, N, D)
    targets: torch.Tensor,                    # (B, N, D)
    mask: torch.Tensor,                       # (B,) 1.0 = real image sample
    logit_scale: Optional[torch.Tensor],
    contrastive_weight: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, smooth_l1_term, contrastive_term)."""
    mask = mask.float()
    sl1 = smooth_l1(preds.float(), targets.float())
    sl1_term = (sl1 * mask.reshape((-1,) + (1,) * (sl1.ndim - 1))).mean()
    if logit_scale is not None:
        cont = contrastive_loss(preds, targets, logit_scale)
        cont_term = (contrastive_weight * cont * mask).mean()
    else:
        cont_term = torch.zeros((), dtype=torch.float32, device=preds.device)
    return sl1_term + cont_term, sl1_term, cont_term


def distill_losses(
    cfg: VLMConfig,
    preds: Dict[str, List[torch.Tensor]],
    targets: Dict[str, torch.Tensor],          # {task: (B, N, D)}
    task_masks: Dict[str, torch.Tensor],       # {task: (B,)}
    logit_scales: Optional[Dict[str, torch.Tensor]],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-task, per-tapped-layer embedding losses, weighted by the task's
    loss weight and summed; metrics {task}_loss / _l1_loss / _contrastive_loss."""
    d = cfg.distill
    device = next(iter(targets.values())).device if targets else None
    total = torch.zeros((), dtype=torch.float32, device=device)
    metrics: Dict[str, torch.Tensor] = {}
    for tcfg in d.tasks:
        task = tcfg.task
        if task not in preds or task not in targets:
            continue
        mask = task_masks[task]
        if d.replicate_mask_zero_bug:
            mask = torch.zeros_like(mask)
        scale = None
        if logit_scales and d.use_contrastive and task in logit_scales:
            scale = logit_scales[task]
        task_total = task_sl1 = task_cont = torch.zeros((), dtype=torch.float32, device=device)
        for layer_pred in preds[task]:
            loss, sl1_term, cont_term = emb_loss(
                layer_pred, targets[task], mask, scale, d.contrastive_loss_weight
            )
            task_total = task_total + loss * tcfg.loss_weight
            task_sl1 = task_sl1 + sl1_term * tcfg.loss_weight
            task_cont = task_cont + cont_term * tcfg.loss_weight
        metrics[f"{task}_loss"] = task_total
        metrics[f"{task}_l1_loss"] = task_sl1
        metrics[f"{task}_contrastive_loss"] = task_cont
        total = total + task_total
    return total, metrics
