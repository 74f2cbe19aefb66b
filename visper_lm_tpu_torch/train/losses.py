"""Training losses: next-token prediction + distillation (smooth-L1 +
contrastive); counterpart of visper_lm_tpu/train/losses.py.

  * smooth-L1 (huber beta=1) elementwise, masked by the per-sample has-image
    flag, mean over ALL elements (the mask zeroes samples, the denominator
    stays full);
  * batch-contrastive with the batch's targets as negatives, exp(scale)
    clamped at 100, labels = arange(B).

Under data parallelism (`dp`: the step's ZeRO plan, with the process
group, this rank and the data size) each rank holds its shard of the global
batch, and every reduction comes out as on the global batch: NTP divides
its rank's summed NLL by the count of valid tokens summed over the ranks
(`count`), smooth-L1 and the masked means divide by the global batch's
element and sample counts, and the contrastive logits of the rank's rows
run against every rank's normalised targets (`all_gather_autograd`), the
labels offset by the rank's place in the global batch. Each rank's loss is
then its share of the global loss, and the ranks' gradients are summed.

`ntp_loss_chunked` is the shifted cross-entropy over chunks of 256
positions, each chunk's f32 logits built inside a checkpoint and rebuilt in
the backward, so the full (B, T, vocab) logits never exist (the train step
takes it where B * T * vocab >= 2^27, as the JAX step does).

Under tensor parallelism (`tp`: parallel/tensor.TensorParallel) both read
the rank's block of the vocabulary, (B, T, V/tp) logits or head rows, and
take the NLL through `vocab_parallel_nll` (Megatron's cross-entropy: two
all-reduces over the group, no gathered logits); every rank of the group
gets the same loss, over the same global count.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from visper_lm_tpu_torch import constants
from visper_lm_tpu_torch.config import VLMConfig
from visper_lm_tpu_torch.parallel.distributed import all_gather_autograd, all_reduce, copy_to_group
from visper_lm_tpu_torch.parallel.tensor import vocab_parallel_nll


def valid_count(labels: torch.Tensor, dp=None) -> torch.Tensor:
    """The supervised (shifted) tokens of the batch: over every rank's shard
    under data parallelism (an all-reduce)."""
    count = (labels[:, 1:] != constants.IGNORE_INDEX).sum()
    if dp is not None:
        count = all_reduce(count.clone(), dp.group)
    return count


def row_targets(labels: torch.Tensor, seq=None) -> torch.Tensor:
    """The target of each position the loss reads: labels[:, 1:] for the
    whole sequence, or under `seq` the labels of positions p + 1 of the
    rank's rows p (IGNORE_INDEX after the last position): (B, rows)."""
    shifted = labels[:, 1:].long()
    if seq is None:
        return shifted
    shifted = F.pad(shifted, (0, 1), value=constants.IGNORE_INDEX)
    r = seq.rows(labels.shape[1])
    return shifted[:, r]


def _nll(logits: torch.Tensor, safe: torch.Tensor, tp=None) -> torch.Tensor:
    """Per-position NLL of the f32 logits at targets `safe` (over the rank's
    vocab block under tp)."""
    if tp is not None:
        return vocab_parallel_nll(logits, safe, tp)
    logz = torch.logsumexp(logits, dim=-1)
    return logz - torch.gather(logits, -1, safe[..., None])[..., 0]


def ntp_loss(logits: torch.Tensor, labels: torch.Tensor,
             count: Optional[torch.Tensor] = None, tp=None, seq=None) -> torch.Tensor:
    """Shifted cross-entropy in f32; labels == IGNORE_INDEX are excluded (mean
    over valid; over `count` valid tokens when given: the global batch's).
    tp: the logits are the rank's (B, T, V/tp) block; seq: the logits are
    the rank's rows, the labels whole."""
    shift_logits = (logits if seq is not None else logits[:, :-1]).float()
    shift_labels = row_targets(labels, seq)
    valid = shift_labels != constants.IGNORE_INDEX
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    nll = _nll(shift_logits, safe, tp)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / (valid.sum() if count is None else count).clamp(min=1)


def _chunk_nll(h: torch.Tensor, head_weight: torch.Tensor, labels: torch.Tensor,
               tp=None) -> torch.Tensor:
    """Summed NLL of one chunk: h (B, C, D), labels (B, C); under tp the
    head's rows are the rank's vocab block, and h's gradient is summed over
    the group."""
    if tp is not None:
        h = copy_to_group(h, tp.group)
    logits = torch.matmul(h, head_weight.T).float()               # (B, C, V)
    valid = labels != constants.IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = _nll(logits, safe, tp)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum()


def ntp_loss_chunked(
    hidden: torch.Tensor,         # (B, T, D) final-normed decoder states
    head_weight: torch.Tensor,    # (V, D): lm_head.weight, or the tied embedding table
    labels: torch.Tensor,         # (B, T)
    chunk: int = 256,
    count: Optional[torch.Tensor] = None,
    tp=None,
    seq=None,
) -> torch.Tensor:
    """JAX `ntp_loss_chunked`: the shifted cross-entropy of `ntp_loss`
    without the full (B, T, V) logits. The shifted sequence is padded to a
    multiple of `chunk` with IGNORE_INDEX labels; each chunk's logits
    (h @ head_weight.T in the weight's dtype, then f32) live only inside a
    checkpoint and are rebuilt in the backward, which takes the gradient to
    hidden and, when it trains, to head_weight. tp: head_weight is the
    rank's (V/tp, D) block (the recompute repeats the chunk's collectives,
    in the same order on every rank). seq: hidden is the rank's rows, the
    labels whole."""
    shift_h = hidden if seq is not None else hidden[:, :-1]
    shift_labels = row_targets(labels, seq)
    n = shift_h.shape[1]
    pad = (-n) % chunk
    if pad:
        shift_h = F.pad(shift_h, (0, 0, 0, pad))
        shift_labels = F.pad(shift_labels, (0, pad), value=constants.IGNORE_INDEX)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, n + pad, chunk):
        h, lab = shift_h[:, c:c + chunk], shift_labels[:, c:c + chunk]
        if torch.is_grad_enabled() and (h.requires_grad or head_weight.requires_grad):
            total = total + checkpoint(_chunk_nll, h, head_weight, lab, tp,
                                       use_reentrant=False, preserve_rng_state=False)
        else:
            total = total + _chunk_nll(h, head_weight, lab, tp)
    if count is None:
        count = (shift_labels != constants.IGNORE_INDEX).sum()
    return total / count.clamp(min=1)


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
    preds: torch.Tensor, targets: torch.Tensor, logit_scale: torch.Tensor, dp=None,
) -> torch.Tensor:
    """Per-sample InfoNCE over the (global) batch -> (B,), B this rank's rows."""
    b = preds.shape[0]
    p = preds.reshape(b, -1).float()
    t = targets.reshape(b, -1).float()
    p = p / p.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    t = t / t.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    if dp is None:
        logits = (p @ t.T) * logit_scale.float().exp().clamp(max=100.0)
        return torch.logsumexp(logits, dim=-1) - torch.diagonal(logits)
    # row i of the (B_global, B_global) logits needs pred i and every target
    logits = (p @ all_gather_autograd(t, 0, dp.group).T) * logit_scale.float().exp().clamp(max=100.0)
    rows = torch.arange(b, device=logits.device)
    return torch.logsumexp(logits, dim=-1) - logits[rows, dp.rank * b + rows]


def emb_loss(
    preds: torch.Tensor,                      # (B, N, D)
    targets: torch.Tensor,                    # (B, N, D)
    mask: torch.Tensor,                       # (B,) 1.0 = real image sample
    logit_scale: Optional[torch.Tensor],
    contrastive_weight: float,
    dp=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, smooth_l1_term, contrastive_term); under `dp` this rank's
    share of each mean over the global batch."""
    mask = mask.float()
    sl1 = smooth_l1(preds.float(), targets.float())
    masked = sl1 * mask.reshape((-1,) + (1,) * (sl1.ndim - 1))
    sl1_term = masked.mean() if dp is None else masked.sum() / (masked.numel() * dp.size)
    if logit_scale is not None:
        cont = contrastive_weight * contrastive_loss(preds, targets, logit_scale, dp) * mask
        cont_term = cont.mean() if dp is None else cont.sum() / (cont.numel() * dp.size)
    else:
        cont_term = torch.zeros((), dtype=torch.float32, device=preds.device)
    return sl1_term + cont_term, sl1_term, cont_term


def distill_losses(
    cfg: VLMConfig,
    preds: Dict[str, List[torch.Tensor]],
    targets: Dict[str, torch.Tensor],          # {task: (B, N, D)}
    task_masks: Dict[str, torch.Tensor],       # {task: (B,)}
    logit_scales: Optional[Dict[str, torch.Tensor]],
    dp=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-task, per-tapped-layer embedding losses, weighted by the task's
    loss weight and summed; metrics {task}_loss / _l1_loss / _contrastive_loss
    (under `dp` this rank's shares of them)."""
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
                layer_pred, targets[task], mask, scale, d.contrastive_loss_weight, dp
            )
            task_total = task_total + loss * tcfg.loss_weight
            task_sl1 = task_sl1 + sl1_term * tcfg.loss_weight
            task_cont = task_cont + cont_term * tcfg.loss_weight
        metrics[f"{task}_loss"] = task_total
        metrics[f"{task}_l1_loss"] = task_sl1
        metrics[f"{task}_contrastive_loss"] = task_cont
        total = total + task_total
    return total, metrics
