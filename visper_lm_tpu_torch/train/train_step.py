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

The memory levers of one device (JAX's): `offload_opt_state` keeps the
moments (and master weights) in host memory and streams them through the
card block by block (train/staged_update.py; `blockwise_staging=False`
plans every tensor as one block, JAX's whole-tree staging layout); `stream_grads=N` cuts the decoder blocks into N
segments (unioned with the tap boundaries) whose weight gradients leave
for the host as each segment's backward ends (models/decoder.GradStream).
Both run under sequence and pipeline parallelism too (the offload under
expert parallelism too): no parameter spec
covers 'seq' or 'pipe', so JAX's plan keeps every state tensor on the card
there (ROADMAP C32); a streamed segment is summed over the seq group before
the data group's reduce, and each pipeline stage streams the segments of
its own blocks (`stage_chunk_ranges`, ROADMAP C31), each after the last
microbatch's backward.

Data parallelism (`mesh`, in a process group: parallel/distributed.py)
runs the same step on each rank's shard of the global batch. JAX writes the
step on the global batch and lets XLA insert the collectives; here the loss
divides by the global counts (train/losses.py), the ranks' gradients are
summed by the optimizer's reduce, and the metrics are summed over the ranks,
so every rank logs the global loss. ZeRO, as JAX plans it
(parallel/sharding.plan_zero): the moments of each trainable of at least
2^16 elements are sharded over the data axis (ZeRO-1/2, always with a
mesh); `zero_params` keeps the trainables' persistent copy sharded
(ZeRO-3) and `zero_frozen` the frozen parameters' (`ShardedParams`: a
decoder block's gathered for its forward and again for its backward, the
rest for the step).

Tensor parallelism (a mesh with a 'model' axis; the model already in its
rank's form, parallel/tensor.shard_model): ZeRO runs over the data group
of tp-local tensors, the NTP loss reads the rank's vocab block
(train/losses.py), every rank of the tensor-parallel group computes the
same loss on the same rows (its data coordinate's shard), and the metrics
are summed over the data group only. `shard_teachers` keeps the frozen
teachers as JAX's `model_shard_pspec` slices over the model group
(parallel/sharding.teacher_placements), gathered for each step's teacher
forward and freed after; each rank runs the teachers on its data shard
(the same numbers on every rank of the group). Gradient streaming in a
process group reduces each segment's weight gradients over the data group
onto the rank's ZeRO slice before they leave for the host.

Sequence parallelism (a mesh with a 'seq' axis: `Decoder.seq` is set from
it) shards no parameter: every rank of a seq group reads its data
coordinate's rows, runs the splice whole and the decoder on its T/sp rows
of it, and its loss is its rows' share (train/losses.py); the PT heads
read the taps gathered over the group (`gather_rows`) and every rank
computes them whole, so each takes 1/sp of their loss. The gradients are
summed over the seq group (the optimizer's reduce) and the metrics over
the seq and data groups. Pipeline parallelism (a mesh with a 'pipe' axis;
the model already cut for the rank's stage: `init_vlm(..., pp=)`): the
stage trains its own blocks, ZeRO runs over the data group inside the
stage, and every pipe rank computes the loss on the pipeline's result:
the parameters before and after the pipeline get the same gradient on
every stage (one process's), and the blocks' only on their owner, whose
share of the global norm the optimizer adds over the pipe group. A
checkpoint gathers the stages: the files are one device's.

A MoE decoder (cfg.decoder.moe_experts > 0) adds JAX's auxiliaries to the
loss, moe_aux_weight x the load-balance loss + 1e-3 x the z-loss (per-layer
means), and reports them as `moe_lb_loss`, `moe_z_loss` and
`moe_dropped_frac`. Under data or sequence parallelism the loss has the
decoder route over the global batch (`moe_data`, the data x seq routing
group, `distributed.routing_group`; ops/moe.py), in the step's forward and
backward only: the aux values are the global batch's on every rank, and
each rank's loss and metrics take 1/(dp sp) of them, so the router's
gradient, summed over the data and seq groups, counts the aux once. Under
pipeline parallelism a MoE decoder runs the plain loop (JAX pipelines no
MoE stack): every pipe rank computes the whole loss, aux included, and the
stages sum nothing. Expert parallelism (a mesh with an 'expert' axis; the
model built for the rank's experts: `init_vlm(..., ep=)`): ZeRO runs over
the data group of the ranks that hold the same experts, a bank's share of
the norm is added over the expert group (`ZeroPlan.ep`), and
`offload_opt_state` plans the 'expert' axis as JAX's `_covers_mesh` does:
on a mesh whose only axis wider than 1 is 'expert', the banks' moments go
to the host and the dense ones stay on the card. `stream_grads` takes no
MoE decoder (JAX's streamed layout asserts against it).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from visper_lm_tpu_torch.config import VLMConfig
from visper_lm_tpu_torch.models.decoder import GradStream, stage_chunk_ranges, stream_chunk_ranges
from visper_lm_tpu_torch.models.vlm import VLM, predict_task_embeddings, tap_layer_union, vlm_forward
from visper_lm_tpu_torch.parallel import distributed
from visper_lm_tpu_torch.parallel.distributed import AxisGroup, all_reduce_scalars
from visper_lm_tpu_torch.parallel.mesh import Mesh
from visper_lm_tpu_torch.parallel.pipeline import foreign_names
from visper_lm_tpu_torch.parallel.sequence import gather_rows, sequence_parallel
from visper_lm_tpu_torch.parallel.sharding import (
    Placement,
    ShardedParams,
    ZeroPlan,
    plan_zero,
    teacher_placements,
)
from visper_lm_tpu_torch.parallel.tensor import local_param, whole_param
from visper_lm_tpu_torch.train.losses import distill_losses, ntp_loss, ntp_loss_chunked, valid_count
from visper_lm_tpu_torch.train.optimizer import AdamW, OptimizerConfig, trainable_mask
from visper_lm_tpu_torch.utils.diagnostics import span
from visper_lm_tpu_torch.utils.param import split_layer
from visper_lm_tpu_torch.train.staged_update import OffloadedAdamW

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
    dp=None,
    moe_group: Optional[AxisGroup] = None,
):
    """loss_fn(model, batch, teachers=None) -> (total, metrics), batch tensors
    on the model's device. use_kernel=False forces plain attention in the
    decoder and in the teachers' window attention. dp (data parallelism: the
    step's ZeRO plan): the batch is this rank's shard, and the loss is its
    share of the global batch's loss. moe_group (`distributed.routing_group`:
    the data x seq ranks, None for one): a MoE decoder routes over the
    global batch (passed as `moe_data`), whose aux each rank of the group
    takes its share of."""
    moe_data = moe_group if cfg.decoder.moe_experts else None

    def loss_fn(model: VLM, batch: Dict[str, torch.Tensor], teachers=None):
        b, t = batch["labels"].shape
        dec = model.decoder
        tp, seq = dec.tp, dec.seq
        # JAX's switch sees the global batch and the whole vocabulary
        chunked = uses_chunked_ce(cfg, b * (1 if dp is None else dp.size), t)
        count = None if dp is None else valid_count(batch["labels"], dp)
        out = vlm_forward(
            model, cfg, batch, use_kernel=use_kernel, compute_logits=not chunked and tp is None,
            remat=remat, remat_policy=remat_policy, moe_data=moe_data,
        )
        if chunked:
            head = dec.embed_tokens.weight if dec.lm_head is None else dec.lm_head.weight
            text_loss = ntp_loss_chunked(out["hidden"], head, batch["labels"], count=count, tp=tp,
                                         seq=seq)
        else:
            # under tp the rank's (B, T, V/tp) block, never the whole logits
            logits = out["logits"] if tp is None else dec.logits(out["hidden"], use_kernel,
                                                                  gather=False)
            text_loss = ntp_loss(logits, batch["labels"], count=count, tp=tp, seq=seq)
        metrics: Dict[str, torch.Tensor] = {"text_loss": text_loss}
        total = text_loss
        moe_aux = out.get("moe_aux")
        if moe_aux is not None:
            # JAX's Switch auxiliaries: 0.01 (moe_aux_weight) x balance + 1e-3
            # x z; the global batch's values, of which each rank of the
            # routing group takes its share (the router's gradient is summed
            # over the data and seq groups; the pipe ranks each compute the
            # whole loss and sum nothing)
            share = 1 if moe_data is None else moe_data.size
            total = total + (cfg.decoder.moe_aux_weight * moe_aux["lb_loss"]
                             + 1e-3 * moe_aux["z_loss"]) / share
            for k in ("lb_loss", "z_loss", "dropped_frac"):
                metrics[f"moe_{k}"] = moe_aux[k] / share
        if cfg.distill is not None and out["taps"]:
            targets = {
                tc.task: batch[f"{tc.task}_target"]
                for tc in cfg.distill.tasks if f"{tc.task}_target" in batch
            }
            if teacher_fn is not None:
                # frozen teachers inside the step, no gradient (before the
                # heads' span: the teachers have spans of their own)
                targets.update({k: v.detach() for k, v in teacher_fn(teachers, batch).items()})
            # under sp the heads read every row: the taps gathered over the group
            taps = tuple(gather_rows(tap, seq) for tap in out["taps"])
            with span("heads"):
                preds = predict_task_embeddings(model, cfg, taps, out["tap_layers"])
                ones = torch.ones((b,), dtype=torch.float32, device=batch["labels"].device)
                task_masks = {tc.task: batch.get(f"{tc.task}_mask", ones)
                              for tc in cfg.distill.tasks}
                dloss, dmetrics = distill_losses(
                    cfg, preds, targets, task_masks, dict(model.logit_scales.items()), dp,
                )
                if seq is not None:
                    # every seq rank computes the heads' loss whole: each takes its share
                    dloss = dloss / seq.size
                    dmetrics = {k: v / seq.size for k, v in dmetrics.items()}
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
                 accum_steps: int = 1, grad_stream: Optional[GradStream] = None,
                 zero: Optional[ZeroPlan] = None, sharded: Optional[ShardedParams] = None,
                 teacher_sharded: Optional[ShardedParams] = None):
        self.model = model
        self.zero, self.sharded = zero, sharded
        # shard_teachers: the teachers' slices over the model group
        self.teacher_sharded = teacher_sharded
        self.teacher_params = teacher_params
        self.device = next(model.parameters()).device
        self.trainable = trainable
        # every trainable's name, those other pipeline stages hold included
        self.trainable_names = [n for n, p in model.named_parameters()
                                if n in trainable or n in getattr(optimizer, "foreign", {})]
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.accum_steps = accum_steps
        self.grad_stream = grad_stream
        self.grad_sums: Dict[str, torch.Tensor] = {}
        # the gradients gradient streaming already summed over the ranks
        self.reduced: set = set()
        # the last step's metrics (what `__call__` returned)
        self.last_metrics: Dict[str, float] = {}
        # CUDA events around the last update (`update_ms`)
        self._update_events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None
        self.step = 0

    def to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        """What a checkpoint keeps besides `step`: {"params/<name>": each
        trainable, "opt/<key>": the optimizer's moments and master weights},
        whole: under ZeRO and tensor parallelism every rank's slices are
        gathered, and under pipeline parallelism each block comes from its
        stage (collective), so the files are those of a one-device run."""
        pipe = self.model.decoder.pipe
        if pipe is None:
            out = {f"params/{n}": self.full_param(n) for n in self.trainable}
            out.update({f"opt/{k}": t for k, t in self.optimizer.full_state_tensors().items()})
            return out
        from visper_lm_tpu_torch.parallel.distributed import broadcast_object

        own = self.optimizer.state_tensors()
        kinds = ["mu", "nu"] + (["master"] if self.optimizer.master is not None else [])
        out = {}
        for n in self.trainable_names:
            layer = split_layer(n)[1] if n.startswith("decoder.blocks.") else None
            src = pipe.rank if layer is None else pipe.owner(layer)
            part = None
            if src == pipe.rank:
                part = {f"params/{n}": self.full_param(n).detach().cpu()}
                part.update({f"opt/{k}/{n}": self.optimizer.full_state_tensor(
                    f"{k}/{n}", own[f"{k}/{n}"]) for k in kinds})
            if layer is not None:
                part = broadcast_object(part, src, pipe.group)
            out.update(part)
        return out

    def whole(self):
        """A context in which every parameter of the model is whole: ZeRO-3's
        sharded ones gathered (collective), nothing to do without them."""
        return self.sharded.whole() if self.sharded is not None else contextlib.nullcontext()

    def full_param(self, n: str) -> torch.Tensor:
        """Trainable n whole (gathered from its ZeRO-3 slices and its
        tensor-parallel slices: collective)."""
        t = self.trainable[n]
        if self.sharded is not None and n in self.sharded.shards:
            t = self.sharded.full(n)
        return whole_param(self.model, n, t)

    @torch.no_grad()
    def load_state_tensors(self, tensors: Dict[str, torch.Tensor], step: int) -> None:
        """Copy a `state_tensors` dict into the trainables and the optimizer
        state, and set the step (the optimizer's update count with it).
        Under ZeRO and tensor parallelism each rank takes its slices,
        whatever the (dp, tp) of the run that saved them."""
        for n, p in self.trainable.items():
            src = local_param(self.model, n, torch.as_tensor(tensors[f"params/{n}"]))
            if self.sharded is not None and n in self.sharded.shards:
                self.sharded.load_full(n, src)
            else:
                p.copy_(src)
        self.optimizer.load_state_tensors(
            {k[len("opt/"):]: v for k, v in tensors.items() if k.startswith("opt/")}, step,
        )
        self.step = int(step)

    def loss_and_grads(
        self, batch: Dict[str, Any]
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Forward and backward of one micro-batch without an update:
        (metrics as tensors, {trainable name: grad}); a trainable the loss
        does not reach gets zeros. With gradient streaming the decoder
        blocks' gradients are host tensors, and their sums of squares are
        left in `grad_sums`."""
        batch = self.to_device(batch)
        for p in self.trainable.values():
            p.grad = None
        if self.grad_stream is not None:
            self.grad_stream.arm()
        with self.sharded.in_step() if self.sharded is not None else contextlib.nullcontext():
            total, metrics = self.loss_fn(self.model, batch, self.teacher_params)
            total.backward()
        streamed, self.grad_sums = self.grad_stream.collect() if self.grad_stream else ({}, {})
        # a streamed gradient is summed over the ranks already (its ZeRO slice)
        self.reduced = set(streamed) if self.zero is not None else set()
        grads = {
            n: streamed[n] if n in streamed else p.grad if p.grad is not None else torch.zeros_like(p)
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
        if self.zero is not None:
            # each rank's metrics are its shares of the global batch's
            # (under sp its rows' shares)
            values = all_reduce_scalars(list(metrics.values()), self.zero.group)
            if self.zero.seq is not None:
                values = all_reduce_scalars(values, self.zero.seq.group)
            metrics = dict(zip(metrics, values))
        if self.device.type == "cuda":
            self._update_events = (torch.cuda.Event(enable_timing=True),
                                   torch.cuda.Event(enable_timing=True))
            self._update_events[0].record()
        metrics["grad_norm"] = self.optimizer.step(grads, self.grad_sums, self.reduced)
        if self._update_events is not None:
            self._update_events[1].record()
        self.step += 1
        self.last_metrics = {k: float(v) for k, v in metrics.items()}
        return self.last_metrics

    def update_ms(self) -> Optional[float]:
        """The last optimizer update's time on the card (ms), None off CUDA."""
        if self._update_events is None:
            return None
        self._update_events[1].synchronize()
        return self._update_events[0].elapsed_time(self._update_events[1])


def check_step_options(
    device: torch.device, *, accum_steps: int = 1, offload_opt_state: bool = False,
    blockwise_staging: bool = True, stream_grads: int = 0,
) -> None:
    """The rules on the step's options, in one place (JAX make_train_step's
    asserts)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, not {accum_steps}")
    if stream_grads < 0:
        raise ValueError(f"stream_grads must be >= 0, not {stream_grads}")
    if stream_grads and accum_steps > 1:
        raise ValueError("gradient streaming composes with single-microbatch steps only "
                         "(the f32 accumulator would re-materialize the full grad tree)")
    if stream_grads and device.type == "cuda" and not (offload_opt_state and blockwise_staging):
        raise ValueError(
            "--stream-grads on CUDA requires offload_opt_state=True and blockwise_staging=True: "
            "the streamed dW lands in pinned host memory and only the blockwise staged update "
            "can stage it back")


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
    blockwise_staging: bool = True,
    block_bytes: int = 256 << 20,
    scan_chunks: bool = False,
    stream_grads: int = 0,
    donate_params: bool = True,
    mesh: Optional[Mesh] = None,
    zero_min_size: int = 2 ** 16,
    use_kernel: Optional[bool] = None,
) -> TrainStep:
    """The single-device step: `step(batch) -> metrics`. The model's
    trainable parameters (by the stage's policy) are updated in place (JAX's
    donate_params=True; the port has no copying path, so False raises);
    every other parameter, and the teachers, are frozen
    (`requires_grad_(False)`). remat / remat_policy as JAX `make_loss_fn`
    (every block rematerialised by default); accum_steps > 1 takes batches
    with a leading micro-batch axis. offload_opt_state: `OffloadedAdamW`
    (blockwise_staging, block_bytes, scan_chunks: its layout);
    stream_grads=N: a `GradStream` over `stream_chunk_ranges(layers, N,
    taps)` (under a pipeline the stage's share of them). mesh (in a
    process group, `init_distributed`): data parallelism over its data
    axis with ZeRO-1/2 moments, and with
    zero_params / zero_frozen ZeRO-3 (leaves of at least zero_min_size
    elements); a 'model' axis wider than 1 needs the model in that rank's
    tensor-parallel form (`init_vlm(..., tp=)`), and shard_teachers then
    splits the teachers over it. A 'seq' axis sets the decoder's
    sequence-parallel group (`Decoder.seq`); a 'pipe' axis needs the model
    cut for the rank's stage (`init_vlm(..., pp=)`); an 'expert' axis a
    MoE model built for the rank's experts (`init_vlm(..., ep=)`).
    use_kernel (JAX's use_pallas): False runs the decoder's attention on
    the plain path. `check_step_options` holds the rules."""
    if not donate_params:
        raise ValueError("make_train_step updates the parameters in place: "
                         "donate_params=False has no counterpart in the port")
    device = next(model.parameters()).device
    check_step_options(device, accum_steps=accum_steps, offload_opt_state=offload_opt_state,
                       blockwise_staging=blockwise_staging, stream_grads=stream_grads)
    if stream_grads and cfg.decoder.moe_experts:
        raise ValueError("blocks_chunks is a training-only layout (no cache/MoE): stream_grads "
                         "takes no MoE decoder (JAX asserts it on the streamed layout)")
    mask = trainable_mask(model.named_parameters(), opt_cfg.stage)
    # the blocks another pipeline stage owns: planned, never held or trained here
    foreign = set(foreign_names(model))
    trainable = {n: p for n, p in model.named_parameters() if mask[n] and n not in foreign}
    for n, p in model.named_parameters():
        p.requires_grad_(mask[n] and n not in foreign)
    if teacher_params is not None:
        teacher_params.requires_grad_(False)
    if model.decoder.zero3 is not None:
        raise ValueError("make_train_step: the model's parameters are already ZeRO-3 sharded")
    zero = sharded = teacher_sharded = routing = None
    tp, pipe, ep = model.decoder.tp, model.decoder.pipe, model.decoder.ep
    if mesh is not None:
        if not distributed.is_initialized():
            raise ValueError("make_train_step: a mesh needs the process group (init_distributed)")
        if mesh.model_size != (1 if tp is None else tp.size):
            raise ValueError(
                f"make_train_step: the mesh's model axis is {mesh.model_size} wide, the model is "
                f"cut for tp {1 if tp is None else tp.size} (parallel/tensor.shard_model, "
                "init_vlm(..., tp=))")
        if mesh.pipe_size != (1 if pipe is None else pipe.size):
            raise ValueError(
                f"make_train_step: the mesh's pipe axis is {mesh.pipe_size} wide, the model is "
                f"cut for pp {1 if pipe is None else pipe.size} (init_vlm(..., pp=))")
        if mesh.expert_size != (1 if ep is None else ep.size):
            raise ValueError(
                f"make_train_step: the mesh's expert axis is {mesh.expert_size} wide, the model "
                f"is built for ep {1 if ep is None else ep.size} (init_vlm(..., ep=))")
        seq = sequence_parallel(mesh)
        routing = distributed.routing_group(mesh) if cfg.decoder.moe_experts else None
        model.decoder.seq = seq
        group, rank, size = distributed.data_group(mesh)
        named = dict(model.named_parameters())
        moments, placed, _, _ = plan_zero(named, mask, size, zero_params=zero_params,
                                          zero_frozen=zero_frozen, zero_min_size=zero_min_size,
                                          model_size=mesh.model_size,
                                          expert_size=mesh.expert_size)
        zero = ZeroPlan(group, rank, size, {n: pl for n, pl in moments.items() if n not in foreign},
                        {n: pl for n, pl in placed.items() if n not in foreign}, tp=tp, seq=seq,
                        pipe=pipe, ep=ep)
        if any(pl.sharded for pl in zero.params.values()):
            sharded = ShardedParams({n: p for n, p in named.items() if n not in foreign},
                                    zero.params, group, rank)
            model.decoder.zero3 = sharded
    elif tp is not None or pipe is not None or ep is not None:
        raise ValueError("make_train_step: a tensor-, pipeline- or expert-parallel model needs "
                         "its mesh")
    if shard_teachers and tp is not None and teacher_params is not None:
        # JAX's model_shard_pspec slices, held like ZeRO-3's over the model group
        named_t = dict(teacher_params.named_parameters())
        plan_t = {n: Placement(dim=pl.model_dim, parts=pl.model_parts) if pl.model_sharded
                  else Placement() for n, pl in teacher_placements(teacher_params, tp.size).items()}
        teacher_sharded = ShardedParams(named_t, plan_t, tp.group, tp.rank)
        inner = teacher_fn

        def teacher_fn(teachers, batch):
            with teacher_sharded.whole():
                return inner(teachers, batch)
    params = dict(model.named_parameters())
    foreign_trained = {n: params[n] for n in foreign if mask[n]}
    if offload_opt_state:
        optimizer: AdamW = OffloadedAdamW(trainable.items(), opt_cfg, block_bytes=block_bytes,
                                          scan_chunks=scan_chunks, blockwise=blockwise_staging,
                                          zero=zero, sharded=sharded, foreign=foreign_trained)
    else:
        optimizer = AdamW(trainable.items(), opt_cfg, zero=zero, sharded=sharded,
                          foreign=foreign_trained)
    if model.decoder.grad_stream is not None:
        model.decoder.grad_stream.close()
    stream = None
    if stream_grads:
        ranges = stream_chunk_ranges(cfg.decoder.num_layers, stream_grads, tap_layer_union(cfg))
        stream = GradStream(model, stage_chunk_ranges(ranges, pipe), device, zero=zero)
    return TrainStep(
        model, teacher_params, trainable, optimizer,
        make_loss_fn(cfg, teacher_fn=teacher_fn, remat=remat, remat_policy=remat_policy,
                     use_kernel=use_kernel, dp=zero, moe_group=routing),
        accum_steps=accum_steps, grad_stream=stream, zero=zero, sharded=sharded,
        teacher_sharded=teacher_sharded,
    )
