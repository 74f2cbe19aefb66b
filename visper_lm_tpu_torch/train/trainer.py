"""Training loop: data -> step -> metrics / checkpoints (counterpart of
visper_lm_tpu/train/trainer.py), on one device.

  * the step is `make_train_step`'s `TrainStep`; the loop feeds it batches,
    logs its metrics (metrics.jsonl in the output directory, and any sinks)
    and rotates checkpoints;
  * host batches reach the device through `_Prefetcher`: a thread copies
    each batch from pinned memory on a side stream while the step runs, and
    the step's stream waits for the copy's event before it reads it;
  * `grad_accum_steps` host batches are stacked into one step's micro-batch
    axis (an incomplete trailing group is dropped);
  * resume (the default): the newest checkpoint is restored and the data
    stream fast-forwarded past the batches it trained on (the iterator's
    `skip_batches` when it takes one, else `itertools.islice`);
  * SIGTERM asks for a checkpoint at the next step boundary, then the loop ends.

The device is `TrainerConfig.device`, resolved by `resolve_device` (CUDA
when None; no quiet CPU fallback) and it must hold the model. There is no
mesh: a config asking for more than one device raises, as do ZeRO, the
offloaded optimizer state, sharded teachers and gradient streaming (in
`make_train_step`).
"""

from __future__ import annotations

import dataclasses
import inspect
import itertools
import json
import os
import signal
import threading
import time
from queue import Full, Queue
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from visper_lm_tpu_torch.config import VLMConfig
from visper_lm_tpu_torch.device import resolve_device
from visper_lm_tpu_torch.train.checkpoint import CheckpointManager
from visper_lm_tpu_torch.train.optimizer import OptimizerConfig
from visper_lm_tpu_torch.train.train_step import TrainStep, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    output_dir: str
    num_epochs: int = 1
    max_steps: Optional[int] = None
    save_steps: int = 200
    save_total_limit: int = 3
    logging_steps: int = 1
    seed: int = 0
    # one device: dp / tp other than 1 raise
    dp: Optional[int] = None
    tp: int = 1
    # ZeRO / offload / sharded teachers / gradient streaming: not ported (raise)
    zero_params: bool = False
    offload_opt_state: bool = False
    zero_frozen: bool = False
    shard_teachers: bool = False
    # remat policy (models/decoder.REMAT_POLICIES): None = full per-block remat
    remat_policy: Optional[str] = None
    # gradient accumulation: N host batches per optimizer update
    grad_accum_steps: int = 1
    stream_grads: int = 0
    resume: bool = True
    # device batches copied ahead of the step
    prefetch_depth: int = 1
    # the device the model lives on (None: CUDA, or raise)
    device: Optional[str] = None


class MetricsLogger:
    def __init__(self, output_dir: str, sinks: Iterable[Callable] = ()):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self.sinks = list(sinks)

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        record = {"step": step}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                continue
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        for sink in self.sinks:
            sink(step, record)


class _Prefetcher:
    """Batches moved to `device` by a background thread, `depth` ahead.

    On CUDA each host array is pinned and copied on a side stream; the
    consumer's stream waits for the copy's event, and the tensors are
    marked as used on that stream (`record_stream`) so the allocator does
    not hand their memory back while the step reads them."""

    def __init__(self, iterator, device: torch.device, depth: int = 1):
        self.queue: Queue = Queue(maxsize=max(depth, 1))
        self.device = device
        self._done = object()
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        side = torch.cuda.Stream(device) if device.type == "cuda" else None

        def transfer(batch):
            if side is None:
                return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}, None
            with torch.cuda.stream(side):
                out = {k: torch.as_tensor(v).pin_memory().to(device, non_blocking=True)
                       for k, v in batch.items()}
                event = torch.cuda.Event()
                event.record(side)
            return out, event

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self.queue.put(item, timeout=0.1)
                    return True
                except Full:
                    continue
            return False

        def worker():
            try:
                for item in iterator:
                    if not put(transfer(item)):
                        return
            except Exception as e:          # handed to the consumer, which raises it
                self._error = e
            finally:
                put(self._done)

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()

    def __iter__(self):
        try:
            while True:
                item = self.queue.get()
                if item is self._done:
                    if self._error is not None:
                        raise self._error
                    return
                batch, event = item
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    for t in batch.values():
                        t.record_stream(stream)
                yield batch
        finally:
            self._stop.set()            # a consumer that stops early ends the thread


def _grouped(it, accum: int):
    """accum consecutive host batches stacked on a leading micro-batch axis;
    an incomplete trailing group is dropped."""
    if accum == 1:
        yield from it
        return
    group = []
    for b in it:
        group.append(b)
        if len(group) == accum:
            yield {k: np.stack([g[k] for g in group]) for k in group[0]}
            group = []


def train(
    cfg: VLMConfig,
    opt_cfg: OptimizerConfig,
    trainer_cfg: TrainerConfig,
    model,
    data_iter_fn: Callable[..., Iterable[Dict[str, np.ndarray]]],
    *,
    teacher_fn=None,
    teacher_params=None,
    log_sinks: Iterable[Callable] = (),
    step_hooks: Iterable[Callable] = (),
) -> TrainStep:
    """Run the training loop on `model` (its trainables are updated in
    place); returns the final `TrainStep`.

    data_iter_fn(epoch) yields host batches (splice plans + images +
    targets / masks, numpy); it may also take `skip_batches`."""
    if (trainer_cfg.dp or 1) != 1 or trainer_cfg.tp != 1:
        raise NotImplementedError(
            f"train: one device only (dp={trainer_cfg.dp}, tp={trainer_cfg.tp})")
    device = resolve_device(trainer_cfg.device)
    on = next(model.parameters()).device
    if on.type != device.type or (device.index is not None and on != device):
        raise ValueError(f"train: the model is on {on}, the trainer's device is {device}")
    logger = MetricsLogger(trainer_cfg.output_dir, log_sinks)
    ckpt = CheckpointManager(
        os.path.join(trainer_cfg.output_dir, "checkpoints"),
        save_total_limit=trainer_cfg.save_total_limit,
    )
    accum = max(1, trainer_cfg.grad_accum_steps)
    state = make_train_step(
        cfg, opt_cfg, model, teacher_fn=teacher_fn, teacher_params=teacher_params,
        remat_policy=trainer_cfg.remat_policy, accum_steps=accum,
        zero_params=trainer_cfg.zero_params, zero_frozen=trainer_cfg.zero_frozen,
        offload_opt_state=trainer_cfg.offload_opt_state,
        shard_teachers=trainer_cfg.shard_teachers, stream_grads=trainer_cfg.stream_grads,
    )

    # preemption: SIGTERM asks for a checkpoint at the next step boundary
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        preempted["flag"] = True

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # not the main thread
        prev_handler = None

    try:
        start_step = 0
        start_epoch, skip_in_epoch = 0, 0
        if trainer_cfg.resume and ckpt.latest_step() is not None:
            ckpt.restore(state)
            start_step = state.step
            cursor = ckpt.restore_data_state()
            if cursor is not None:
                start_epoch = int(cursor.get("epoch", 0))
                skip_in_epoch = int(cursor.get("steps_in_epoch", 0))
                saved_seed = cursor.get("seed")
                if saved_seed is not None and saved_seed != trainer_cfg.seed:
                    print(f"resume: checkpoint data seed {saved_seed} != configured seed "
                          f"{trainer_cfg.seed}; the skipped batches will not match the "
                          "original run's order")

        step = start_step
        t_last = time.perf_counter()
        epoch, epoch_step = start_epoch, skip_in_epoch

        def cursor() -> Dict[str, Any]:
            return {"epoch": epoch, "steps_in_epoch": epoch_step, "seed": trainer_cfg.seed}

        def done() -> bool:
            return bool(trainer_cfg.max_steps) and step >= trainer_cfg.max_steps

        for epoch in range(start_epoch, trainer_cfg.num_epochs):
            skip = skip_in_epoch * accum if epoch == start_epoch else 0
            if skip:
                # the stream is seeded by epoch, so its order is reproducible:
                # skip the host batches the interrupted run trained on
                try:
                    takes_skip = "skip_batches" in inspect.signature(data_iter_fn).parameters
                except (TypeError, ValueError):
                    takes_skip = False
                if takes_skip:
                    host_iter = data_iter_fn(epoch, skip_batches=skip)
                else:
                    host_iter = itertools.islice(data_iter_fn(epoch), skip, None)
                epoch_step = skip_in_epoch
            else:
                host_iter = data_iter_fn(epoch)
                epoch_step = 0

            host_iter = ({k: v for k, v in b.items() if k != "pil_images"} for b in host_iter)
            for dbatch in _Prefetcher(_grouped(host_iter, accum), device,
                                      depth=trainer_cfg.prefetch_depth):
                if done():
                    break
                metrics = state(dbatch)
                step += 1
                epoch_step += 1

                if step % trainer_cfg.logging_steps == 0:
                    now = time.perf_counter()
                    metrics = dict(metrics)
                    metrics["steps_per_sec"] = trainer_cfg.logging_steps / (now - t_last)
                    t_last = now
                    logger.log(step, metrics)

                if step % trainer_cfg.save_steps == 0:
                    ckpt.save(step, state, cfg, data_state=cursor())

                for hook in step_hooks:
                    try:
                        hook(step, state, dbatch)
                    except Exception as e:  # a hook must never end training
                        print(f"step hook failed at {step}: {e}")

                if preempted["flag"]:
                    ckpt.save(step, state, cfg, data_state=cursor())
                    break
                if done():
                    break
            if preempted["flag"] or done():
                break

        ckpt.save(step, state, cfg, data_state=cursor())
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
    return state
