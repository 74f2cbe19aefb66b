"""Checkpoints of the train state (counterpart of visper_lm_tpu/train/checkpoint.py),
torch-native: one directory per step, written atomically.

    <directory>/<step>/state.pt      the trainables, the optimizer's moments
                                     and master weights (`TrainStep.state_tensors`)
                                     and the step, by torch.save
    <directory>/<step>/config.json   the VLMConfig (`config_to_json`, JAX's JSON)
    <directory>/<step>/data.json     the data-stream cursor {"epoch",
                                     "steps_in_epoch", "seed"}

A step is written into a hidden temporary directory beside the others and
renamed into place, so a directory named by a step is always complete; the
newest `save_total_limit` are kept (all when it is 0). A step that is already on disk is not
written again (the trainer's final save often repeats its last periodic one).

In a process group every rank calls `save` and `restore`: `save` gathers a
ZeRO-sharded state whole (`TrainStep.state_tensors`, collective) and the
coordinator alone writes the files a one-device run writes; `restore` reads
them on every rank, and each takes its slices for the data size it runs at
(JAX's multi-host Orbax save and restore).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from visper_lm_tpu_torch.config import VLMConfig, config_from_json, config_to_json
from visper_lm_tpu_torch.parallel import distributed
from visper_lm_tpu_torch.utils.param import NamedParams, jax_flat_arrays


class CheckpointManager:
    def __init__(self, directory: str, *, save_total_limit: int = 3):
        self.directory = os.path.abspath(directory)
        self.save_total_limit = save_total_limit
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def steps(self):
        """The complete checkpoints' steps, oldest first."""
        return sorted(int(d) for d in os.listdir(self.directory) if d.isdigit())

    def save(
        self,
        step: int,
        state: Any,
        cfg: Optional[VLMConfig] = None,
        data_state: Optional[dict] = None,
    ) -> None:
        """state: a `TrainStep` (anything with `state_tensors()`). data_state:
        the data-stream cursor, so that resume can fast-forward the stream
        to the first batch the run has not trained on."""
        final = self._path(step)
        distributed.barrier()           # every rank sees the coordinator's last save
        if os.path.exists(final):
            return
        tensors = {k: v.detach().cpu() for k, v in state.state_tensors().items()}
        if distributed.is_coordinator():
            tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save({"step": int(step), "tensors": tensors}, os.path.join(tmp, "state.pt"))
            if cfg is not None:
                with open(os.path.join(tmp, "config.json"), "w") as f:
                    f.write(config_to_json(cfg))
            if data_state is not None:
                with open(os.path.join(tmp, "data.json"), "w") as f:
                    json.dump(data_state, f)
            os.rename(tmp, final)
            if self.save_total_limit > 0:
                for old in self.steps()[:-self.save_total_limit]:
                    shutil.rmtree(self._path(old), ignore_errors=True)
        distributed.barrier()

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _step_or_latest(self, step: Optional[int]) -> Optional[int]:
        return self.latest_step() if step is None else step

    def restore(self, state: Any, step: Optional[int] = None) -> Any:
        """Load a checkpoint into `state` (a `TrainStep`: its trainables and
        optimizer state in place, and its step); returns it."""
        step = self._step_or_latest(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        saved = torch.load(os.path.join(self._path(step), "state.pt"), map_location="cpu",
                           weights_only=True)
        state.load_state_tensors(saved["tensors"], saved["step"])
        return state

    def restore_config(self, step: Optional[int] = None) -> Optional[VLMConfig]:
        step = self._step_or_latest(step)
        path = None if step is None else os.path.join(self._path(step), "config.json")
        if path is None or not os.path.exists(path):
            return None
        with open(path) as f:
            return config_from_json(f.read())

    def restore_data_state(self, step: Optional[int] = None) -> Optional[dict]:
        """The data-stream cursor saved with `step` (None when there is none:
        the caller restarts the stream)."""
        step = self._step_or_latest(step)
        path = None if step is None else os.path.join(self._path(step), "data.json")
        if path is None or not os.path.exists(path):
            return None
        with open(path) as f:
            return dict(json.load(f))

def save_params_numpy(path: str, params: NamedParams) -> None:
    """Flat .npz export of parameters under their JAX paths and layouts
    (host-side interchange, e.g. for eval workers); None entries are left out."""
    np.savez(path, **{k: v for k, v in jax_flat_arrays(params).items() if v is not None})
