"""Weight deltas and consolidation (counterpart of
visper_lm_tpu/checkpoint/delta.py; the reference's FastChat-style
apply_delta / make_delta / consolidate tools).

A delta lets a derived model be distributed as (derived - base) and applied
again on top of the base weights. Trees are flattened to {"a/b/c": array}
under the JAX package's paths: a nested dict / list tree of arrays or
tensors by its keys and indices, a module by `utils.param.jax_flat_arrays`
(its JAX paths and layouts: linear kernels (in, out), stacked blocks), so a
port model and its JAX tree give the same keys. bf16 values are widened to
f32, where the difference of two bf16 numbers and its sum with the base are
exact: a bf16 model round-trips bit for bit. Extra keys in the target (a
projector, the heads) pass through, and vocab-expanded embedding / lm_head
rows are handled as the reference does (the delta's rows cover the base rows
and the new tokens).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from visper_lm_tpu_torch.utils.param import host_array, jax_flat_arrays, widen_bf16


def flat(tree: Any) -> Dict[str, np.ndarray]:
    """{"a/b/c": numpy array} of a module or a nested dict / list tree (JAX `_flat`)."""
    if isinstance(tree, nn.Module):
        return {k: widen_bf16(v) for k, v in jax_flat_arrays(tree).items() if v is not None}
    out: Dict[str, np.ndarray] = {}

    def walk(node, parts):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, parts + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, parts + [str(i)])
        elif node is not None:
            out["/".join(parts)] = host_array(node) if torch.is_tensor(node) else np.asarray(node)

    walk(tree, [])
    return out


def make_delta(base: Any, target: Any) -> Dict[str, np.ndarray]:
    """delta = target - base where the shapes match; the target value otherwise."""
    b, t = flat(base), flat(target)
    delta = {}
    for k, tv in t.items():
        if k in b and b[k].shape == tv.shape:
            delta[k] = tv - b[k]
        elif k in b and tv.ndim == 2 and b[k].shape[1:] == tv.shape[1:]:
            # vocab-expanded rows: subtract the base from the overlapping prefix
            d = tv.copy()
            d[: b[k].shape[0]] -= b[k]
            delta[k] = d
        else:
            delta[k] = tv
    return delta


def apply_delta(base: Any, delta: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The inverse of make_delta, flat-keyed (`unflatten` rebuilds a tree)."""
    b = flat(base)
    out = {}
    for k, dv in delta.items():
        if k in b and b[k].shape == dv.shape:
            out[k] = b[k] + dv
        elif k in b and dv.ndim == 2 and b[k].shape[1:] == dv.shape[1:]:
            r = dv.copy()
            r[: b[k].shape[0]] += b[k]
            out[k] = r
        else:
            out[k] = dv
    return out


def unflatten(flat_tree: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """'a/b/c' keys -> nested dicts (list indices stay string keys, as in JAX)."""
    tree: Dict[str, Any] = {}
    for key, value in flat_tree.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def consolidate(src_ckpt_dir: str, dst_path: str) -> None:
    """The newest checkpoint of `train/checkpoint.py`'s format (its trained
    parameters, "params/<name>") as one .npz under their JAX paths and
    layouts (consolidate.py's role)."""
    from visper_lm_tpu_torch.train.checkpoint import CheckpointManager, save_params_numpy

    mgr = CheckpointManager(src_ckpt_dir)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {src_ckpt_dir}")
    saved = torch.load(f"{mgr.directory}/{step}/state.pt", map_location="cpu", weights_only=True)
    params = {k[len("params/"):]: v for k, v in saved["tensors"].items() if k.startswith("params/")}
    save_params_numpy(dst_path, params)
