"""What tests/test_torch_sequence_parallel.py and
tests/test_torch_pipeline_parallel.py share: the JAX trees and batches the
four ranks of tests/_torch_sp_pp_worker.py start from, the spawn (its own
timeout; a rank that fails or hangs kills the others), and JAX's
single-device steps that the ranks' steps are held to.
"""

import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import torch

import jax

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from visper_lm_tpu.data.collate import build_splice_plan, collate_plans
from visper_lm_tpu.models import vlm as jvlm
from visper_lm_tpu.models.decoder import init_decoder
from visper_lm_tpu.parallel.mesh import make_mesh
from visper_lm_tpu.train import optimizer as jopt
from visper_lm_tpu.train import train_step as jts

from visper_lm_tpu_torch.train import optimizer as topt
from visper_lm_tpu_torch.utils.param import split_layer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_sp_pp_worker import OPT, STEPS, lora_config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SPAWN_TIMEOUT = 300


def batch(cfg, pt: bool, bsz: int = 4, seq: int = 64):
    """A global batch of 4 at T 64 (rows of other lengths; with the
    distillation targets for PT)."""
    rng = np.random.default_rng(1 if pt else 0)
    plans = []
    for b in range(bsz):
        ids = [1, 2, 3] + [IMAGE_TOKEN_INDEX] + list(rng.integers(3, 400, size=8 + 9 * b))
        labels = [IGNORE_INDEX] * 4 + ids[4:]
        plans.append(build_splice_plan(ids, labels, seq, num_image_tokens=cfg.num_image_tokens,
                                       num_task_tokens=2 if pt else 0, num_tasks=3 if pt else 0))
    out = collate_plans(plans, images=rng.normal(size=(bsz, 28, 28, 3)).astype(np.float32))
    if pt:
        for t in cfg.distill.tasks:
            out[f"{t.task}_target"] = rng.normal(
                size=(bsz, t.target_tokens, t.target_dim)).astype(np.float32)
            out[f"{t.task}_mask"] = np.array([1, 0, 1, 1], np.float32)
    return out


def write_inputs(workdir):
    """The JAX trees and batches, written for the ranks; returns them."""
    dcfg = jconfig.tiny_test_vlm(distill=False).decoder
    lora = jvlm.init_vlm(jax.random.PRNGKey(0), lora_config(jconfig))
    rng = np.random.default_rng(1)        # a B that is not zero: the side path is live
    lora["lora"] = {k: {"a": ab["a"], "b": rng.normal(0, 0.05, ab["b"].shape).astype(np.float32)}
                    for k, ab in lora["lora"].items()}
    trees = dict(dec=init_decoder(jax.random.PRNGKey(0), dcfg),
                 dec_remat=init_decoder(jax.random.PRNGKey(1), dcfg),
                 ft=jvlm.init_vlm(jax.random.PRNGKey(0), jconfig.tiny_test_vlm(distill=False)),
                 pt=jvlm.init_vlm(jax.random.PRNGKey(0), jconfig.tiny_test_vlm(distill=True)),
                 lora=lora)
    for name, tree in trees.items():
        with open(os.path.join(workdir, f"{name}.pkl"), "wb") as f:
            pickle.dump(jax.tree_util.tree_map(np.asarray, tree), f)
    batches = dict(ft=batch(jconfig.tiny_test_vlm(distill=False), pt=False),
                   pt=batch(jconfig.tiny_test_vlm(distill=True), pt=True))
    for name, b in batches.items():
        np.savez(os.path.join(workdir, f"{name}.npz"), **b)
    return trees, batches


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(workdir, part: str):
    env = {k: v for k, v in os.environ.items() if not k.startswith("VISPER_")}
    env.update(VISPER_COORDINATOR=f"localhost:{free_port()}", VISPER_NUM_PROCESSES=str(WORLD),
               PYTHONHASHSEED="0", OMP_NUM_THREADS="1")
    worker = os.path.join(REPO, "tests", "_torch_sp_pp_worker.py")
    procs = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen([sys.executable, worker, str(workdir), part], cwd=REPO,
                                          env=dict(env, VISPER_PROCESS_ID=str(r)), stdout=log,
                                          stderr=subprocess.STDOUT))
    return procs


def wait(procs, workdir):
    """Every rank's exit code 0 within SPAWN_TIMEOUT. A rank that fails
    stops the others at once (they would wait on it in a collective); a
    hang fails the test. No rank is left running."""
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        with open(os.path.join(workdir, f"rank{r}.log")) as f:
            log = f.read()
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"


def flat(tree):
    return {jopt._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_steps(cfg, params, b, stage):
    """JAX's single-device step, STEPS updates on the global batch: the
    metrics of each and the trainables after."""
    mesh = make_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    with mesh:
        step, state, _ = jts.make_train_step(cfg, jopt.OptimizerConfig(**OPT, stage=stage), params,
                                             mesh, use_pallas=False)
        dbatch = jts.shard_batch(b, mesh)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, dbatch)
            metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, params=flat(state.params))


def check_metrics(got, want, rtol=1e-5):
    for m_t, m_j in zip(got, want):
        for k in m_j:
            np.testing.assert_allclose(m_t[k], m_j[k], rtol=rtol, atol=1e-7, err_msg=k)


def check_params(state, ref_params):
    """Every trainable of a one-device state file against JAX's (the
    tolerances of tests/test_torch_tensor_parallel.py); returns how many."""
    names = [k[len("params/"):] for k in state if k.startswith("params/")]
    for n in names:
        ref, layer = ref_params[topt.jax_path(n)], split_layer(n)[1]
        got = state[f"params/{n}"].numpy()
        got = got.T if topt.jax_path(n).endswith("/kernel") else got
        np.testing.assert_allclose(got, ref if layer is None else ref[layer], atol=2e-5,
                                   rtol=1e-4, err_msg=n)
    return len(names)


def run(tmp_path_factory, part: str, refs):
    """Spawn the ranks of `part`, compute `refs(trees, batches)` on the JAX
    side while they run, and return (the ranks' records, refs' result, the
    workdir)."""
    workdir = tmp_path_factory.mktemp(part)
    trees, batches = write_inputs(workdir)
    procs = spawn(workdir, part)
    try:
        ref = refs(trees, batches)
    finally:
        wait(procs, workdir)
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ranks, ref, workdir


def step_refs(trees, batches, pt: bool):
    """JAX's finetune step, its LoRA stage (on the finetune batch) and with
    pt its PT step, from the trees."""
    out = dict(ft=jax_steps(jconfig.tiny_test_vlm(distill=False), trees["ft"], batches["ft"],
                            "finetune"),
               lora=jax_steps(lora_config(jconfig), trees["lora"], batches["ft"], "lora"))
    if pt:
        out["pt"] = jax_steps(jconfig.tiny_test_vlm(distill=True), trees["pt"], batches["pt"],
                              "pretrain")
    return out

