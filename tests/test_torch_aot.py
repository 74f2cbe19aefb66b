"""The port's fit breakdown (train/aot.py) against the JAX package's shapes:
on tiny_test_vlm, every group's bytes equal the bytes summed from
`jax.eval_shape(init_vlm)` and optax's state shapes (nu in the parameters'
dtype), the opt state's host / device split equals JAX's
`plan_offload_layout` on a 1x1 CPU mesh, and the batch equals JAX's
`build_abstract_batch`. With --dp one rank's breakdown: each leaf that
ZeRO's plan shards counts its bytes / dp (JAX's specs on JAX's shapes);
with --tp the decoder's Megatron leaves count their bytes / tp; --topology
(a TPU slice) raises a ValueError. `--no-pallas` builds `--run`'s step with
the decoder's kernels off; `--unrolled-staging` is taken and ignored (JAX's
command line).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.models.vlm import init_vlm as j_init_vlm
from visper_lm_tpu.train import aot as jaot
from visper_lm_tpu.train import optimizer as jopt
from visper_lm_tpu.train import staged_update as jsu
from visper_lm_tpu.utils.param import partition_params

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.train import aot as taot

torch.set_num_threads(2)


def _bytes(tree):
    return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
               for x in jax.tree_util.tree_leaves(tree))


def _jax_sizes(stage, distill, *, offload, min_bytes, batch, seq):
    cfg = jconfig.tiny_test_vlm(distill=distill)
    shape = jax.eval_shape(functools.partial(j_init_vlm, jax.random.PRNGKey(0), cfg))
    mask = jopt.trainable_mask(shape, stage)
    trainable, frozen = partition_params(shape, mask)
    ocfg = jopt.OptimizerConfig(stage=stage)
    tx = jopt.make_optimizer(trainable, ocfg)
    opt_shape = jax.eval_shape(tx.init, trainable)
    mesh = Mesh(np.asarray(jax.devices("cpu")[:1]).reshape(1, 1), ("data", "model"))
    ns = jax.tree_util.tree_map(lambda _: NamedSharding(mesh, P()), opt_shape)
    host = 0
    if offload:
        _, cns = jsu.plan_offload_layout(opt_shape, ns, mesh, min_bytes=min_bytes)
        host = sum(int(np.prod(s.shape)) * np.dtype(s.dtype).itemsize
                   for s, n in zip(jax.tree_util.tree_leaves(opt_shape), jax.tree_util.tree_leaves(cns))
                   if getattr(n, "memory_kind", None) == "pinned_host")
    # the moments only: the schedule counts are not the port's tensors
    moments = sum(int(np.prod(s.shape)) * np.dtype(s.dtype).itemsize
                  for s in jax.tree_util.tree_leaves(opt_shape) if s.shape)
    scalar_moments = sum(np.dtype(s.dtype).itemsize for path, s in
                         jax.tree_util.tree_flatten_with_path(opt_shape)[0]
                         if not s.shape and "count" not in jax.tree_util.keystr(path))
    abstract = jaot.build_abstract_batch(cfg, batch, seq, with_teachers=False, mesh=mesh)
    return dict(params=_bytes(trainable), frozen=_bytes(frozen), opt_state=moments + scalar_moments,
                opt_state_host=host, batch=_bytes(abstract))


@pytest.mark.parametrize("stage,distill", [("finetune", False), ("pretrain", True)])
@pytest.mark.parametrize("offload", [False, True])
def test_breakdown_bytes_match_jax_shapes(stage, distill, offload):
    min_bytes = 4096
    want = _jax_sizes(stage, distill, offload=offload, min_bytes=min_bytes, batch=2, seq=64)
    got = taot.static_breakdown(
        tconfig.tiny_test_vlm(distill=distill), stage=stage, batch_size=2, seq_len=64,
        offload_opt_state=offload, min_bytes=min_bytes)
    for key in ("params", "frozen", "opt_state", "batch"):
        assert got[key] == want[key], key
    assert got["opt_state_host"] == want["opt_state_host"]
    assert got["opt_state_host"] + got["opt_state_device"] == got["opt_state"]
    assert (got["opt_state_host"] > 0) == offload
    assert got["grads_device"] == got["params"] and got["grads_host"] == 0


def test_llama3_ift_counts():
    """IFT at Llama-3-8B + CLIP-L, from the shapes: 8.05 B trainables in bf16
    (16.1 GB), 6 bytes of moments a trainable (48.3 GB, all but the norm
    scales offloaded), and with 8 streamed segments the 32 blocks' gradients
    on the host."""
    cfg = tconfig.llama3_clip_vlm(distill=False)
    got = taot.static_breakdown(cfg, stage="finetune", batch_size=4, seq_len=4096,
                                offload_opt_state=True, stream_grads=8)
    n = got["params"] // 2
    assert 8.0e9 < n < 8.1e9
    assert got["opt_state"] == 6 * n
    assert got["opt_state_device"] < 2e6
    blocks = 32 * (2 * 4096 + 4096 * (4096 + 2 * 1024 + 4096) + 3 * 4096 * 14336)
    assert got["grads_host"] == 2 * blocks


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--tp", "4"], ["--topology", "v5e:2x4"],
                                   ["--no-zero3"]])
def test_multi_device_flags_raise(flags, capsys):
    """--topology (a TPU slice) has no GPU counterpart and raises a
    ValueError; --dp, --tp and --no-zero3 give one rank's breakdown: at dp
    2 with ZeRO-3 (the default) Phi3-mini's IFT trainables and moments are
    about halved (the norm scales and the leaves under 2^16 elements stay
    whole), without ZeRO-3 only the moments; at tp 4 the decoder's Megatron
    leaves are quartered (the tower, projector and norms stay whole)."""
    argv = ["--model", "phi3", "--stage", "finetune"]
    if flags[0] == "--topology":
        with pytest.raises(ValueError, match="--dp x --tp"):
            taot.main(argv + flags)
        return
    import json

    assert taot.main(argv) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert taot.main(argv + flags) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert one["mesh"] == {"data": 1, "model": 1}
    assert got["mesh"]["data"] == (2 if flags[0] == "--dp" else 1)
    assert got["mesh"]["model"] == (4 if flags[0] == "--tp" else 1)
    if flags[0] == "--tp":
        # Phi3-mini's decoder (3.82 B) is most of the trainables; the
        # projector and the norms (0.2 % of them) stay whole on every rank
        for key in ("params_gib_per_chip", "opt_state_gib_per_chip"):
            assert 0.25 < got[key] / one[key] < 0.253, key
        assert got["frozen_gib_per_chip"] == one["frozen_gib_per_chip"]
    elif flags[0] == "--dp":
        for key in ("params_gib_per_chip", "opt_state_gib_per_chip"):
            assert 0.5 < got[key] / one[key] < 0.501, key
        assert got["frozen_gib_per_chip"] == one["frozen_gib_per_chip"]
    else:
        assert got == dict(one, zero3=False, breakdown_s=got["breakdown_s"])
    with pytest.raises(ValueError, match="one process"):
        taot.main(argv + ["--dp", "2", "--run"])
    with pytest.raises(ValueError, match="one process"):
        taot.main(argv + ["--tp", "2", "--run"])


def test_main_prints_the_breakdown_and_runs_a_step_on_the_cpu(capsys, tmp_path):
    """The CLI's line under JAX's keys; run_step's one warm-up and one
    measured step on the CPU (tiny config, offloaded and streamed)."""
    assert taot.main(["--model", "phi3", "--stage", "finetune", "--batch", "2", "--seq", "1024",
                      "--offload-opt", "--stream-grads", "4", "--out", str(tmp_path / "a.jsonl")]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    rec = json.loads(line)
    for key in ("params_gib_per_chip", "opt_state_gib_per_chip", "frozen_gib_per_chip",
                "teachers_gib_per_chip", "batch_gib_per_chip", "opt_state_host_gib"):
        assert key in rec
    assert (tmp_path / "a.jsonl").read_text().strip() == line
    cfg = tconfig.tiny_test_vlm(distill=False)
    out = taot.run_step(cfg, stage="finetune", batch_size=2, seq_len=48, with_teachers=False,
                        offload_opt_state=True, stream_grads=2, master_weights=False,
                        mu_dtype="float32", remat_policy=None, learning_rate=1e-3,
                        blockwise_staging=True, block_bytes=256 << 20, scan_chunks=False,
                        device="cpu")
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert out["update_ms"] is None and "peak_hbm_gib" not in out


def test_no_pallas_and_unrolled_staging(capsys, monkeypatch):
    """JAX's `--no-pallas` and `--unrolled-staging`: the parser takes both;
    with --run --no-pallas the step is built with use_kernel=False (the
    decoder's attention on the plain path, no B1-B3 launch), without it
    with the default; --unrolled-staging changes nothing of the report."""
    from visper_lm_tpu_torch.train import train_step as tts

    args = taot.build_parser().parse_args(["--no-pallas", "--unrolled-staging"])
    assert args.no_pallas and args.unrolled_staging
    jargs = ["--model", "phi3", "--stage", "finetune"]
    assert taot.main(jargs) == 0
    plain = capsys.readouterr().out.strip().splitlines()[-1]
    assert taot.main(jargs + ["--unrolled-staging"]) == 0
    import json

    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == dict(json.loads(plain), breakdown_s=got["breakdown_s"])

    seen, run_step = [], taot.run_step
    monkeypatch.setattr(taot, "run_step", lambda cfg, **kw: seen.append(kw["use_kernel"]) or {})
    for flags in ([], ["--no-pallas"]):
        assert taot.main(jargs + ["--run"] + flags) == 0
    assert seen == [None, False]

    made = []
    make_loss_fn = tts.make_loss_fn

    def recording(*a, **kw):
        made.append(kw.get("use_kernel"))
        return make_loss_fn(*a, **kw)

    monkeypatch.setattr(tts, "make_loss_fn", recording)
    out = run_step(tconfig.tiny_test_vlm(distill=False), stage="finetune", batch_size=2,
                        seq_len=48, with_teachers=False, offload_opt_state=False, stream_grads=0,
                        master_weights=False, mu_dtype="float32", remat_policy=None,
                        learning_rate=1e-3, blockwise_staging=True, block_bytes=256 << 20,
                        scan_chunks=False, device="cpu", use_kernel=False)
    assert made == [False] and all(np.isfinite(out["losses"]))
