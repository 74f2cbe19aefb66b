"""The harness's pieces on their own: the imports it may make, finding a
cell's files by name (a new configuration, traffic mix, driver and metric
added as files alone), the traffic's dependence on the seed, the counts
against brute force and the reference against the port's plain path."""

import ast
import json
import os
import shutil

import numpy as np
import pytest
import torch

from benchmark.tests.tiny import ROOT, make_copy, tiny_config

BENCH = os.path.join(ROOT, "benchmark")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "visper_lm_tpu"}, tops


@pytest.mark.parametrize("path", sorted(_sources("reference")), ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"torch", "numpy", "math", "statistics", "hashlib", "re", "typing",
                    "__future__", "benchmark"}, tops
    assert not [m for m in _imports(path) if m.startswith("benchmark.") and
                not m.startswith("benchmark.reference")]


def test_new_cell_found_from_files_alone(tmp_path):
    from benchmark.harness import loader

    root = make_copy(str(tmp_path))
    b = os.path.join(root, "benchmark")
    shutil.copy(os.path.join(b, "configs", "tiny.json"), os.path.join(b, "configs", "tiny2.json"))
    with open(os.path.join(b, "traffic", "mix2.json"), "w") as f:
        json.dump({"driver": "echo2", "clients": 1}, f)
    with open(os.path.join(b, "drivers", "echo2.py"), "w") as f:
        f.write("class Run:\n    pass\n")
    with open(os.path.join(b, "metrics", "echo_ms.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.get('echo')\n")
    with open(os.path.join(b, "limits", "mix2.tiny2.json"), "w") as f:
        json.dump({}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "mix2.tiny2", "config": "tiny2", "traffic": "mix2", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "echo_ms", "unit": "ms", "better": "lower", "source": "host_clock",
                              "layer": "x", "moves": "setup_s", "workloads": ["mix2.tiny2"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    cell = loader.load_cell(root, "mix2.tiny2")
    assert cell.config["name"] == "tiny" and cell.traffic["clients"] == 1
    assert hasattr(cell.driver, "Run") and [n for n, _ in cell.per_layer] == ["echo_ms"]
    assert loader.read_metrics(cell, {"echo": 2.5}) == {"echo_ms": 2.5}
    assert loader.read_metrics(cell, {}) == {}


def _traffic(kind, seed):
    from benchmark.harness.traffic import ServeTraffic, TrainTraffic

    cfg = tiny_config()["model"]
    with open(os.path.join(BENCH, "traffic", "pt_distill.json" if kind == "train" else "vqa.json")) as f:
        t = json.load(f)
    if kind == "train":
        t.update(per_device_batch=4, micro_batch=2, seq_buckets=[64, 128],
                 text_tokens={"dist": "uniform", "low": 4, "high": 12})
        tr = TrainTraffic(cfg, t, seed, "cpu")
        return [tr.step(s) for s in range(3)]
    t.update(question_tokens={"dist": "uniform", "low": 4, "high": 12}, image_pool=4, requests=50)
    tr = ServeTraffic(cfg, t, seed, "cpu")
    return [tr.next() for _ in range(10)], tr.images


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_traffic_reproducible_and_seeded(kind):
    a, b, c = _traffic(kind, 2 ** 31 + 5), _traffic(kind, 2 ** 31 + 5), _traffic(kind, 7)
    if kind == "train":
        flat = lambda x: [v for step in x for mb in step for v in mb.values()]
        assert all(np.array_equal(u, v) for u, v in zip(flat(a), flat(b)))
        assert not all(np.array_equal(u, v) for u, v in zip(flat(a), flat(c)))
        lens = lambda x: sorted(int(n) for step in x for mb in step for n in mb["seq_lengths"])
        assert lens(a) == lens(c)          # the same sizes, in another order
    else:
        assert all(np.array_equal(r.plan.text_ids, s.plan.text_ids) for r, s in zip(a[0], b[0]))
        assert np.array_equal(a[1], b[1]) and not np.array_equal(a[1], c[1])
        assert any(not np.array_equal(r.plan.text_ids, s.plan.text_ids) for r, s in zip(a[0], c[0]))


def test_attention_pairs_brute_force():
    from benchmark.counts.kernels import attention_pairs

    rng = np.random.default_rng(0)
    for causal in (True, False):
        t, s, b = 9, 9, 3
        lens, starts = rng.integers(1, s + 1, b), rng.integers(0, 4, b)
        brute = sum(int(starts[i] <= j < lens[i] and (not causal or j <= r))
                    for i in range(b) for r in range(t) for j in range(s))
        assert attention_pairs(t, s, causal, lens, starts, b) == brute


def _count(fn):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_model_counts_brute_force():
    from benchmark.counts import model as counts
    from benchmark.reference import models, spec
    from benchmark.reference.weights import Weights

    m = tiny_config()["model"]
    c = models.Ctx(Weights({**spec.vlm(m), **spec.teachers(m)}, 1, "x", "cpu", {"": torch.float32}))
    img = torch.randn(2, 28, 28, 3)
    assert _count(lambda: models.clip_features(c, m["tower"], img)) == 2 * counts.tower_forward(m)
    t = m["teachers"]
    assert _count(lambda: models.clip_h_target(c, t["clip_h"], img)) == \
        2 * counts.vit_forward(t["clip_h"], t["clip_h"]["num_layers"], final_tokens=1)
    seg = torch.randn(2, 64, 64, 3)
    assert _count(lambda: models.swin_target(c, t["swin"], seg)) == 2 * counts.swin_forward(t["swin"], 64)
    cn = {"kind": "convnext", "image_size": 64, "depths": [1, 1, 1, 1], "dims": [4, 8, 16, 32],
          "norm_eps": 1e-6}
    mc = dict(m, tower=cn)
    cc = models.Ctx(Weights(spec.convnext(cn, "vision_tower."), 1, "x", "cpu", {"": torch.float32}))
    got = _count(lambda: models.convnext_features(cc, cn, torch.randn(1, 64, 64, 3)))
    assert got == counts.tower_forward(mc)
    d = m["decoder"]
    lens = [5, 9]
    emb = torch.randn(2, 9, d["hidden_size"])
    fwd = _count(lambda: models.decoder(c, d, emb, torch.tensor(lens)))
    # the plain forward runs every position and the full score matrix
    dense = 2.0 * counts.decoder_linear_params(d) * 18 + 4.0 * d["num_heads"] * d["head_dim"] * 81 * 2 \
        * d["num_layers"]
    assert fwd == dense


def test_reference_matches_port_plain_path():
    """The reference's training loss and tower features against the port's
    plain (CPU) path on the same drawn weights."""
    from benchmark.harness import portcfg
    from benchmark.harness.traffic import TrainTraffic
    from benchmark.reference import models, spec
    from benchmark.reference.weights import Weights, fill_
    from visper_lm_tpu_torch.models.teachers import init_teachers, make_teacher_fn
    from visper_lm_tpu_torch.models.vlm import init_vlm, tower_features
    from visper_lm_tpu_torch.train.train_step import make_loss_fn

    conf = tiny_config()
    m = conf["model"]
    cfg, tcfgs = portcfg.build(conf, with_teachers=True)
    model = init_vlm(cfg, device="cpu")
    fill_(model.named_parameters(), 3, "vlm")
    teachers = init_teachers(cfg, tcfgs, device="cpu", dtype=torch.float32)
    fill_(teachers.named_parameters(), 3, "teachers")
    with open(os.path.join(BENCH, "traffic", "pt_distill.json")) as f:
        t = json.load(f)
    t.update(per_device_batch=4, micro_batch=4, seq_buckets=[64, 128],
             text_tokens={"dist": "uniform", "low": 4, "high": 12})
    batch = {k: torch.as_tensor(v) for k, v in TrainTraffic(m, t, 3, "cpu").step(0)[0].items()}
    loss_fn = make_loss_fn(cfg, teacher_fn=make_teacher_fn(cfg, tcfgs), remat=False)
    with torch.no_grad():
        port, _ = loss_fn(model, batch, teachers)
        rules = {"": torch.float32}
        W = Weights(spec.vlm(m), 3, "vlm", "cpu", rules)
        Wt = Weights(spec.teachers(m), 3, "teachers", "cpu", rules)
        targets = models.teacher_targets(models.Ctx(Wt), m, batch)
        ref = models.vlm_loss(models.Ctx(W), m, batch, targets, remat=False)
        feats = tower_features(model, batch["images"])
        ref_feats = models.tower_features(models.Ctx(W), m, batch["images"])
    assert abs(float(port) - float(ref)) <= 1e-5 * abs(float(ref))
    torch.testing.assert_close(feats, ref_feats, rtol=1e-5, atol=1e-5)


def test_trace_reduction():
    from benchmark.harness.trace import breakdown, reduce_events

    ms = 10 ** 6
    dev = [(0, 2 * ms, "flash_fwd_wgmma_kernel<96>"), (1 * ms, 3 * ms, "gemm"),
           (10 * ms, 11 * ms, "window_attn_stream_kernel"), (20 * ms, 22 * ms, "gemm")]
    host = [(0, 1 * ms, "aten::mm"), (4 * ms, 12 * ms, "aten::copy_"), (14 * ms, 15 * ms, "aten::add")]
    s = reduce_events(dev, host, 0.025, [])
    assert abs(s["busy_s"] - 0.006) < 1e-12 and s["window_s"] == 0.025
    assert s["kernels"] == {"fwd": [0.002], "window": [0.001]}
    assert s["gaps"] == [["host in aten::copy_", 0.007], ["host after aten::add", 0.009]][::-1]
    assert breakdown(s)["device_ops"][0] == ["gemm", 0.004]
