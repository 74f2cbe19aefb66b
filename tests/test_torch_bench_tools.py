"""The port's measurement entry points (visper_lm_tpu_torch/tools/ and
serve/speculative._bench) against the root scripts they are twins of.

  * tools/bench.py: the configs equal JAX's `build_bench_cfg` field by field;
    `build_batch`, `add_teacher_inputs` and `add_random_targets` bit-equal
    to root bench.py's for the PT cell, `--anyres-tiles 2`, `--tower
    convnext` and `--smoke`; `model_tflops_per_step` JAX's arithmetic;
  * tools/bench_decode.py: the batch bench_decode.py hands its Generator
    (recorded by wrapping JAX's Generator) bit-equal, and the port's greedy
    tokens on the JAX weights equal to JAX's;
  * tools/bench_engine.py: the requests bench_engine.py serves equal to
    `request_mix`'s, and at --smoke on the JAX weights the deterministic
    fields (admit_dispatches, group_admissions, slot_occupancy,
    spec_acceptance_rate) equal to the script's;
  * tools/bench_teacher_pattern.py: the per-image rows within 1e-5
    (relative Frobenius) of the batched rows, and both within rtol 1e-3 /
    atol 1e-4 of the JAX teachers' targets on the same pixels and weights
    (the port's seeded teachers carried over by `module_to_jax_tree`; f32);
  * serve/speculative._bench: the break-even value is the formula's on the
    timings it measured;
  * tools/bench_input_pipeline.py: the dataset's records and pixels are the
    JAX script's (PNG in place of JPEG);
  * every tool's `main([..., "--smoke", "--device", "cpu"])` prints one JSON
    line whose keys are the JAX script's plus "device" (the documented
    differences: bench_teacher_pattern names the device in "backend" and
    adds "max_rel_diff"; bench_input_pipeline has no demand_* / sustains_*).
"""

import ast
import contextlib
import dataclasses
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.models import teachers as jteach
from visper_lm_tpu.models.teachers import swin as jswin
from visper_lm_tpu.serve import engine as jeng
from visper_lm_tpu.serve import generate as jgen
from visper_lm_tpu.utils import diagnostics as jdiag

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.checkpoint.teacher_bundles import SWIN_STACKED
from visper_lm_tpu_torch.data.image_io import read_png
from visper_lm_tpu_torch.serve import speculative as tspec
from visper_lm_tpu_torch.serve.generate import GenerationConfig, Generator
from visper_lm_tpu_torch.tools import bench as tbench
from visper_lm_tpu_torch.tools import bench_decode as tdecode
from visper_lm_tpu_torch.tools import bench_engine as tengine
from visper_lm_tpu_torch.tools import bench_input_pipeline as tinput
from visper_lm_tpu_torch.tools import bench_teacher_pattern as tteacher
from visper_lm_tpu_torch.models.teachers import init_teachers
from visper_lm_tpu_torch.weights import from_jax_params, module_to_jax_tree, teachers_from_jax_params

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench as jbench  # noqa: E402  (the root script)

TOOLS = ("bench.py", "bench_decode.py", "bench_engine.py", "bench_input_pipeline.py",
         "bench_teacher_pattern.py")
ROOT_SCRIPTS = {os.path.splitext(t)[0] for t in TOOLS} | {"chip_smoke"}


def _dumped_keys(path, func, var=None):
    """The string keys of the dict literal a function of a root script
    prints (`json.dumps({...})`) or assigns to `var`."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if var is None and isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps" \
                and node.args and isinstance(node.args[0], ast.Dict):
            return {k.value for k in node.args[0].keys}
        if var is not None and isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == var for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no printed dict in {path}:{func}")


def _one_json_line(capsys, run):
    """run(), then the one JSON line it printed on stdout."""
    capsys.readouterr()
    run()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def _run_root_main(module, argv):
    """A root script's main() in this process; the JSON line it printed."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = [module.__name__ + ".py"] + argv
    try:
        with contextlib.redirect_stdout(out):
            module.main()
    finally:
        sys.argv = old
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------- tools/bench.py

BENCH_CELLS = {
    "pt": dict(smoke=False, stage="pretrain", tower="clip", anyres=0),
    "anyres2": dict(smoke=False, stage="pretrain", tower="clip", anyres=2),
    "convnext": dict(smoke=False, stage="pretrain", tower="convnext", anyres=0),
    "smoke": dict(smoke=True, stage="pretrain", tower="clip", anyres=0),
}


@pytest.mark.parametrize("stage", ["pretrain", "finetune", "lora", "vision_tower"])
@pytest.mark.parametrize("tower", ["clip", "convnext"])
def test_bench_cfg_matches_jax(stage, tower):
    for smoke in (False, True):
        assert (tconfig.config_to_dict(tbench.build_bench_cfg(smoke, stage, tower))
                == jconfig.config_to_dict(jbench.build_bench_cfg(smoke, stage, tower)))


@pytest.mark.parametrize("cell", sorted(BENCH_CELLS))
def test_bench_batches_bit_equal_to_the_script(cell):
    c = BENCH_CELLS[cell]
    cfg_j = jbench.build_bench_cfg(c["smoke"], c["stage"], c["tower"])
    cfg_t = tbench.build_bench_cfg(c["smoke"], c["stage"], c["tower"])
    b, t = 4, 64 if c["smoke"] else 1024
    want = jbench.build_batch(cfg_j, b, t, anyres_tiles=c["anyres"])
    got = tbench.build_batch(cfg_t, b, t, anyres_tiles=c["anyres"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        assert got[k].dtype == np.asarray(want[k]).dtype, k
    for add in ("add_teacher_inputs", "add_random_targets"):
        w = getattr(jbench, add)(cfg_j, {}, b)
        g = getattr(tbench, add)(cfg_t, {}, b)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=f"{add} {k}")
    # bench_batch: the measured step's batch is build_batch + the teachers' pixels
    full = tbench.bench_batch(cfg_t, b, t, True, anyres_tiles=c["anyres"])
    for k, v in {**want, **jbench.add_teacher_inputs(cfg_j, {}, b)}.items():
        np.testing.assert_array_equal(full[k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("cell", sorted(BENCH_CELLS))
def test_bench_flops_are_jax_arithmetic(cell):
    """The record's model_tflops_per_step: JAX measure's sum (train_step_flops,
    the tower per anyres tile, the teachers) in its rounding."""
    c = BENCH_CELLS[cell]
    cfg_j = jbench.build_bench_cfg(c["smoke"], c["stage"], c["tower"])
    cfg_t = tbench.build_bench_cfg(c["smoke"], c["stage"], c["tower"])
    b, t = 4, 64 if c["smoke"] else 1024
    want = jdiag.train_step_flops(cfg_j, b, t)
    if c["anyres"]:
        want += c["anyres"] * b * jdiag.vision_flops(cfg_j)
    for teachers in (True, False):
        total = want + (jdiag.teacher_flops(b) if teachers else 0.0)
        student, got = tbench.step_flops(cfg_t, b, t, c["anyres"], teachers)
        assert student == want and got == total
        assert round(got / 1e12, 2) == round(total / 1e12, 2)


def test_bench_main_smoke_prints_jax_keys(capsys):
    rec = _one_json_line(capsys, lambda: tbench.main(["--smoke", "--device", "cpu",
                                                     "--steps", "2"]))
    want = _dumped_keys("bench.py", "main", "record") | _dumped_keys("bench.py", "measure", "extras")
    assert set(rec) == want | {"device"}
    assert rec["metric"] == "pt_train_step_examples_per_sec_per_chip"
    assert rec["vs_baseline"] == 1.0 and rec["baseline_kind"] == "none"
    assert rec["mfu"] is None and rec["mfu_student"] is None and rec["device"] == "cpu"
    assert rec["value"] > 0 and rec["batch"] == 4 and rec["seq"] == 64


def test_bench_port_choices():
    with pytest.raises(ValueError, match="cost model"):
        tbench.main(["--smoke", "--device", "cpu", "--cost-analysis"])
    args = tbench.build_argparser().parse_args([])
    assert args.device == "cuda" and args.remat_policy == "save_gate" and args.steps == 8
    assert (args.batch, args.seq, args.teacher_microbatch) == (4, 1024, 2)


# ---------------------------------------------------------- tools/bench_decode.py

@pytest.fixture(scope="module")
def jax_decode_run():
    """root bench_decode.py --smoke, its Generator's params, the batch it
    generates on and the first generate's tokens recorded."""
    import bench_decode as jscript

    rec = {}
    init, generate = jgen.Generator.__init__, jgen.Generator.generate

    def init_spy(self, params, *a, **kw):
        rec.setdefault("params", params)
        init(self, params, *a, **kw)

    def generate_spy(self, batch, *a, **kw):
        out = generate(self, batch, *a, **kw)
        if "tokens" not in rec:
            rec["batch"] = {k: np.asarray(v) for k, v in batch.items()}
            rec["tokens"] = out
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgen.Generator, "__init__", init_spy)
        mp.setattr(jgen.Generator, "generate", generate_spy)
        rec["record"] = _run_root_main(jscript, ["--smoke"])
    return rec


def test_bench_decode_batch_and_tokens_match_jax(jax_decode_run, capsys):
    cfg = tconfig.tiny_test_vlm(distill=True)
    batch = tdecode.decode_batch(cfg, 2, 64)
    want = jax_decode_run["batch"]
    assert sorted(batch) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(batch[k], want[k], err_msg=k)
    model = from_jax_params(_np_tree(jax_decode_run["params"]), cfg, device="cpu")
    gen = Generator(model, cfg, GenerationConfig(max_new_tokens=8), 2, 64, device="cpu")
    assert gen.generate(batch) == [list(map(int, t)) for t in jax_decode_run["tokens"]]
    rec = tdecode.measure(gen, batch, 8)
    assert set(rec) == set(jax_decode_run["record"]) | {"device"}
    assert rec["batch"] == 2 and rec["value"] > 0
    main_rec = _one_json_line(capsys, lambda: tdecode.main(["--smoke", "--device", "cpu"]))
    assert set(main_rec) == set(rec)


# ---------------------------------------------------------- tools/bench_engine.py

@pytest.fixture(scope="module")
def jax_engine_run():
    """root bench_engine.py --smoke, the params it inits and the requests of
    its first measured workload pass, recorded."""
    import bench_engine as jscript
    from visper_lm_tpu.models import vlm as jvlm

    rec = {}
    init_vlm, run = jvlm.init_vlm, jeng.Engine.run

    def init_spy(*a, **kw):
        rec["params"] = init_vlm(*a, **kw)
        return rec["params"]

    def run_spy(self, requests):
        requests = list(requests)
        rec.setdefault("requests", [(r.plan, r.images, r.max_new_tokens) for r in requests])
        return run(self, requests)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvlm, "init_vlm", init_spy)
        mp.setattr(jeng.Engine, "run", run_spy)
        rec["record"] = _run_root_main(jscript, ["--smoke"])
    return rec


def test_bench_engine_mix_and_counts_match_jax(jax_engine_run, capsys):
    cfg = tconfig.tiny_test_vlm(distill=True)
    mix = tengine.request_mix(cfg, np.random.default_rng(0), 6, 256, 4, 12)
    want = jax_engine_run["requests"]
    assert len(mix) == len(want) == 6
    for (plan, im, mn), (jplan, jim, jmn) in zip(mix, want):
        assert mn == jmn
        np.testing.assert_array_equal(im, jim)
        for f in dataclasses.fields(plan):
            np.testing.assert_array_equal(getattr(plan, f.name), getattr(jplan, f.name), f.name)
    model = from_jax_params(_np_tree(jax_engine_run["params"]), cfg, device="cpu")
    rec = tengine.measure(model, cfg, slots=2, n_req=6, max_len=256, quantum=None, smoke=True,
                          kvq=False, wq=False)
    jrec = jax_engine_run["record"]
    assert set(rec) == set(jrec) | {"device"}
    for k in ("admit_dispatches", "group_admissions", "slot_occupancy", "spec_acceptance_rate",
              "decode_quantum", "slots", "requests", "kv_quant", "weight_quant"):
        assert rec[k] == jrec[k], k
    main_rec = _one_json_line(capsys, lambda: tengine.main(["--smoke", "--device", "cpu"]))
    assert set(main_rec) == set(rec)


# ------------------------------------------------- tools/bench_teacher_pattern.py

def test_teacher_pattern_rows_match_batched_and_jax(capsys):
    tt, sizes = tteacher.smoke_teacher_configs()
    jt = jteach.TeacherConfigs(
        dinov2=jconfig.VisionConfig(**dataclasses.asdict(tt.dinov2)),
        clip_h=jconfig.VisionConfig(**dataclasses.asdict(tt.clip_h)),
        swin=jswin.SwinConfig(**dataclasses.asdict(tt.swin)),
    )
    cfg_j, cfg_t = jconfig.tiny_test_vlm(distill=True), tconfig.tiny_test_vlm(distill=True)
    # the port's seeded teachers as a JAX tree (JAX's init would compile for ~20 s),
    # DINOv2's layerscale away from its 1e-5 init so the branch shows
    seeded = init_teachers(cfg_t, tt, device="cpu", dtype=torch.float32, seed=3)
    tree = {name: module_to_jax_tree(seeded[name], stacked=stacked) for name, stacked in (
        ("dinov2", ("blocks",)), ("clip_h", ("blocks",)), ("swin", SWIN_STACKED))}
    rng = np.random.default_rng(5)
    for ls in ("ls1", "ls2"):
        g = tree["dinov2"]["blocks"][ls]["gamma"]
        tree["dinov2"]["blocks"][ls]["gamma"] = rng.standard_normal(g.shape).astype(np.float32)
    port = teachers_from_jax_params(tree, cfg_t, tt, device="cpu")
    images = tteacher.noise_images(4)
    loop = tteacher.per_image_pass(port, images, sizes)
    batched = tteacher.batched_pass(port, images, sizes)
    pixels = {key: np.stack([tteacher.prep(im, s) for im in images])
              for key, s in zip(("depth_images", "gen_images", "seg_images"), sizes)}
    ref = jteach.make_teacher_fn(cfg_j, jt, microbatch=None)(
        jax.tree_util.tree_map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in pixels.items()})
    for task, a, b in zip(("depth", "gen", "seg"), loop, batched):
        assert tteacher.rel_diff(a, b) <= tteacher.ROW_BOUND[torch.float32], task
        for got in (a, b):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref[task]), rtol=1e-3, atol=1e-4,
                                       err_msg=task)
    rec = _one_json_line(capsys, lambda: tteacher.main(["--smoke", "--device", "cpu",
                                                       "--iters", "1"]))
    assert set(rec) == _dumped_keys("bench_teacher_pattern.py", "main") | {"max_rel_diff"}
    assert rec["backend"] == "torch-cpu (cpu)" and rec["batch"] == 8


# ------------------------------------------------------ serve/speculative._bench

def test_speculative_bench_breakeven_is_the_formula(capsys, monkeypatch):
    times = iter([0.002, 0.010, 0.008])           # draft step, verify chunk, target step
    monkeypatch.setattr(tspec, "_timed", lambda fn, n: (fn(), next(times))[1])
    rec = _one_json_line(capsys, lambda: tspec._bench(["--smoke", "--device", "cpu"]))
    k = 4
    t_iter = (k + 1) * 0.002 + 0.010
    assert rec["value"] == round(max(0.0, (t_iter / 0.008 - 1.0) / k), 4)
    assert rec["tokens_per_sec_at_alpha"] == {
        str(al): round((al * k + 1) / t_iter, 1) for al in (0.5, 0.7, 0.9)}
    assert (rec["draft_step_ms"], rec["verify_chunk_ms"], rec["target_step_ms"]) == (2.0, 10.0, 8.0)
    assert rec["plain_tokens_per_sec"] == 125.0
    assert set(rec) == _dumped_keys("visper_lm_tpu/serve/speculative.py", "_bench") | {"device"}


# ------------------------------------------------- tools/bench_input_pipeline.py

def test_input_pipeline_dataset_is_the_scripts(tmp_path, capsys):
    import bench_input_pipeline as jscript

    path = tinput.make_dataset(str(tmp_path / "port"), 3, np.random.default_rng(0))
    jpath = jscript._make_dataset(str(tmp_path / "jax"), 3, np.random.default_rng(0))
    got, want = json.load(open(path)), json.load(open(jpath))
    for r in want:
        r["image"] = r["image"].replace(".jpg", ".png")
    assert got == want
    rng = np.random.default_rng(0)
    for r in got:
        pixels = rng.integers(0, 255, (480, 640, 3), np.uint8)
        rng.choice(tinput.WORDS, size=40)
        np.testing.assert_array_equal(read_png(str(tmp_path / "port" / r["image"])), pixels)
    rec = _one_json_line(capsys, lambda: tinput.main(["--smoke", "--device", "cpu",
                                                     "--step-ms", "20"]))
    jkeys = _dumped_keys("bench_input_pipeline.py", "main")
    assert set(rec) == {k for k in jkeys if not k.startswith(("demand_", "sustains_"))} | {"device"}
    assert rec["n_images"] == 24 and rec["batch"] == 4 and rec["image_px"] == "640x480 png"
    assert rec["paced_step_ms"] == 20.0 and rec["value"] > 0


# ------------------------------------------------------------------- the imports

def test_tools_import_no_jax_and_no_root_script():
    """Every tool and speculative.py, at any depth: no JAX, no JAX package,
    no root script (bench*.py, chip_smoke.py)."""
    paths = [os.path.join(REPO, "visper_lm_tpu_torch", "tools", t) for t in TOOLS + ("__init__.py",)]
    paths.append(os.path.join(REPO, "visper_lm_tpu_torch", "serve", "speculative.py"))
    for path in paths:
        for node in ast.walk(ast.parse(open(path).read(), filename=path)):
            if isinstance(node, ast.Import):
                names = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module.split(".")[0]]
            else:
                continue
            bad = [n for n in names if n in {"jax", "jaxlib", "visper_lm_tpu"} | ROOT_SCRIPTS]
            assert not bad, (path, node.lineno, bad)
