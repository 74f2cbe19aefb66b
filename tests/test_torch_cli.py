"""The port's training CLI (visper_lm_tpu_torch/train/cli.py) against the JAX
package's (visper_lm_tpu/train/cli.py).

  * every committed recipe (recipes/*.args) parses to the same namespace as
    JAX's `build_argparser`, with the port's one extra flag (--device, cuda by
    default); overrides after a recipe win in both;
  * `build_vlm_config` equals JAX's field by field (as config dicts);
  * the fake-whitespace tokenizer gives the test suite's FakeTokenizer ids;
  * `main(["--smoke", "--device", "cpu", ...])` runs every stage on a tiny
    dataset of PNG images, writes metrics.jsonl and a checkpoint, and a second
    call resumes from it onto the same data order (step 3's loss equal to the
    uninterrupted run's, rtol 1e-6);
  * `--init-from` overlays an HF-layout checkpoint (bf16-rounded, as JAX),
    a missing one raises; the multi-process flags start the runtime
    (tests/test_torch_multiprocess.py runs two ranks,
    tests/test_torch_tensor_parallel.py four at dp 2 x tp 2), and in one
    process --zero-params / --zero-frozen / --shard-teachers train, --dp 2
    fails JAX's mesh assertion, --tp 4 asks for four processes and a
    coordinator without its process count and id raises.
"""

import json
import os

import numpy as np
import pytest
import torch

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.train import cli as jcli

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.data.image_io import write_png
from visper_lm_tpu_torch.train import cli as tcli

from test_data_pipeline import FakeTokenizer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = sorted(f for f in os.listdir(os.path.join(REPO, "recipes")) if f.endswith(".args"))


def _recipe(name):
    return "@" + os.path.join(REPO, "recipes", name)


def test_all_six_recipes_are_committed():
    assert RECIPES == ["finetune.args", "pretrain.args", "pretrain_full.args", "probe.args",
                       "vpt.args", "vpt_ift.args"]


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_parses_as_in_jax(recipe):
    extra = ["--per-device-batch-size", "4", "--max-steps", "3", "--model", "phi3"]
    for argv in ([_recipe(recipe)], [_recipe(recipe)] + extra):
        got = vars(tcli.build_argparser().parse_args(argv))
        want = vars(jcli.build_argparser().parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == want
    assert tcli.build_argparser().parse_args([_recipe(recipe), "--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("recipe", RECIPES)
def test_build_vlm_config_matches_jax(recipe):
    argv = [_recipe(recipe)]
    got = tcli.build_vlm_config(tcli.build_argparser().parse_args(argv))
    want = jcli.build_vlm_config(jcli.build_argparser().parse_args(argv))
    assert tconfig.config_to_dict(got) == jconfig.config_to_dict(want)


def test_recipe_configs_as_the_reference_sets_them():
    a = tcli.build_argparser().parse_args([_recipe("pretrain.args")])
    cfg = tcli.build_vlm_config(a)
    assert cfg.conv_template == "llava_llama_3" and cfg.num_sys_tokens == 38
    assert {t.task: t.layer_indices for t in cfg.distill.tasks} == {
        "depth": (17, 19), "seg": (9, 17), "gen": (11, 19)}
    probe = tcli.build_vlm_config(tcli.build_argparser().parse_args([_recipe("probe.args")]))
    assert probe.use_convnext_tower and probe.distill.num_task_tokens == 0
    assert len(probe.distill.tasks[0].layer_indices) == probe.decoder.num_layers
    ift = tcli.build_vlm_config(tcli.build_argparser().parse_args([_recipe("finetune.args")]))
    assert ift.distill is None and ift.image_aspect_ratio == "pad"


def test_fake_tokenizer_ids_are_the_test_suites():
    ours, ref = tcli.load_tokenizer("fake-whitespace"), FakeTokenizer()
    for text in ("<|user|>\nhello <image> world<|end|>\n", "a  b\nc", "",
                 "<|start_header_id|>user<|end_header_id|>\n\nx<|eot_id|>"):
        assert ours(text).input_ids == ref(text).input_ids
    assert ours.bos_token_id == ref.bos_token_id == 1


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_data")
    rng = np.random.default_rng(0)
    records = []
    for i in range(12):
        h, w = (int(x) for x in rng.integers(20, 70, size=2))
        write_png(str(root / f"{i}.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        words = " ".join(f"w{int(x)}" for x in rng.integers(0, 99, size=4 + i))
        rec = {"image": f"{i}.png", "conversations": [
            {"from": "human", "value": f"<image>\nwhat is {i}"},
            {"from": "gpt", "value": words}]}
        if i % 4 == 1:
            del rec["image"]
            rec["conversations"][0]["value"] = f"what is {i}"
        records.append(rec)
    (root / "data.json").write_text(json.dumps(records))
    return root


def _argv(stage, dataset, out, *extra):
    return ["--stage", stage, "--smoke", "--device", "cpu", "--data-path", str(dataset / "data.json"),
            "--image-folder", str(dataset), "--tokenizer", "fake-whitespace", "--output-dir", str(out),
            "--per-device-batch-size", "2", "--save-steps", "2", "--seq-buckets", "64,128",
            "--dataloader-num-workers", "2", "--warmup-ratio", "0.0", "--lr", "1e-2", *extra]


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("stage", ["pretrain", "finetune", "vpt", "probe", "pretrain_full"])
def test_smoke_runs_each_stage_and_resumes(stage, dataset, tmp_path):
    full = tcli.main(_argv(stage, dataset, tmp_path / "full", "--max-steps", "3"))
    assert full.step == 3
    rows = _metrics(tmp_path / "full")
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert os.path.isdir(tmp_path / "full" / "checkpoints" / "2")
    # an interrupted run: steps 1-2, then a second call resumes at step 3
    tcli.main(_argv(stage, dataset, tmp_path / "res", "--max-steps", "2"))
    resumed = tcli.main(_argv(stage, dataset, tmp_path / "res", "--max-steps", "3",
                              "--prefetch-depth", "0"))
    assert resumed.step == 3
    rows_res = _metrics(tmp_path / "res")
    assert [r["step"] for r in rows_res] == [1, 2, 3]
    np.testing.assert_allclose(rows_res[2]["loss"], rows[2]["loss"], rtol=1e-6)
    for n, p in full.trainable.items():
        np.testing.assert_allclose(resumed.trainable[n].detach().numpy(), p.detach().numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=n)


def test_init_from_overlays_a_checkpoint(dataset, tmp_path):
    from visper_lm_tpu_torch.checkpoint.hf_export import save_hf_checkpoint
    from visper_lm_tpu_torch.models.vlm import init_vlm

    cfg = tconfig.tiny_test_vlm(distill=False)
    src = init_vlm(cfg, device="cpu", seed=5)
    save_hf_checkpoint(str(tmp_path / "ckpt"), src, cfg)
    argv = _argv("finetune", dataset, tmp_path / "out", "--max-steps", "1",
                 "--init-from", str(tmp_path / "ckpt"))
    step = tcli.main(argv)
    # update 1 has lr 0: the trained model is the overlay itself
    for n, p in src.named_parameters():
        want = p.detach().to(torch.bfloat16).float()
        np.testing.assert_array_equal(dict(step.model.named_parameters())[n].detach().numpy(),
                                      want.numpy(), err_msg=n)
    with pytest.raises(FileNotFoundError):
        tcli.main(_argv("finetune", dataset, tmp_path / "out2", "--max-steps", "1",
                        "--init-from", str(tmp_path / "missing")))


@pytest.mark.parametrize("flags, error, match", [
    (["--tp", "4"], ValueError, "needs 4 processes"),
    (["--dp", "2"], AssertionError, r"dp\(2\) \* pp\(1\) \* sp\(1\) \* ep\(1\) \* tp\(1\) "
                                    r"!= available devices\(1\)"),
    (["--zero-params"], None, None),
    (["--zero-frozen"], None, None),
    (["--shard-teachers"], None, None),
    (["--coordinator", "localhost:1234"], ValueError, "number of processes"),
    (["--num-processes", "2", "--process-id", "1"], ValueError, "coordinator address"),
])
def test_unported_flags_raise(flags, error, match, dataset, tmp_path):
    """No flag is unported any more. In one process ZeRO-3 and sharded
    teachers have nothing to shard and train; --dp 2 asks for a second
    process that is not there (JAX's mesh assertion), --tp 4 for four (the
    four-rank run is tests/test_torch_tensor_parallel.py's); the runtime's
    flags need each other."""
    if error is None:
        state = tcli.main(_argv("pretrain", dataset, tmp_path, *flags, "--max-steps", "1"))
        assert state.step == 1 and state.sharded is None and state.zero is None
        assert state.teacher_sharded is None
        assert len(_metrics(tmp_path)) == 1
        return
    with pytest.raises(error, match=match):
        tcli.main(_argv("pretrain", dataset, tmp_path, *flags))
    assert not os.path.exists(tmp_path / "metrics.jsonl")


@pytest.fixture(scope="module")
def finetune_losses(dataset, tmp_path_factory):
    out = tmp_path_factory.mktemp("plain")
    tcli.main(_argv("finetune", dataset, out, "--max-steps", "3"))
    return [m["loss"] for m in _metrics(out)]


@pytest.mark.parametrize("flags", [["--offload-opt-state"], ["--stream-grads", "8"]])
def test_memory_levers_train_as_without_them(flags, dataset, tmp_path, finetune_losses):
    """A --smoke IFT run with the offloaded moments or the streamed
    gradients logs the losses of the same run without them, exactly (on the
    CPU the host copies are identities; the update is the same)."""
    step = tcli.main(_argv("finetune", dataset, tmp_path, "--max-steps", "3", *flags))
    assert [m["loss"] for m in _metrics(tmp_path)] == finetune_losses
    assert finetune_losses[2] != finetune_losses[1]
    if flags[0] == "--stream-grads":
        assert step.grad_stream is not None and len(step.grad_stream.ranges) >= 2
    else:
        assert step.optimizer.host_bytes > 0 or not any(step.optimizer.plan.values())


def test_pretrain_full_recipe_raises_for_its_memory_levers(dataset, tmp_path):
    """The recipe's --tp 4 needs four processes: in one it raises before any
    work (tests/test_torch_tensor_parallel.py runs the recipe on four)."""
    with pytest.raises(ValueError, match="--tp 4: tensor parallelism needs 4 processes"):
        tcli.main([_recipe("pretrain_full.args"), "--data-path", str(dataset / "data.json"),
                   "--tokenizer", "fake-whitespace", "--output-dir", str(tmp_path), "--device", "cpu"])


BANNED = ("jax", "jaxlib", "visper_lm_tpu", "PIL", "safetensors", "transformers", "diffusers",
          "gradio")
# the visual-interpretation slice's modules, which must be among those checked
VIZ_MODULES = (
    "checkpoint/delta.py", "checkpoint/teacher_bundles.py", "demo.py", "train/viz.py",
    "models/teachers/dpt.py", "models/teachers/oneformer.py", "models/genpipe/__init__.py",
    "models/genpipe/schedulers.py", "models/genpipe/clip_text.py", "models/genpipe/unet.py",
    "models/genpipe/vae.py", "models/genpipe/pipeline.py",
)
# the multi-process slices' modules: one for each file of visper_lm_tpu/parallel,
# and tensor parallelism (GSPMD's work in JAX)
PARALLEL_MODULES = tuple(f"parallel/{name}.py" for name in (
    "__init__", "distributed", "mesh", "pipeline", "sequence", "sharding", "tensor"))
# the evaluation slice's modules: one for each file of visper_lm_tpu/eval
EVAL_MODULES = tuple(f"eval/{name}.py" for name in (
    "__init__", "caption_metrics", "cmmmu", "cvbench", "fid", "grounding_tasks", "harness",
    "inception", "lmms_adapter", "lmms_tasks", "mmmu", "mmstar", "olympiad", "pan_to_sem",
    "probe", "validate"))
# the measurement entry points: a twin of each root bench*.py script
TOOLS_MODULES = tuple(f"tools/{name}.py" for name in (
    "__init__", "bench", "bench_decode", "bench_engine", "bench_input_pipeline",
    "bench_teacher_pattern"))


def _module_level_imports(path):
    """Top-level names imported by the statements of a module's body
    (including those under a module-level if / try), not inside functions."""
    import ast

    tree = ast.parse(open(path).read(), filename=path)
    names, stack = [], list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Import):
            names += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module.split(".")[0])
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                for child in getattr(node, field, []):
                    stack += child.body if isinstance(child, ast.ExceptHandler) else [child]
    return names


def test_no_module_level_import_of_jax_pil_safetensors_or_transformers():
    """Every module of the port and chip_smoke.py: none imports JAX, the JAX
    package, PIL, safetensors, transformers, diffusers or gradio at module
    level (the card has none of them; the PIL, transformers and gradio paths
    import inside functions)."""
    paths = _port_paths()
    assert len(paths) > 68
    for rel in VIZ_MODULES + EVAL_MODULES + PARALLEL_MODULES + TOOLS_MODULES:
        assert os.path.join(REPO, "visper_lm_tpu_torch", rel) in paths, rel
    for path in paths:
        bad = [n for n in _module_level_imports(path) if n in BANNED]
        assert not bad, (path, bad)


def _port_paths():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "visper_lm_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return paths


def test_no_import_of_jax_anywhere():
    """No import of JAX or the JAX package at any depth (inside functions
    too) in the port and chip_smoke.py; the eval and parallel packages have a
    twin of every module of visper_lm_tpu/eval and visper_lm_tpu/parallel, and
    tools/ one of every root bench*.py script (walked here too)."""
    import ast

    paths = _port_paths()
    for path in paths:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module.split(".")[0]]
            else:
                continue
            bad = [n for n in names if n in ("jax", "jaxlib", "visper_lm_tpu")]
            assert not bad, (path, node.lineno, bad)
    jax_eval = sorted(f for f in os.listdir(os.path.join(REPO, "visper_lm_tpu", "eval"))
                      if f.endswith(".py"))
    assert sorted(os.path.basename(m) for m in EVAL_MODULES) == jax_eval
    jax_parallel = {f for f in os.listdir(os.path.join(REPO, "visper_lm_tpu", "parallel"))
                    if f.endswith(".py")}
    assert jax_parallel <= {os.path.basename(m) for m in PARALLEL_MODULES}
    for rel in PARALLEL_MODULES + TOOLS_MODULES:
        assert os.path.join(REPO, "visper_lm_tpu_torch", rel) in paths, rel
