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
    a missing one raises; the flags the port does not have raise
    NotImplementedError naming ROADMAP items 7 and 8.
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


@pytest.mark.parametrize("flags", [
    ["--tp", "4"], ["--dp", "2"], ["--zero-params"], ["--zero-frozen"], ["--offload-opt-state"],
    ["--shard-teachers"], ["--stream-grads", "8"], ["--coordinator", "localhost:1234"],
    ["--num-processes", "2", "--process-id", "1"],
])
def test_unported_flags_raise(flags, dataset, tmp_path):
    with pytest.raises(NotImplementedError, match="items 7 and 8"):
        tcli.main(_argv("pretrain", dataset, tmp_path, *flags))
    assert not os.path.exists(tmp_path / "metrics.jsonl")


def test_pretrain_full_recipe_raises_for_its_memory_levers(dataset, tmp_path):
    with pytest.raises(NotImplementedError, match="--tp, --zero-params"):
        tcli.main([_recipe("pretrain_full.args"), "--data-path", str(dataset / "data.json"),
                   "--tokenizer", "fake-whitespace", "--output-dir", str(tmp_path), "--device", "cpu"])


BANNED = ("jax", "jaxlib", "visper_lm_tpu", "PIL", "safetensors", "transformers")


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
    package, PIL, safetensors or transformers at module level (the card has
    none of them; the PIL and transformers paths import inside functions)."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "visper_lm_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 55
    for path in paths:
        bad = [n for n in _module_level_imports(path) if n in BANNED]
        assert not bad, (path, bad)
