"""Whole runs of the benchmark's two drivers at a tiny size on the CPU (the
chip look skipped): sound runs come out correct, and each fault a cell can
have, planted underneath the timed path, comes out not correct."""

import pytest

from benchmark.tests.tiny import make_copy, run_cell


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", ["pt_tiny.tiny", "ift_tiny.tiny"])
def test_train_cell_sound(root, cell):
    res = run_cell(root, cell)
    assert res["correct"], res["checks"]
    assert res["values"]["train_examples_per_s"] > 0 and res["values"]["setup_s"] > 0


@pytest.mark.parametrize("cell", ["pt_tiny.tiny", "ift_tiny.tiny"])
def test_train_cell_state_unchanged(root, monkeypatch, cell):
    from visper_lm_tpu_torch.train import optimizer

    monkeypatch.setattr(optimizer, "adam_leaf_update", lambda *a, **k: None)
    res = run_cell(root, cell)
    assert not res["correct"] and res["checks"]["change_gap"]["value"] > 0.5


@pytest.mark.parametrize("cell", ["pt_tiny.tiny", "ift_tiny.tiny"])
def test_train_cell_half_batch(root, monkeypatch, cell):
    from visper_lm_tpu_torch.train.train_step import TrainStep

    orig = TrainStep.loss_and_grads

    def half(self, batch):
        b = batch["labels"].shape[0]
        return orig(self, {k: v[: b // 2] for k, v in batch.items()})

    monkeypatch.setattr(TrainStep, "loss_and_grads", half)
    res = run_cell(root, cell)
    assert not res["correct"], res["checks"]


def test_serve_cell_sound(root):
    res = run_cell(root, "vqa_tiny.tiny")
    assert res["correct"], res["checks"]
    assert res["values"]["requests_per_s"] > 0


def test_serve_cell_altered_token(root, monkeypatch):
    from visper_lm_tpu_torch.serve import engine

    orig = engine._sample_tokens

    def shifted(logits, gen_cfg, generator):
        return (orig(logits, gen_cfg, generator) + 1) % logits.shape[-1]

    monkeypatch.setattr(engine, "_sample_tokens", shifted)
    res = run_cell(root, "vqa_tiny.tiny")
    assert not res["correct"], res["checks"]
