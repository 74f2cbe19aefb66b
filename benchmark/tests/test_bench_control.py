"""The controls of `correct` at a tiny size on the CPU: the reference in
float8 (and with half of each micro-batch) is not correct by the limits a
sound run meets; the serving control's float8 and altered tokens read far
above the program's."""


import pytest
import torch

from benchmark import control
from benchmark.harness import loader
from benchmark.tests.tiny import make_copy


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_copy(str(tmp_path_factory.mktemp("ctl")))


def test_train_control_fails_the_limits(root):
    cell = loader.load_cell(root, "pt_tiny.tiny")
    rec = control.train_control(cell, 5, torch.device("cpu"))
    for kind in ("control", "half_batch"):
        assert any(rec[kind][k] > cell.limits[k] for k in cell.limits), rec
        assert rec[kind + "_correct"] is False, rec


def test_serve_control_reads_above_the_program(root):
    cell = loader.load_cell(root, "vqa_tiny.tiny")
    rec = control.serve_control(cell, 6, 1.0, torch.device("cpu"))
    assert rec["correct"]
    assert rec["control"]["altered_gap"] > cell.limits["token_gap"]
    assert rec["control"]["control_gap"] >= rec["program"]["token_gap"]
    assert rec["control"]["kv_error"] > 5 * rec["program"]["kv_error"]
    assert rec["control_correct"] is False and rec["altered_correct"] is False, rec


def test_fp8_matmul_rounds_both_directions():
    from benchmark.reference.models import matmul

    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 96, generator=g, requires_grad=True)
    b = torch.randn(96, 48, generator=g, requires_grad=True)
    up = torch.randn(64, 48, generator=g)
    grads = {}
    for prec in ("f32", "fp8"):
        y = matmul(a, b, prec)
        grads[prec] = (y.detach(), *torch.autograd.grad((y * up).sum(), (a, b)))
    for ref, low in zip(grads["f32"], grads["fp8"]):
        err = float((low - ref).norm() / ref.norm())
        assert 1e-3 < err < 0.2, err
