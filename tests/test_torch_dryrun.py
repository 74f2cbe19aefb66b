"""The port's multi-process dry run (visper_lm_tpu_torch/dryrun.py), the
counterpart of tests/test_graft_entry.py's `dryrun_multichip(8)`: one spawn
of eight gloo ranks, asked onto the CPU (the entry point's default is the
card), runs JAX's four dry runs (PT at dp 4 x tp 2 with ZeRO-3 and
save_qkv_mlp, finetune at dp 2 x pp 2 x tp 2, a MoE decoder at dp 2 x ep 2
x tp 2, the pretrain_full streaming step) and each must end in a finite
loss on JAX's meshes. It is not marked slow: eight tiny ranks
take about ten seconds (JAX's twin compiles four programs in a subprocess).
"""

import math

import pytest
import torch

from visper_lm_tpu_torch import dryrun


def test_dryrun_multichip_runs_jax_four_steps(capsys):
    recs = dryrun.dryrun_multichip("cpu", timeout=420)
    assert [r["name"] for r in recs] == ["pt", "pipeline", "expert", "stream_full"]
    meshes = {r["name"]: r["mesh"] for r in recs}
    assert meshes == {
        "pt": {"data": 4, "model": 2},
        "pipeline": {"data": 2, "pipe": 2, "model": 2},
        "expert": {"data": 2, "expert": 2, "model": 2},
        "stream_full": {"data": 4, "model": 2},
    }
    assert all(math.isfinite(r["loss"]) for r in recs)
    assert math.isfinite(recs[2]["lb"]) and recs[3]["segments"] >= 2
    # JAX's dry run prints the first run's line in this form
    assert "dryrun pt: mesh={'data': 4, 'model': 2} loss=" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where no card is present")
def test_dryrun_runs_on_the_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="no card is present"):
        dryrun.dryrun_multichip()
    with pytest.raises(ValueError, match="cuda or cpu"):
        dryrun.dryrun_multichip("tpu")
