"""A tiny copy of the benchmark (the cells' shapes shrunk to the CPU) in a
temporary directory: the port's tiny test config with tiny teachers, a
training and a serving cell, their limits."""

from __future__ import annotations

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TEACHERS = dict(
    dinov2=dict(image_size=28, patch_size=14, hidden_size=24, num_layers=2, num_heads=2, mlp_dim=48,
                norm_eps=1e-6, hidden_act="gelu", use_pre_norm=False, dtype="float32"),
    clip_h=dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64,
                hidden_act="gelu", dtype="float32"),
    swin=dict(embed_dim=2, depths=[1, 1, 1, 1], num_heads=[1, 1, 1, 2], window_size=2),
    gen_embed_dim=24,
)


def tiny_config() -> dict:
    from benchmark.harness.portcfg import _tiny_teachers, describe
    from visper_lm_tpu_torch.config import tiny_test_vlm

    model = describe(tiny_test_vlm(distill=True), _tiny_teachers(TEACHERS))
    model["teachers"]["swin"]["image_size"] = 64
    return {"name": "tiny", "source": "tiny", "reduced": [], "assumed": {},
            "preset": {"function": "tiny_test_vlm", "kwargs": {"distill": True}, "teachers": TEACHERS},
            "dtypes": {"": "float32"}, "model": model}


def make_copy(tmp: str) -> str:
    """A checkout-like directory: BENCHMARK.json and benchmark/, plus the tiny cells."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "tiny.json"), "w") as f:
        json.dump(tiny_config(), f)
    with open(os.path.join(b, "traffic", "pt_distill.json")) as f:
        pt = json.load(f)
    pt.update(per_device_batch=4, micro_batch=2, accum_steps=2, seq_buckets=[64, 128],
              text_tokens={"dist": "uniform", "low": 4, "high": 12})
    pt["optimizer"] = dict(pt["optimizer"], total_steps=100)
    with open(os.path.join(b, "traffic", "pt_tiny.json"), "w") as f:
        json.dump(pt, f)
    # the finetune stage of the same driver: the decoder trained, no teachers
    ift = dict(pt, stage="finetune", teachers=False,
               text_tokens={"dist": "lognormal", "median": 10, "sigma": 0.5, "low": 4, "high": 40},
               trainable=["decoder.", "heads.", "logit_scales.", "mm_projector.", "special_tokens."])
    with open(os.path.join(b, "traffic", "ift_tiny.json"), "w") as f:
        json.dump(ift, f)
    with open(os.path.join(b, "traffic", "vqa.json")) as f:
        vqa = json.load(f)
    vqa.update(rate=20.0, question_tokens={"dist": "uniform", "low": 4, "high": 12},
               max_new_tokens={"short_share": 0.75, "short": [1, 4], "long": [5, 8]},
               image_pool=4, engine={"num_slots": 4, "max_len": 64, "prompt_bucket": 8,
                                     "admit_group": 2},
               warm_seconds=0.5, check_tokens=20, check_max_requests=8, check_caches=2)
    with open(os.path.join(b, "traffic", "vqa_tiny.json"), "w") as f:
        json.dump(vqa, f)
    for cell, lim in (("pt_tiny.tiny", {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}),
                      ("ift_tiny.tiny", {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}),
                      ("vqa_tiny.tiny", {"token_gap": 5e-3, "kv_error": 5e-3})):
        with open(os.path.join(b, "limits", cell + ".json"), "w") as f:
            json.dump(lim, f)
    spec["workloads"] += [
        {"name": "pt_tiny.tiny", "config": "tiny", "traffic": "pt_tiny", "chips": 1, "why": "tiny"},
        {"name": "ift_tiny.tiny", "config": "tiny", "traffic": "ift_tiny", "chips": 1, "why": "tiny"},
        {"name": "vqa_tiny.tiny", "config": "tiny", "traffic": "vqa_tiny", "chips": 1, "why": "tiny"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            if "pt_distill.phi3_vit" in m["workloads"]:
                m["workloads"] += ["pt_tiny.tiny", "ift_tiny.tiny"]
            if "vqa.phi3_convnext" in m["workloads"]:
                m["workloads"].append("vqa_tiny.tiny")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def run_cell(root: str, workload: str, seconds: float = 3.0, seed: int = 123456789012):
    import time

    import torch

    from benchmark.harness import loader
    from benchmark.harness.common import RunArgs

    cell = loader.load_cell(root, workload)
    return cell.driver.Run(cell, RunArgs(workload, seed, seconds), time.time(),
                           torch.device("cpu")).execute()
