"""Port models vs their JAX twins on the CPU (tiny_test_vlm, f32).

The JAX params from `init_vlm` are carried onto the port's modules by
`weights.from_jax_params`, so both sides hold the same weights. Tolerances:
atol 1e-5 / rtol 1e-4 per module; 1e-4 / 1e-3 through the whole decoder
(four layers of f32 sums taken in a different order).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.models import decoder as jdec
from visper_lm_tpu.models import projector as jproj
from visper_lm_tpu.models import vit as jvit
from visper_lm_tpu.models import vlm as jvlm

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.models import decoder as tdec
from visper_lm_tpu_torch.models import vit as tvit
from visper_lm_tpu_torch.models import vlm as tvlm
from visper_lm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _close(port, ref, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jconfig.tiny_test_vlm(distill=True)
    cfg_t = tconfig.tiny_test_vlm(distill=True)
    params = jax.tree_util.tree_map(np.asarray, jvlm.init_vlm(jax.random.PRNGKey(0), cfg_j))
    model = from_jax_params(params, cfg_t, device="cpu")
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    return cfg_j, cfg_t, params, model, images


@pytest.mark.parametrize("make", ["phi3_clip_vlm", "tiny_test_vlm"])
@pytest.mark.parametrize("distill", [True, False])
def test_config_asdict_matches_jax(make, distill):
    port = dataclasses.asdict(getattr(tconfig, make)(distill))
    ref = dataclasses.asdict(getattr(jconfig, make)(distill))
    assert port == ref


def test_vit_forward_and_clip_features_match_jax(tiny):
    cfg_j, cfg_t, params, model, images = tiny
    ref = jvit.vit_forward(params["vision_tower"], cfg_j.vision, images, output_layers=(0, 1))
    out = model.vision_tower(torch.from_numpy(images), output_layers=(0, 1))
    for layer in (0, 1):
        _close(out["taps"][layer], ref["taps"][layer])
    _close(out["last"], ref["last"])
    _close(
        tvit.clip_tower_features(model.vision_tower, torch.from_numpy(images)),
        jvit.clip_tower_features(params["vision_tower"], cfg_j.vision, images),
    )


def test_projector_and_encode_images_match_jax(tiny):
    cfg_j, cfg_t, params, model, images = tiny
    x = np.random.default_rng(1).standard_normal((2, 4, 32)).astype(np.float32)
    _close(
        model.mm_projector(torch.from_numpy(x)),
        jproj.projector_forward(params["mm_projector"], cfg_j.projector, x),
    )
    _close(
        tvlm.encode_images(model, torch.from_numpy(images)),
        jvlm.encode_images(params, cfg_j, images),
    )


def test_task_table_and_splice_match_jax(tiny):
    cfg_j, cfg_t, params, model, images = tiny
    _close(tvlm.build_task_token_table(model), jvlm.build_task_token_table(params, cfg_j))
    rng = np.random.default_rng(2)
    b, t = 2, 16
    token_type = rng.integers(0, 4, size=(b, t)).astype(np.int32)
    text_ids = rng.integers(0, 512, size=(b, t)).astype(np.int32)
    src_index = rng.integers(0, 8, size=(b, t)).astype(np.int32)
    feats = rng.standard_normal((b, 4, 64)).astype(np.float32)
    ref = jvlm.splice_embeddings(params, cfg_j, text_ids, token_type, src_index, feats)
    out = tvlm.splice_embeddings(
        model, torch.from_numpy(text_ids).long(), torch.from_numpy(token_type),
        torch.from_numpy(src_index).long(), torch.from_numpy(feats),
    )
    _close(out, ref)


def test_decoder_forward_without_cache_matches_jax(tiny):
    cfg_j, cfg_t, params, model, images = tiny
    rng = np.random.default_rng(3)
    embeds = (0.5 * rng.standard_normal((2, 24, 64))).astype(np.float32)
    lens = np.array([24, 17], np.int32)
    ref = jdec.decoder_forward(
        params["decoder"], cfg_j.decoder, embeds, kv_lengths=jnp.asarray(lens),
        use_pallas=False,
    )
    out = model.decoder(torch.from_numpy(embeds), kv_lengths=torch.from_numpy(lens))
    _close(out["hidden"], ref["hidden"], atol=1e-4, rtol=1e-3)
    _close(out["logits"], ref["logits"], atol=1e-4, rtol=1e-3)


def test_decoder_forward_with_cache_matches_jax(tiny):
    """Left-padded prefill into the cache, then two decode steps; logits and
    the cache contents agree with the JAX decoder."""
    cfg_j, cfg_t, params, model, images = tiny
    rng = np.random.default_rng(4)
    b, t, max_len = 2, 16, 32
    embeds = (0.5 * rng.standard_normal((b, t, 64))).astype(np.float32)
    offsets = np.array([0, 5], np.int32)
    positions = np.maximum(np.arange(t)[None, :] - offsets[:, None], 0)
    lens = np.full((b,), t, np.int32)

    cache_j = jdec.init_kv_cache(cfg_j.decoder, b, max_len, dtype=jnp.float32)
    ref = jdec.decoder_forward(
        params["decoder"], cfg_j.decoder, embeds, positions=jnp.asarray(positions),
        kv_lengths=jnp.asarray(lens), kv_starts=jnp.asarray(offsets), cache=cache_j,
        q_offset=0, use_pallas=False,
    )
    cache_t = tdec.init_kv_cache(cfg_t.decoder, b, max_len, dtype=torch.float32, device="cpu")
    out = model.decoder(
        torch.from_numpy(embeds), positions=torch.from_numpy(positions),
        kv_lengths=torch.from_numpy(lens), kv_starts=torch.from_numpy(offsets),
        cache=cache_t, q_offset=0,
    )
    for i in range(b):  # pad rows are don't-care
        _close(out["logits"][i, offsets[i]:], ref["logits"][i, offsets[i]:], 1e-4, 1e-3)
    cache_j = ref["cache"]
    for step in range(2):
        slot = t + step
        tok = (0.5 * rng.standard_normal((b, 1, 64))).astype(np.float32)
        pos = (slot - offsets)[:, None]
        ref = jdec.decoder_forward(
            params["decoder"], cfg_j.decoder, tok, positions=jnp.asarray(pos),
            kv_lengths=jnp.full((b,), slot + 1, jnp.int32), kv_starts=jnp.asarray(offsets),
            cache=cache_j, q_offset=slot, use_pallas=False,
        )
        out = model.decoder(
            torch.from_numpy(tok), positions=torch.from_numpy(pos),
            kv_starts=torch.from_numpy(offsets), cache=cache_t, q_offset=slot,
        )
        _close(out["logits"], ref["logits"], 1e-4, 1e-3)
        cache_j = ref["cache"]
    for i in range(b):  # valid slots of the cache, written in place by the port
        sl = slice(int(offsets[i]), t + 2)
        _close(cache_t.k[:, sl, i], np.asarray(cache_j.k)[:, sl, i], 1e-4, 1e-3)
        _close(cache_t.v[:, sl, i], np.asarray(cache_j.v)[:, sl, i], 1e-4, 1e-3)


def test_from_jax_params_ignores_heads_and_rejects_unported_subtrees(tiny):
    """The distillation heads and logit scales are carried now (every JAX
    leaf has a port parameter); unported subtrees still raise."""
    cfg_j, cfg_t, params, model, images = tiny
    assert "heads" in params and "logit_scales" in params
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    head = model.heads["seg"][0].resampler.proj_in.weight
    ref = params["heads"]["seg"][0]["resampler"]["proj_in"]["kernel"]
    np.testing.assert_array_equal(head.detach().numpy(), np.asarray(ref).T)
    with pytest.raises(NotImplementedError):
        from_jax_params({**params, "lora": {}}, cfg_t, device="cpu")


def test_init_vlm_is_seeded_and_needs_a_device(monkeypatch):
    cfg = tconfig.tiny_test_vlm(distill=True)
    a = tvlm.init_vlm(cfg, device="cpu", seed=3)
    b = tvlm.init_vlm(cfg, device="cpu", seed=3)
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert a.decoder.blocks[0].q_proj.weight.abs().max() <= 64 ** -0.5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvlm.init_vlm(cfg)


TRAINING_SLICE_MODULES = (
    "train.losses", "train.optimizer", "train.train_step",
    "models.teachers", "models.teachers.dinov2", "models.teachers.unclip",
    "models.teachers.swin", "models.resampler", "models.heads", "ops.window_attention",
)
QUANT_SERVING_MODULES = ("ops.quant_matmul", "ops.decode_attention", "serve.calibrate")


def test_port_imports_no_jax():
    """Importing every port module, the training and quantized-serving slices'
    included, pulls in neither jax nor the JAX package."""
    wanted = ["visper_lm_tpu_torch." + m for m in TRAINING_SLICE_MODULES + QUANT_SERVING_MODULES]
    code = (
        "import pkgutil, importlib, sys\n"
        "import visper_lm_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        f"wanted = {wanted!r}\n"
        "for m in mods + wanted: importlib.import_module(m)\n"
        "missing = [m for m in wanted if m not in mods]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'visper_lm_tpu' or m.startswith('visper_lm_tpu.')]\n"
        "assert len(mods) >= 27, mods\n"
        "assert not missing, missing\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr


def test_vlm_forward_taps_and_task_predictions_match_jax(tiny):
    """vlm_forward's layer taps (right padding through kv_lengths) and every
    head's prediction; the model carries the heads and logit scales."""
    cfg_j, cfg_t, params, model, _ = tiny
    assert tvlm.tap_layer_union(cfg_t) == jvlm.tap_layer_union(cfg_j) == (1, 2, 3)
    assert model.logit_scales["gen"].item() == 2.0 and model.logit_scales["gen"].dtype == torch.float32
    rng = np.random.default_rng(8)
    b, t = 2, 24
    token_type = np.full((b, t), 1, np.int32)
    token_type[:, 3:7] = 2
    token_type[:, 7:13] = 3
    token_type[1, 20:] = 0
    src_index = np.zeros((b, t), np.int32)
    src_index[:, 3:7] = np.arange(4)
    src_index[:, 7:13] = np.arange(6)
    batch = {
        "images": rng.standard_normal((b, 28, 28, 3)).astype(np.float32),
        "text_ids": rng.integers(0, 512, size=(b, t)).astype(np.int32),
        "token_type": token_type, "src_index": src_index,
        "seq_lengths": np.array([t, 20], np.int32),
    }
    ref = jvlm.vlm_forward(params, cfg_j, {k: jnp.asarray(v) for k, v in batch.items()}, use_pallas=False)
    out = tvlm.vlm_forward(model, cfg_t, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert out["tap_layers"] == ref["tap_layers"]
    for g, r in zip(out["taps"], ref["taps"]):
        _close(g, r, 1e-4, 1e-3)
    _close(out["logits"], ref["logits"], 1e-4, 1e-3)
    preds_j = jvlm.predict_task_embeddings(params, cfg_j, ref["taps"], ref["tap_layers"])
    preds_t = tvlm.predict_task_embeddings(model, cfg_t, out["taps"], out["tap_layers"])
    for task in ("gen", "depth", "seg"):
        assert len(preds_t[task]) == len(preds_j[task])
        for g, r in zip(preds_t[task], preds_j[task]):
            _close(g, r, 1e-4, 1e-3)
