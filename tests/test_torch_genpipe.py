"""The unCLIP generation pipeline of visper_lm_tpu_torch vs the JAX package's
on the CPU (models/genpipe), on `tiny_genpipe_config`: the scheduler tables
bit-equal; `dpm_step`, `timestep_embedding`, `noise_image_embeddings` (the same
noise) and the text encoder at 1e-5; the UNet, the VAE decoder, the denoise
loop (the same latents) and a whole `generate_from_embeds` (JAX's draws handed
to the port) at 1e-4; the diffusers importer on test_genpipe.py's synthetic
state dicts; the config's JSON round trip. JAX's init with every leaf moved by
N(0, 0.1^2), carried over by `weights.genpipe_from_jax_params`. The spec:
tests/test_genpipe.py and tests/test_dpm_golden.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu.models import genpipe as jgp
from visper_lm_tpu.models.genpipe import clip_text as jtext
from visper_lm_tpu.models.genpipe import pipeline as jpipe
from visper_lm_tpu.models.genpipe import schedulers as jsch
from visper_lm_tpu.models.genpipe import unet as junet
from visper_lm_tpu.models.genpipe import vae as jvae

from visper_lm_tpu_torch.models import genpipe as tgp
from visper_lm_tpu_torch.models.genpipe import clip_text as ttext
from visper_lm_tpu_torch.models.genpipe import schedulers as tsch
from visper_lm_tpu_torch.models.genpipe import unet as tunet
from visper_lm_tpu_torch.models.genpipe import vae as tvae
from visper_lm_tpu_torch.weights import genpipe_from_jax_params, module_to_jax_tree

from test_genpipe import _synth_diffusers_sds

torch.set_num_threads(2)
EXACT = dict(rtol=1e-5, atol=1e-5)      # the same arithmetic
DEEP = dict(rtol=1e-4, atol=1e-4)       # through the UNet's / VAE's depth


def _randomize(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))).astype(np.float32), tree)


@pytest.fixture(scope="module")
def pipes():
    cfg_j, cfg_t = jgp.tiny_genpipe_config(), tgp.tiny_genpipe_config()
    tree = _randomize(jgp.init_genpipe(jax.random.PRNGKey(0), cfg_j), 1)
    tree["normalizer"]["std"] = np.abs(tree["normalizer"]["std"]) + 0.5
    return cfg_j, cfg_t, tree, genpipe_from_jax_params(tree, cfg_t, device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("steps", [8, 25])
def test_scheduler_tables_bit_equal(steps):
    np.testing.assert_array_equal(tsch.scaled_linear_betas(), jsch.scaled_linear_betas())
    np.testing.assert_array_equal(tsch.squaredcos_cap_v2_betas(), jsch.squaredcos_cap_v2_betas())
    np.testing.assert_array_equal(tsch.alphas_cumprod(tsch.squaredcos_cap_v2_betas()),
                                  jsch.alphas_cumprod(jsch.squaredcos_cap_v2_betas()))
    tt, tj = tsch.make_dpm_tables(tsch.DPMConfig(), steps), jsch.make_dpm_tables(jsch.DPMConfig(), steps)
    for f in ("timesteps", "alpha_t", "sigma_t", "lambda_t"):
        a, b = getattr(tt, f), getattr(tj, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    ct, cj = tsch.make_dpm_step_coeffs(tt), jsch.make_dpm_step_coeffs(tj)
    assert sorted(ct) == sorted(cj)
    for k in cj:
        assert ct[k].dtype == np.asarray(cj[k]).dtype, k
        np.testing.assert_array_equal(ct[k], np.asarray(cj[k]), err_msg=k)
    # the first step is first order; the last is too only below 15 steps
    assert ct["r_weight"][0] == 0.0 and (ct["r_weight"][-1] == 0.0) == (steps < 15)


def test_dpm_step_and_timestep_embedding():
    rng = np.random.default_rng(0)
    coeffs = tsch.make_dpm_step_coeffs(tsch.make_dpm_tables(tsch.DPMConfig(), 25))
    x, x0, x0p = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32) for _ in range(3))
    for i in (0, 7, 24):
        cj = {k: jnp.asarray(v[i]) for k, v in coeffs.items()}
        ct = {k: torch.from_numpy(np.asarray(v[i])) for k, v in coeffs.items()}
        ref = jsch.dpm_step(cj, jnp.asarray(x), jnp.asarray(x0), jnp.asarray(x0p))
        np.testing.assert_allclose(tsch.dpm_step(ct, _t(x), _t(x0), _t(x0p)).numpy(),
                                   np.asarray(ref), **EXACT)
    t = np.array([0.0, 3.0, 999.0, 541.0], np.float32)
    for dim in (8, 32, 33):
        np.testing.assert_allclose(tunet.timestep_embedding(_t(t), dim).numpy(),
                                   np.asarray(junet.timestep_embedding(jnp.asarray(t), dim)), **EXACT)


def test_clip_text_forward(pipes):
    cfg_j, cfg_t, tree, pipe = pipes
    ids = np.asarray(jtext.empty_prompt_ids(cfg_j.text))
    np.testing.assert_array_equal(ttext.empty_prompt_ids(cfg_t.text).numpy(), ids)
    ids2 = np.random.default_rng(2).integers(0, cfg_j.text.vocab_size, (2, cfg_j.text.max_positions))
    for x in (ids, ids2):
        ref = jax.jit(lambda p, i: jtext.clip_text_forward(p, cfg_j.text, i))(tree["text"], x)
        got = ttext.clip_text_forward(pipe.text, cfg_t.text, torch.from_numpy(np.array(x)))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **EXACT)


def test_unet_forward(pipes):
    cfg_j, cfg_t, tree, pipe = pipes
    rng = np.random.default_rng(3)
    u = cfg_j.unet
    sample = rng.standard_normal((2, u.sample_size, u.sample_size, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, cfg_j.text.max_positions, u.cross_attention_dim)).astype(np.float32)
    cls = rng.standard_normal((2, u.projection_class_embeddings_input_dim)).astype(np.float32)
    for t in (999, 40):
        ref = jax.jit(lambda p, s, c, k: junet.unet_forward(p, u, s, jnp.asarray(t), c, k))(
            tree["unet"], sample, ctx, cls)
        got = tunet.unet_forward(pipe.unet, cfg_t.unet, _t(sample), torch.tensor(t), _t(ctx), _t(cls))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DEEP)


def test_vae_decode(pipes):
    cfg_j, cfg_t, tree, pipe = pipes
    lat = np.random.default_rng(4).standard_normal((2, 8, 8, 4)).astype(np.float32) * 0.3
    ref = jax.jit(lambda p, z: jvae.vae_decode(p, cfg_j.vae, z))(tree["vae"], lat)
    got = tvae.vae_decode(pipe.vae, cfg_t.vae, _t(lat))
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DEEP)


def test_noise_image_embeddings_same_noise(pipes):
    cfg_j, cfg_t, tree, pipe = pipes
    emb = np.random.default_rng(5).standard_normal((2, cfg_j.embed_dim)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.normal(key, emb.shape, jnp.float32))   # what JAX draws inside
    for level in (0, 250):
        ref = jpipe.noise_image_embeddings(tree, cfg_j, jnp.asarray(emb), level, key)
        got = tgp.noise_image_embeddings(pipe, cfg_t, _t(emb), level, _t(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **EXACT)


def test_denoise_loop_same_latents(pipes):
    """The CFG loop against JAX's `_denoise_fn` (lax.scan) on the same inputs."""
    cfg_j, cfg_t, tree, pipe = pipes
    rng = np.random.default_rng(6)
    s = cfg_j.unet.sample_size
    lat = rng.standard_normal((1, s, s, 4)).astype(np.float32)
    cls = rng.standard_normal((2, 2 * cfg_j.embed_dim)).astype(np.float32) * 0.5
    ctx = rng.standard_normal((2, cfg_j.text.max_positions, cfg_j.text.hidden_size)).astype(np.float32)
    steps = 4
    ref = jpipe._denoise_fn(cfg_j, 3.0, steps)(tree, lat, cls, ctx)
    got = tgp.denoise(pipe, cfg_t, _t(lat), _t(cls), _t(ctx), 3.0, steps)
    assert got.shape == (1, 2 * s, 2 * s, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DEEP)


def test_generate_from_embeds_with_jax_draws(pipes):
    """A whole generation: JAX's draws (split key: the augmentation noise,
    then the latents) handed to the port give JAX's image."""
    cfg_j, cfg_t, tree, pipe = pipes
    emb = np.random.default_rng(7).standard_normal((1, 1, cfg_j.embed_dim)).astype(np.float32) * 0.2
    seed, steps = 3, 5
    r_aug, r_lat = jax.random.split(jax.random.PRNGKey(seed))
    noise = np.asarray(jax.random.normal(r_aug, (1, cfg_j.embed_dim), jnp.float32))
    s = cfg_j.unet.sample_size
    latents = np.asarray(jax.random.normal(r_lat, (1, s, s, 4), jnp.float32))
    ref = jgp.generate_from_embeds(tree, cfg_j, emb, num_inference_steps=steps, guidance_scale=2.0,
                                   seed=seed)
    got = tgp.generate_from_embeds(pipe, cfg_t, emb, num_inference_steps=steps, guidance_scale=2.0,
                                   latents=_t(latents), noise=_t(noise))
    assert got.shape == ref.shape == (1, 2 * s, 2 * s, 3)
    np.testing.assert_allclose(got, ref, **DEEP)
    # the port's own draws are a pure function of the seed
    a = tgp.generate_from_embeds(pipe, cfg_t, emb, num_inference_steps=2, seed=5)
    b = tgp.generate_from_embeds(pipe, cfg_t, emb, num_inference_steps=2, seed=5)
    np.testing.assert_array_equal(a, b)


def test_import_genpipe_matches_jax_importer():
    cfg_j, cfg_t = jgp.tiny_genpipe_config(), tgp.tiny_genpipe_config()
    unet_sd, vae_sd, text_sd, norm_sd = _synth_diffusers_sds(cfg_j)
    ref = jax.tree_util.tree_map(np.asarray, jgp.import_genpipe(
        cfg_j, unet_sd=unet_sd, vae_sd=vae_sd, text_sd=text_sd, normalizer_sd=norm_sd))
    tsd = {name: {k: torch.from_numpy(v) for k, v in sd.items()}
           for name, sd in (("u", unet_sd), ("v", vae_sd), ("t", text_sd), ("n", norm_sd))}
    got = tgp.import_genpipe(cfg_t, unet_sd=tsd["u"], vae_sd=tsd["v"], text_sd=tsd["t"],
                             normalizer_sd=tsd["n"])
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in ref_leaves]
    for (path, a), (_, b) in zip(got_leaves, ref_leaves):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # the imported tree loads into the port and renders JAX's image
    pipe = genpipe_from_jax_params(got, cfg_t, device="cpu")
    emb = np.full((1, cfg_j.embed_dim), 0.2, np.float32)
    r_aug, r_lat = jax.random.split(jax.random.PRNGKey(0))
    noise = np.asarray(jax.random.normal(r_aug, emb.shape, jnp.float32))
    latents = np.asarray(jax.random.normal(r_lat, (1, 8, 8, 4), jnp.float32))
    img_j = jgp.generate_from_embeds(ref, cfg_j, emb, num_inference_steps=3)
    img_t = tgp.generate_from_embeds(pipe, cfg_t, emb, num_inference_steps=3,
                                     latents=_t(latents), noise=_t(noise))
    np.testing.assert_allclose(img_t, img_j, **DEEP)
    # and the port's module gives the tree back (the bundle writer's path)
    back = module_to_jax_tree(pipe, stacked=("text.blocks",))
    back_leaves = jax.tree_util.tree_flatten_with_path(back)[0]
    want = [(p, a) for p, a in ref_leaves if np.asarray(a).size]
    assert len(back_leaves) == len(want)
    for (p, a) in want:
        b = back
        for k in p:
            b = b[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_array_equal(b, a, err_msg=str(p))


def test_genpipe_config_json_round_trip():
    for cfg_j, cfg_t in ((jgp.tiny_genpipe_config(), tgp.tiny_genpipe_config()),
                         (jgp.SD21_UNCLIP, tgp.SD21_UNCLIP)):
        d = tgp.genpipe_config_to_dict(cfg_t)
        assert d == jgp.genpipe_config_to_dict(cfg_j)
        assert tgp.genpipe_config_from_dict(jgp.genpipe_config_to_dict(cfg_j)) == cfg_t
        assert jgp.genpipe_config_from_dict(d) == cfg_j
    tweaked = dataclasses.replace(tgp.tiny_genpipe_config(), embed_dim=24, guidance_scale=4.0)
    assert tgp.genpipe_config_from_dict(tgp.genpipe_config_to_dict(tweaked)) == tweaked
