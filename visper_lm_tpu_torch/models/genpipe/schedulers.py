"""Diffusion schedulers of the unCLIP pipeline (counterpart of
visper_lm_tpu/models/genpipe/schedulers.py).

  * DDPM (squaredcos_cap_v2): the image-embedding NOISE AUGMENTATION: the
    pipeline scales the CLIP image embedding, adds noise at `noise_level`
    (default 0) and embeds the level sinusoidally into the class conditioning.
  * DPM-Solver++(2M): the SAMPLER, as per-step coefficient tables computed on
    the host in float64 numpy (the JAX package's arithmetic, so the tables come
    out bit-equal) and a step on tensors.

The schedules are SD-2.x's training config: 1000 train steps, scaled_linear
betas in [0.00085, 0.012], v-prediction for the 768-px 2.1-unclip UNet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


def scaled_linear_betas(n: int = 1000, beta_start: float = 0.00085,
                        beta_end: float = 0.012) -> np.ndarray:
    return np.linspace(beta_start ** 0.5, beta_end ** 0.5, n, dtype=np.float64) ** 2


def squaredcos_cap_v2_betas(n: int = 1000, max_beta: float = 0.999) -> np.ndarray:
    """diffusers betas_for_alpha_bar with the cosine alpha_bar."""

    def alpha_bar(t):
        return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

    t1 = np.arange(n) / n
    t2 = (np.arange(n) + 1) / n
    return np.minimum(1 - alpha_bar(t2) / alpha_bar(t1), max_beta)


def alphas_cumprod(betas: np.ndarray) -> np.ndarray:
    return np.cumprod(1.0 - betas)


@dataclasses.dataclass(frozen=True)
class NoiseAugConfig:
    num_train_timesteps: int = 1000


def add_noise(cfg: NoiseAugConfig, sample: torch.Tensor, noise: torch.Tensor,
              timestep: int) -> torch.Tensor:
    """DDPM q(x_t | x_0) for the image-embedding augmentation."""
    acp = alphas_cumprod(squaredcos_cap_v2_betas(cfg.num_train_timesteps))
    s = float(np.sqrt(acp[timestep]))
    n = float(np.sqrt(1.0 - acp[timestep]))
    return s * sample + n * noise


@dataclasses.dataclass(frozen=True)
class DPMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    prediction_type: str = "v_prediction"  # SD-2.1-unclip (the 768-px line)
    solver_order: int = 2


@dataclasses.dataclass(frozen=True)
class DPMTables:
    """Per-step tables for a fixed num_inference_steps (host numpy)."""

    timesteps: np.ndarray     # (S,) int32, descending
    alpha_t: np.ndarray       # (S + 1,) alpha at each step and at the end
    sigma_t: np.ndarray       # (S + 1,)
    lambda_t: np.ndarray      # (S + 1,)
    init_noise_sigma: float


def make_dpm_tables(cfg: DPMConfig, num_inference_steps: int) -> DPMTables:
    """DPMSolverMultistepScheduler.set_timesteps for the default (linspace,
    dpmsolver++, lower_order_final) configuration. The final boundary is
    the train timestep 0 (diffusers' appended sigma_last), not sigma 0."""
    acp = alphas_cumprod(scaled_linear_betas(cfg.num_train_timesteps, cfg.beta_start,
                                             cfg.beta_end))
    timesteps = (np.linspace(0, cfg.num_train_timesteps - 1, num_inference_steps + 1)
                 .round()[::-1][:-1].astype(np.int64))
    alpha = np.sqrt(acp[timesteps])
    sigma = np.sqrt(1.0 - acp[timesteps])
    alpha = np.concatenate([alpha, [np.sqrt(acp[0])]])
    sigma = np.concatenate([sigma, [np.sqrt(1.0 - acp[0])]])
    lam = np.log(alpha) - np.log(sigma)
    return DPMTables(
        timesteps=timesteps.astype(np.int32),
        alpha_t=alpha.astype(np.float64),
        sigma_t=sigma.astype(np.float64),
        lambda_t=lam.astype(np.float64),
        init_noise_sigma=1.0,
    )


def data_prediction(cfg: DPMConfig, model_output: torch.Tensor, sample: torch.Tensor,
                    alpha: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The UNet output as an x0 prediction (DPM-Solver++ works on x0)."""
    if cfg.prediction_type == "v_prediction":
        return alpha * sample - sigma * model_output
    if cfg.prediction_type == "epsilon":
        return (sample - sigma * model_output) / alpha
    raise ValueError(cfg.prediction_type)


def make_dpm_step_coeffs(tables: DPMTables) -> Dict[str, np.ndarray]:
    """Per-step scalars, float64 on the host, then rounded to f32 (int32
    timesteps), as JAX's `jnp.asarray(..., jnp.float32)` rounds them.

    Step i: x <- (sigma_{i+1} / sigma_i) x - alpha_{i+1} (e^{-h} - 1) D with
    h = lambda_{i+1} - lambda_i and D = (1 + w) x0_i - w x0_{i-1}, where
    w = h / (2 h_prev) (r_weight); w = 0 at the first step, and at the last
    one for schedules of fewer than 15 steps (lower_order_final)."""
    S = len(tables.timesteps)
    lam, alpha, sigma = tables.lambda_t, tables.alpha_t, tables.sigma_t
    sigma_ratio = np.empty(S)
    alpha_coef = np.empty(S)
    r_weight = np.empty(S)
    for i in range(S):
        h = lam[i + 1] - lam[i]
        sigma_ratio[i] = sigma[i + 1] / sigma[i]
        alpha_coef[i] = -alpha[i + 1] * np.expm1(-h)
        if i == 0 or (i == S - 1 and S < 15):
            r_weight[i] = 0.0
        else:
            h_prev = lam[i] - lam[i - 1]
            r_weight[i] = h / (2.0 * h_prev)
    f32 = np.float32
    return {
        "timesteps": np.asarray(tables.timesteps, np.int32),
        "alpha": alpha[:-1].astype(f32),
        "sigma": sigma[:-1].astype(f32),
        "sigma_ratio": sigma_ratio.astype(f32),
        "alpha_coef": alpha_coef.astype(f32),
        "r_weight": r_weight.astype(f32),
    }


def dpm_step(coeffs_i: Dict[str, torch.Tensor], sample: torch.Tensor, x0: torch.Tensor,
             x0_prev: torch.Tensor) -> torch.Tensor:
    """One DPM-Solver++(2M) update with this step's f32 scalar coefficients."""
    w = coeffs_i["r_weight"]
    d = (1.0 + w) * x0 - w * x0_prev
    return coeffs_i["sigma_ratio"] * sample + coeffs_i["alpha_coef"] * d
