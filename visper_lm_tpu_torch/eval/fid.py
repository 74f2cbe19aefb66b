"""FID computation for generation-probe quality (get_probe_task_scores.py:163-177);
the port's counterpart of visper_lm_tpu/eval/fid.py (the FID math is a copy).

The reference vendors pytorch-fid (fid_score.py + inception.py). Here the metric is
split from the feature extractor:

  * `compute_stats` / `frechet_distance` — the FID math (numpy; matrix sqrt via the
    eigendecomposition of sigma1 @ sigma2, equivalent to scipy.linalg.sqrtm for the
    PSD-product case pytorch-fid handles);
  * features come from any embedding function. The canonical InceptionV3-pool3
    features require the pt_inception weights (a download, not part of the
    repository) — `inception_feature_fn` loads them from a file, and
    `clip_feature_fn` provides an offline-capable alternative using the framework's
    CLIP tower (scores are not comparable to Inception-FID but rank models the same
    way; the probe comparisons in the reference are relative).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def compute_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mu (D,), sigma (D, D))."""
    feats = np.asarray(features, dtype=np.float64)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def _sqrtm_product(sigma1: np.ndarray, sigma2: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Real part of sqrtm(sigma1 @ sigma2) via eigendecomposition with jitter."""
    prod = sigma1 @ sigma2
    # symmetrize-via-similarity: sqrtm(AB) = A^1/2 (A^1/2 B A^1/2)^1/2 A^-1/2 is the
    # numerically stable route; pytorch-fid falls back to jitter on singularity.
    vals, vecs = np.linalg.eig(prod)
    vals = np.where(vals.real < 0, 0.0, vals)
    sqrt_prod = (vecs * np.sqrt(vals)) @ np.linalg.inv(vecs)
    if not np.isfinite(sqrt_prod).all():
        jitter = np.eye(sigma1.shape[0]) * eps
        return _sqrtm_product(sigma1 + jitter, sigma2 + jitter, eps * 10)
    return sqrt_prod.real


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray
) -> float:
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)) (pytorch-fid formula)."""
    diff = mu1 - mu2
    covmean = _sqrtm_product(sigma1, sigma2)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_features(real: np.ndarray, generated: np.ndarray) -> float:
    mu1, s1 = compute_stats(real)
    mu2, s2 = compute_stats(generated)
    return frechet_distance(mu1, s1, mu2, s2)


def inception_feature_fn(weights_path: str, batch_size: int = 32, device=None) -> Callable:
    """Canonical FID extractor: the eval/inception.py InceptionV3 (FID variant)
    loaded from a pt_inception-2015-12-05 state-dict file (.pth through
    torch.load(weights_only=True), or .npz of the same key layout), run on
    `device` (CUDA unless given). Scores from this path ARE comparable to
    published Inception-FID numbers."""
    from visper_lm_tpu_torch.eval.inception import import_inception
    from visper_lm_tpu_torch.eval.inception import inception_feature_fn as _fn

    if weights_path.endswith(".npz"):
        with np.load(weights_path) as z:
            sd = dict(z)
    else:
        import torch

        sd = {k: v.numpy() for k, v in
              torch.load(weights_path, map_location="cpu", weights_only=True).items()}
    return _fn(import_inception(sd, device=device), batch_size=batch_size)


def clip_feature_fn(tower) -> Callable[[np.ndarray], np.ndarray]:
    """NON-CANONICAL fallback extractor: CLIP tower pooled features (B,H,W,3 in):
    the mean over the patch tokens of the final-normed output, through the
    port's `models.vit.VisionTower` (`tower`, on its own device and dtype).

    FID values computed with this function are NOT comparable to published
    Inception-FID numbers — use them only for relative comparisons between models
    evaluated with the same extractor, and label results 'clip-fid'. For canonical
    scores use inception_feature_fn with the pt_inception weights."""
    import torch

    p0 = next(tower.parameters())

    @torch.no_grad()
    def fn(images: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images), device=p0.device, dtype=p0.dtype)
        last = tower(x, final_norm=True)["last"]
        return last[:, 1:].float().mean(dim=1).cpu().numpy()

    return fn
