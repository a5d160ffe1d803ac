"""NIQE, the natural image quality evaluator, on the host in numpy and scipy:
the port's own copy of hifidiff_tpu/eval/niqe.py (which imports no JAX),
line for line, so that the port imports nothing of the JAX package.

The reference gets NIQE from pyiqa (`test_refiner.py:107-109`). This is a
from-scratch implementation of the Mittal et al. algorithm:
  1. MSCN coefficients (local mean/variance normalization, 7x7 Gaussian).
  2. Per 96x96 patch: fit a generalized Gaussian (GGD) to the MSCN field and
     asymmetric GGDs (AGGD) to its 4 pairwise products -> 18 features, at two
     scales -> 36 features.
  3. Quality = Mahalanobis-style distance between the multivariate Gaussian
     of the test patches and a pristine-corpus model (mu, cov).

A pristine model file is required for absolute scores; `fit_niqe_model`
builds one from any pristine image set, so the metric is self-hostable
offline (no pyiqa model download). Images are NHWC numpy arrays, as the
JAX package takes them; move a tensor to the host first.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
from scipy.ndimage import convolve
from scipy.special import gamma


def _gaussian_kernel2d(size: int = 7, sigma: float = 7.0 / 6.0) -> np.ndarray:
    half = size // 2
    xs = np.arange(-half, half + 1)
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return k / k.sum()


def mscn(img: np.ndarray, kernel: Optional[np.ndarray] = None,
         c: float = 1.0) -> np.ndarray:
    """img: (H, W) float in [0, 255]."""
    if kernel is None:
        kernel = _gaussian_kernel2d()
    mu = convolve(img, kernel, mode="nearest")
    sigma = np.sqrt(np.abs(convolve(img * img, kernel, mode="nearest")
                           - mu * mu))
    return (img - mu) / (sigma + c)


_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = (gamma(1.0 / _GAM) * gamma(3.0 / _GAM)) / (gamma(2.0 / _GAM) ** 2)


def fit_ggd(x: np.ndarray) -> Tuple[float, float]:
    """Generalized Gaussian fit -> (alpha, sigma^2)."""
    sigma_sq = np.mean(x ** 2)
    e_abs = np.mean(np.abs(x))
    rho = sigma_sq / max(e_abs ** 2, 1e-12)
    alpha = _GAM[np.argmin(np.abs(_R_GAM - rho))]
    return float(alpha), float(sigma_sq)


def fit_aggd(x: np.ndarray) -> Tuple[float, float, float, float]:
    """Asymmetric GGD fit -> (alpha, mean, sigma_l^2, sigma_r^2)."""
    left = x[x < 0]
    right = x[x > 0]
    sigma_l = math.sqrt(np.mean(left ** 2)) if left.size else 1e-6
    sigma_r = math.sqrt(np.mean(right ** 2)) if right.size else 1e-6
    gamma_hat = sigma_l / max(sigma_r, 1e-12)
    e_abs = np.mean(np.abs(x))
    rhat = (e_abs ** 2) / max(np.mean(x ** 2), 1e-12)
    rhat_norm = rhat * (gamma_hat ** 3 + 1) * (gamma_hat + 1) / \
        (gamma_hat ** 2 + 1) ** 2
    r_alpha = (gamma(2.0 / _GAM) ** 2) / (gamma(1.0 / _GAM)
                                          * gamma(3.0 / _GAM))
    alpha = _GAM[np.argmin((r_alpha - rhat_norm) ** 2)]
    const = math.sqrt(gamma(1.0 / alpha) / gamma(3.0 / alpha))
    mean = (sigma_r - sigma_l) * (gamma(2.0 / alpha) / gamma(1.0 / alpha)) \
        * const
    return float(alpha), float(mean), float(sigma_l ** 2), float(sigma_r ** 2)


def _patch_features(patch: np.ndarray) -> np.ndarray:
    feats = []
    alpha, sigma_sq = fit_ggd(patch)
    feats += [alpha, sigma_sq]
    shifts = [(0, 1), (1, 0), (1, 1), (1, -1)]
    for dy, dx in shifts:
        shifted = np.roll(np.roll(patch, dy, axis=0), dx, axis=1)
        feats += list(fit_aggd((patch * shifted).ravel()))
    return np.asarray(feats)


def _cubic(x: np.ndarray) -> np.ndarray:
    """MATLAB's bicubic interpolation kernel (a = -0.5)."""
    ax = np.abs(x)
    ax2, ax3 = ax ** 2, ax ** 3
    return ((1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0)
            * ((ax > 1) & (ax <= 2)))


def _imresize_weights(n_in: int, n_out: int, scale: float):
    """MATLAB `imresize` contribution weights/indices for one dimension,
    ANTIALIASED bicubic (scale < 1 widens the kernel by 1/scale — the
    pyiqa/basicsr `imresize` used for NIQE's second scale). Out-of-range
    taps use MATLAB's SYMMETRIC (mirror) boundary map
    `aux = [1:n, n:-1:1]`, not replicate-clipping."""
    kernel_width = 4.0 / scale if scale < 1 else 4.0
    u = (np.arange(n_out) + 0.5) / scale - 0.5
    left = np.floor(u - kernel_width / 2).astype(int)
    p = int(math.ceil(kernel_width)) + 2
    idx = left[:, None] + np.arange(p)[None, :]
    dist = u[:, None] - idx
    w = _cubic(dist * scale) * scale if scale < 1 else _cubic(dist)
    w = w / w.sum(axis=1, keepdims=True)
    # MATLAB mirror map: index i (0-based, any integer) -> aux[mod(i, 2n)]
    # with aux = [0..n-1, n-1..0]
    aux = np.concatenate([np.arange(n_in), np.arange(n_in)[::-1]])
    idx = aux[np.mod(idx, 2 * n_in)]
    return w, idx


def imresize_half(img: np.ndarray) -> np.ndarray:
    """MATLAB/pyiqa `imresize(img, scale=0.5)` with antialiasing, (H, W).
    Output size follows MATLAB: ceil(n * scale)."""
    h, w = img.shape
    ho, wo = math.ceil(h * 0.5), math.ceil(w * 0.5)
    wy, iy = _imresize_weights(h, ho, 0.5)
    wx, ix = _imresize_weights(w, wo, 0.5)
    tmp = np.einsum("op,opw->ow", wy, img[iy, :])          # rows
    return np.einsum("op,hop->ho", wx, tmp[:, ix])         # cols


def niqe_features(img: np.ndarray, patch_size: int = 96) -> np.ndarray:
    """img: (H, W) luma in [0, 255] -> (num_patches, 36) features.

    Pipeline conventions match pyiqa/basicsr `calculate_niqe`: the image is
    cropped to a patch-size multiple ONCE, before the scale loop (basicsr
    `img = img[0:num_block_h*96, 0:num_block_w*96]` — so MSCN replicate
    borders and the 0.5x resize see the crop, not the full image); MSCN
    with a 7x7 sigma-7/6 Gaussian and replicate borders, 96x96 patches,
    second scale via MATLAB antialiased-bicubic 0.5x `imresize` (NOT mean
    pooling) with 48x48 patches; circshift (wraparound) pairwise products;
    GGD/AGGD fits over the 0.2:0.001:10 gamma grid."""
    ph, pw = img.shape[0] // patch_size, img.shape[1] // patch_size
    if ph == 0 or pw == 0:
        raise ValueError("image too small for NIQE patches")
    img = img[:ph * patch_size, :pw * patch_size]
    kernel = _gaussian_kernel2d()
    feats_scales = []
    for scale in range(2):
        coeffs = mscn(img, kernel)
        h, w = coeffs.shape
        ph, pw = h // patch_size, w // patch_size
        feats = []
        for i in range(ph):
            for j in range(pw):
                p = coeffs[i * patch_size:(i + 1) * patch_size,
                           j * patch_size:(j + 1) * patch_size]
                feats.append(_patch_features(p))
        feats_scales.append(np.asarray(feats))
        if scale == 0:
            img = imresize_half(img / 255.0) * 255.0
            patch_size //= 2
    n = min(len(feats_scales[0]), len(feats_scales[1]))
    if n == 0:
        raise ValueError("image too small for NIQE patches")
    return np.concatenate([feats_scales[0][:n], feats_scales[1][:n]], axis=1)


def rgb_to_luma(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float [0,1] RGB -> (H, W) BT.601 studio-swing luma in
    [16, 235] — pyiqa's `to_y_channel` convention (the same rgb2ycbcr row
    as `eval.metrics.rgb_to_y`), which basicsr/pyiqa NIQE consumes."""
    return (img @ np.asarray([65.481, 128.553, 24.966])) + 16.0


def fit_niqe_model(images) -> Tuple[np.ndarray, np.ndarray]:
    """Fit the pristine MVG (mu, cov) from an iterable of (H, W, 3) [0,1]
    RGB images (use any HQ face corpus)."""
    # .round() imitates MATLAB's uint8 quantization, as basicsr/pyiqa do
    all_feats = [niqe_features(rgb_to_luma(im).round()) for im in images]
    feats = np.concatenate(all_feats, axis=0)
    mu = np.nanmean(feats, axis=0)
    cov = np.cov(feats[~np.isnan(feats).any(axis=1)].T)
    return mu, cov


def niqe(img: np.ndarray, mu_pris: np.ndarray,
         cov_pris: np.ndarray) -> float:
    """img: (H, W, 3) float [0,1] RGB. Lower = more natural."""
    feats = niqe_features(rgb_to_luma(img).round())
    mu = np.nanmean(feats, axis=0)
    cov = np.cov(feats.T) if feats.shape[0] > 1 else np.zeros_like(cov_pris)
    pooled = (cov_pris + cov) / 2.0
    pinv = np.linalg.pinv(pooled)
    d = mu_pris - mu
    return float(math.sqrt(max(d @ pinv @ d, 0.0)))
