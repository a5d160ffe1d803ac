"""Bicubic resize with torch `F.interpolate(mode="bicubic")` semantics, as
two matrix products (counterpart of hifidiff_tpu/ops/resize.py).

Resizing H_in -> H_out is a precomputed (H_out, H_in) cubic weight matrix;
a 2D resize is one product along H and one along W. Index convention:
src = (dst + 0.5) * (in/out) - 0.5, a = -0.75, taps clamped to the border
(replicate), no antialias, values not clamped: torch's
`upsample_bicubic2d` with `align_corners=False`.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0,
                 a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0))


@functools.lru_cache(maxsize=None)
def resize_matrix(in_size: int, out_size: int,
                  a: float = -0.75) -> np.ndarray:
    """(out_size, in_size) row-stochastic cubic interpolation matrix,
    float32."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in range(-1, 3):
        idx = np.clip(base + tap, 0, in_size - 1)
        np.add.at(mat, (dst.astype(np.int64), idx),
                  _cubic_kernel(np.asarray(tap) - frac, a))
    return mat.astype(np.float32)


def resize_bicubic_torch(x: torch.Tensor,
                         out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bicubic-resize an (..., C, H, W) tensor (NCHW) to (..., C, H', W'),
    as `F.interpolate(x, out_hw, mode="bicubic", align_corners=False)`
    computes it, on x's device and in x's dtype."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    mh = torch.from_numpy(resize_matrix(h, oh)).to(x.device, x.dtype)
    mw = torch.from_numpy(resize_matrix(w, ow)).to(x.device, x.dtype)
    return torch.matmul(torch.matmul(mh, x), mw.t())
