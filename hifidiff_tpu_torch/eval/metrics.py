"""Evaluation metrics in torch (counterpart of hifidiff_tpu/eval/metrics.py).

Images are NHWC tensors, as in the JAX package, on any device; the results
are float32 tensors on the images' device. `psnr_pyiqa` / `ssim_pyiqa` are
the pyiqa pipelines the reference's reported numbers come from
(`test_refiner.py:107-120`), and `reference_eval_metrics` is the reference's
eval convention end to end (batch-global min-max normalization of prediction
and ground truth, then both metrics).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Mean PSNR over the batch, NHWC in [0, max_val]."""
    mse = (pred.float() - target.float()).square().mean(dim=(1, 2, 3))
    return (20.0 * math.log10(max_val) - 10.0 * torch.log10(mse)).mean()


def rgb_to_y(x: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma: NHWC RGB in [0,1] -> (N,H,W,1) Y in [16, 235], the
    MATLAB `rgb2ycbcr` studio-swing transform that pyiqa's
    `to_y_channel(img, 255., 'ycbcr')` applies:
    Y = 65.481 R + 128.553 G + 24.966 B + 16 with R, G, B in [0, 1]."""
    x = x.float()
    return (65.481 * x[..., 0:1] + 128.553 * x[..., 1:2]
            + 24.966 * x[..., 2:3] + 16.0)


def psnr_pyiqa(pred: torch.Tensor, target: torch.Tensor,
               test_y_channel: bool = False) -> torch.Tensor:
    """Per-image PSNR, pyiqa's `psnr` (pyiqa/archs/psnr_arch.py): NHWC in
    [0, 1]; with test_y_channel=False (pyiqa's default for 'psnr') the MSE is
    over RGB with data_range 1, with True over BT.601 Y with data_range 255.
    Returns (B,) scores; the reference means them."""
    eps = 1e-8
    if test_y_channel:
        pred, target = rgb_to_y(pred), rgb_to_y(target)
        data_range = 255.0
    else:
        data_range = 1.0
    mse = (pred.float() - target.float()).square().mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(data_range ** 2 / (mse + eps))


def _fspecial_gauss(size: int, sigma: float,
                    device=None) -> torch.Tensor:
    """MATLAB fspecial('gaussian', size, sigma), normalized (size, size)."""
    coords = torch.arange(size, dtype=torch.float32,
                          device=device) - (size - 1) / 2.0
    g = torch.exp(-coords.square() / (2.0 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim_pyiqa(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-image SSIM, pyiqa's 'ssim' (pyiqa/archs/ssim_arch.py, the Wang et
    al. MATLAB ssim.m): NHWC RGB in [0, 1] -> BT.601 Y in [0, 255]; f x f
    mean-pooling with f = max(1, round(min(H, W) / 256)) when f > 1; an 11x11
    Gaussian window, sigma 1.5, in VALID mode; C1 = (0.01*255)^2,
    C2 = (0.03*255)^2. Returns (B,) scores."""
    x = rgb_to_y(pred).permute(0, 3, 1, 2)
    y = rgb_to_y(target).permute(0, 3, 1, 2)
    h, w = x.shape[2], x.shape[3]
    f = max(1, round(min(h, w) / 256))
    if f > 1:
        x, y = F.avg_pool2d(x, f, f), F.avg_pool2d(y, f, f)
    win = _fspecial_gauss(11, 1.5, x.device)[None, None]

    def blur(img):
        return F.conv2d(img, win)

    c1 = (0.01 * 255.0) ** 2
    c2 = (0.03 * 255.0) ** 2
    mu_x, mu_y = blur(x), blur(y)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = blur(x * x) - mu_x2
    sig_y = blur(y * y) - mu_y2
    sig_xy = blur(x * y) - mu_xy
    ssim_map = ((2 * mu_xy + c1) * (2 * sig_xy + c2)) / \
        ((mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2))
    return ssim_map.mean(dim=(1, 2, 3))


def min_max_normalize(x: torch.Tensor, per_sample: bool = True,
                      group=None) -> torch.Tensor:
    """Min-max to [0, 1], applied to prediction and ground truth before the
    metrics (`test_refiner.py:113-119`). The reference's `result.min()` is
    the min over the WHOLE batch tensor: per_sample=False replicates that
    (the eval CLI does); per_sample=True normalizes each image on its own.
    With per_sample=False and a data-parallel `group` the min and max are
    the global batch's."""
    x = x.float()
    dims = (1, 2, 3) if per_sample else (0, 1, 2, 3)
    lo = x.amin(dim=dims, keepdim=True)
    hi = x.amax(dim=dims, keepdim=True)
    if group is not None and not per_sample:
        from hifidiff_tpu_torch.parallel.distributed import gather_rows

        every = gather_rows(torch.stack([lo.reshape(()), hi.reshape(())])
                            [None], group)
        lo = every[:, 0].amin().reshape(lo.shape)
        hi = every[:, 1].amax().reshape(hi.shape)
    return (x - lo) / (hi - lo).clamp_min(1e-12)


def reference_eval_metrics(pred: torch.Tensor, gt: torch.Tensor, group=None
                           ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                      torch.Tensor]:
    """The reference's eval convention: batch-global min-max normalization
    of prediction and ground truth (`test_refiner.py:113-119`), then pyiqa
    'psnr' (per image, RGB, data range 1, batch mean) and pyiqa 'ssim'
    (BT.601 Y). Returns ({"psnr", "ssim"}, pred_n, gt_n). With a
    data-parallel `group` each process holds its rows of the batch: the
    normalization takes the global batch's min and max and the means are
    the global batch's (each process's rows count once), as the JAX
    package computes them over its process-sharded batch."""
    pred_n = min_max_normalize(pred, per_sample=False, group=group)
    gt_n = min_max_normalize(gt, per_sample=False, group=group)
    psnr_s, ssim_s = psnr_pyiqa(pred_n, gt_n), ssim_pyiqa(pred_n, gt_n)
    if group is None:
        return ({"psnr": psnr_s.mean(), "ssim": ssim_s.mean()}, pred_n,
                gt_n)
    from hifidiff_tpu_torch.parallel.distributed import global_means

    return (global_means({"psnr": psnr_s.mean(), "ssim": ssim_s.mean()},
                         len(psnr_s), group), pred_n, gt_n)


def identity_cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of (B, D) identity embeddings -> (B,)."""
    a = a / a.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    b = b / b.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return (a * b).sum(dim=-1)


def identity_verification_accuracy(anchor: torch.Tensor,
                                   positive: torch.Tensor,
                                   negative: torch.Tensor) -> torch.Tensor:
    """Fraction of samples where cos(anchor, positive) > cos(anchor,
    negative) (`test_idc.py:23-39`)."""
    sim_pos = identity_cosine(anchor, positive)
    sim_neg = identity_cosine(anchor, negative)
    return (sim_pos > sim_neg).float().mean()
