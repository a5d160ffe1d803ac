"""Training losses, NCHW (counterpart of hifidiff_tpu/train/losses.py).

  * `cr_loss` = MSE(pred, y) + key-region MSE (reference
    `models/cr/loss.py:4-17`). The key-region term zeroes everything outside
    the facial-component mask (the union over the patch axis of the positive
    patch pixels) and keeps the full tensor size in the denominator: one
    batched masked reduction.
  * `triplet_margin_loss`: `F.triplet_margin_loss`'s defaults (margin 1,
    p 2, eps 1e-6 added inside the distance, mean reduction), written out.
  * `smooth_l1_loss`, `ssim` and `composite_cr_loss`: the terms of the
    reference's optional `CRLoss` (`loss.py:8-67`).

All reduce in float32. Images are (B, C, H, W); patches (B, P, C, H, W).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).square().mean()


def key_region_mask(patches: torch.Tensor) -> torch.Tensor:
    """(B, P, C, H, W) stacked facial-component images -> (B, C, H, W)
    boolean union mask (per channel, over the patch axis)."""
    return patches.sum(dim=1) > 0.0


def key_region_loss(pred: torch.Tensor, target: torch.Tensor,
                    patches: torch.Tensor) -> torch.Tensor:
    mask = key_region_mask(patches).float()
    return ((pred.float() - target.float()) * mask).square().mean()


def cr_loss(pred: torch.Tensor, target: torch.Tensor,
            patches: torch.Tensor) -> torch.Tensor:
    return mse_loss(pred, target) + key_region_loss(pred, target, patches)


def _pairwise_distance(a: torch.Tensor, b: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    return (a - b + eps).square().sum(dim=-1).sqrt()


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor,
                        margin: float = 1.0) -> torch.Tensor:
    """anchor / positive / negative: (B, D) embeddings."""
    d_ap = _pairwise_distance(anchor, positive)
    d_an = _pairwise_distance(anchor, negative)
    return (d_ap - d_an + margin).clamp_min(0.0).mean()


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   beta: float = 1.0) -> torch.Tensor:
    diff = (pred.float() - target.float()).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta).mean()


def ssim(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0,
         filter_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Gaussian-windowed SSIM (Wang et al.) over (B, C, H, W) images, valid
    windows only, mean over everything."""
    c = x.shape[1]
    coords = torch.arange(filter_size, dtype=torch.float32,
                          device=x.device) - filter_size // 2
    g = torch.exp(-coords.square() / (2 * sigma ** 2))
    g = g / g.sum()
    kh = g.reshape(1, 1, filter_size, 1).repeat(c, 1, 1, 1)
    kw = g.reshape(1, 1, 1, filter_size).repeat(c, 1, 1, 1)

    def blur(img):  # separable, depthwise
        return F.conv2d(F.conv2d(img, kh, groups=c), kw, groups=c)

    x, y = x.float(), y.float()
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    mu_x, mu_y = blur(x), blur(y)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = blur(x * x) - mu_x2
    sig_y = blur(y * y) - mu_y2
    sig_xy = blur(x * y) - mu_xy
    num = (2 * mu_xy + c1) * (2 * sig_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2)
    return (num / den).mean()


def composite_cr_loss(pred: torch.Tensor, target: torch.Tensor,
                      patches: Optional[torch.Tensor] = None, *,
                      lambda_pix: float = 1.0, lambda_ssim: float = 0.0,
                      lambda_vgg: float = 0.0,
                      vgg_features_fn: Optional[Callable] = None
                      ) -> torch.Tensor:
    """The reference's weighted `CRLoss` (`loss.py:40-67`): smooth-L1 pixel +
    key-region smooth-L1, optional (1 - SSIM), optional smooth-L1 between
    the features `vgg_features_fn` gives for pred and target, both taken
    without gradient as the reference takes them."""
    loss = smooth_l1_loss(pred, target)
    if patches is not None:
        mask = key_region_mask(patches).float()
        loss = loss + smooth_l1_loss(pred * mask, target * mask)
    total = lambda_pix * loss
    if lambda_ssim > 0.0:
        total = total + lambda_ssim * (1.0 - ssim(pred, target))
    if lambda_vgg > 0.0 and vgg_features_fn is not None:
        with torch.no_grad():
            fp, ft = vgg_features_fn(pred), vgg_features_fn(target)
        total = total + lambda_vgg * smooth_l1_loss(fp, ft)
    return total
