"""Affine warp (STN): `affine_grid` + bilinear `grid_sample`, NCHW.

Semantics of the reference STN: `F.affine_grid(theta, size,
align_corners=False)` then `F.grid_sample(x, grid, mode='bilinear',
padding_mode='zeros', align_corners=False)` (counterpart of
hifidiff_tpu/ops/warp.py).

`affine_grid` and `grid_sample` are the reference formulation. The warp the
models call, `affine_warp`, works from the per-sample pixel-space
coefficients of `pixel_coef` and goes through one hand-written CUDA kernel
(csrc/warp.cu) on the card, exact for every theta and map size;
`warp_plain` is that kernel's plain PyTorch version. Its gradient is a
second hand-written kernel (csrc/warp_bwd.cu) with `warp_bwd_plain` beside
it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hifidiff_tpu_torch.ops import kernels


def affine_grid(theta: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(N, 2, 3) theta -> (N, H, W, 2) normalised (x, y) source coordinates
    at the output pixel centres (align_corners=False)."""
    h, w = size
    dev = theta.device
    xs = (2.0 * torch.arange(w, device=dev, dtype=torch.float32) + 1.0) / w - 1.0
    ys = (2.0 * torch.arange(h, device=dev, dtype=torch.float32) + 1.0) / h - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    t = theta.float()
    sx = t[:, 0, 0, None, None] * gx + t[:, 0, 1, None, None] * gy \
        + t[:, 0, 2, None, None]
    sy = t[:, 1, 0, None, None] * gx + t[:, 1, 1, None, None] * gy \
        + t[:, 1, 2, None, None]
    return torch.stack([sx, sy], dim=-1)


def _bilinear(x: torch.Tensor, ix: torch.Tensor,
              iy: torch.Tensor) -> torch.Tensor:
    """Bilinear taps of NCHW x at pixel-space coordinates (N, Ho, Wo), zero
    weight for corners outside the image; float32 math, output x.dtype.
    Each product and sum is rounded in the order the CUDA kernel uses."""
    n, c, h, w = x.shape
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    fx = ix - x0
    fy = iy - y0
    flat = x.float().reshape(n, c, h * w)
    out = None
    for yy, wy in ((y0, 1.0 - fy), (y0 + 1.0, fy)):
        for xx, wx in ((x0, 1.0 - fx), (x0 + 1.0, fx)):
            inside = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
            idx = idx.reshape(n, 1, -1).expand(n, c, -1)
            wt = torch.where(inside, wx * wy, torch.zeros_like(wx))
            tap = torch.gather(flat, 2, idx) * wt.reshape(n, 1, -1)
            out = tap if out is None else out + tap
    return out.reshape(n, c, *ix.shape[1:]).to(x.dtype)


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of NCHW x at a normalised (N, Ho, Wo, 2) grid,
    zero padding, align_corners=False."""
    h, w = x.shape[2], x.shape[3]
    ix = ((grid[..., 0] + 1.0) * w - 1.0) * 0.5
    iy = ((grid[..., 1] + 1.0) * h - 1.0) * 0.5
    return _bilinear(x, ix, iy)


def pixel_coef(theta: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, 2, 3) normalised-coordinate theta -> (N, 6) float32 pixel-space
    coefficients [ax, bx, cx, ay, by, cy] with
    sx(i, j) = ax*j + bx*i + cx and sy(i, j) = ay*j + by*i + cy."""
    t = theta.float()
    gx00 = t[:, 0, 0] * (1.0 / w - 1.0) + t[:, 0, 1] * (1.0 / h - 1.0) \
        + t[:, 0, 2]
    gy00 = t[:, 1, 0] * (1.0 / w - 1.0) + t[:, 1, 1] * (1.0 / h - 1.0) \
        + t[:, 1, 2]
    return torch.stack([
        t[:, 0, 0], t[:, 0, 1] * (w / h), ((gx00 + 1.0) * w - 1.0) * 0.5,
        t[:, 1, 0] * (h / w), t[:, 1, 1], ((gy00 + 1.0) * h - 1.0) * 0.5,
    ], dim=-1)


def warp_plain(x: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: NCHW x warped by (N, 6)
    pixel-space coefficients."""
    n, _, h, w = x.shape
    jj = torch.arange(w, device=x.device, dtype=torch.float32)[None, None, :]
    ii = torch.arange(h, device=x.device, dtype=torch.float32)[None, :, None]
    cf = coef.float()[:, :, None, None]
    sx = cf[:, 0] * jj + cf[:, 1] * ii + cf[:, 2]
    sy = cf[:, 3] * jj + cf[:, 4] * ii + cf[:, 5]
    return _bilinear(x, sx, sy)


def _corners(coef: torch.Tensor, h: int, w: int, device):
    """Per output pixel of an (h, w) map warped by (N, 6) coefficients: the
    four corners' flat source indices (clamped), inside masks, fx, fy and
    the pixel's own (j, i), each (N, h*w) or (1, h*w) float32 / int64."""
    jj = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    ii = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    cf = coef.float()[:, :, None, None]
    sx = cf[:, 0] * jj + cf[:, 1] * ii + cf[:, 2]
    sy = cf[:, 3] * jj + cf[:, 4] * ii + cf[:, 5]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0).flatten(1), (sy - y0).flatten(1)
    idx, inside = [], []
    for yy in (y0, y0 + 1.0):
        for xx in (x0, x0 + 1.0):
            inside.append(((xx >= 0) & (xx <= w - 1) & (yy >= 0)
                           & (yy <= h - 1)).flatten(1))
            idx.append((yy.clamp(0, h - 1) * w
                        + xx.clamp(0, w - 1)).long().flatten(1))
    return idx, inside, fx, fy, jj.expand(1, h, w).flatten(1), \
        ii.expand(1, h, w).flatten(1)


def warp_bwd_plain(g: torch.Tensor, x: torch.Tensor, coef: torch.Tensor,
                   need_dx: bool = True, need_dcoef: bool = True):
    """The backward kernel's plain PyTorch version, the closed form (not
    autograd of `warp_plain`). For the output's gradient g:

      * dx: each output pixel's g added to its four source corners with the
        bilinear weights; a corner outside the image gets nothing;
      * dcoef (N, 6) float32: with v the corner values (zero outside),
        `d out/d sx = (v01 - v00) * (1 - fy) + (v11 - v10) * fy` and
        `d out/d sy = (v10 - v00) * (1 - fx) + (v11 - v01) * fx`, times g,
        times (j, i, 1), summed over channels and pixels. `floor` has
        derivative zero, so at an integer coordinate (fx = 0, the identity
        warp) the slope is that of the cell right of it, as in JAX's
        autodiff of the gather form and in `F.grid_sample`.

    Returns (dx in x's dtype or None, dcoef or None)."""
    n, c, h, w = x.shape
    idx, inside, fx, fy, jj, ii = _corners(coef, h, w, x.device)
    gf = g.float().reshape(n, c, h * w)
    wts = ((1.0 - fx) * (1.0 - fy), fx * (1.0 - fy), (1.0 - fx) * fy, fx * fy)
    dx = dcoef = None
    if need_dx:
        dxf = torch.zeros(n, c, h * w, dtype=torch.float32, device=x.device)
        for k in range(4):
            wt = torch.where(inside[k], wts[k], torch.zeros_like(wts[k]))
            dxf.scatter_add_(2, idx[k][:, None, :].expand(n, c, -1),
                             gf * wt[:, None, :])
        dx = dxf.reshape(x.shape).to(x.dtype)
    if need_dcoef:
        flat = x.float().reshape(n, c, h * w)
        v = [torch.gather(flat, 2, idx[k][:, None, :].expand(n, c, -1))
             * inside[k][:, None, :] for k in range(4)]
        fx, fy = fx[:, None], fy[:, None]
        d_sx = (v[1] - v[0]) * (1.0 - fy) + (v[3] - v[2]) * fy
        d_sy = (v[2] - v[0]) * (1.0 - fx) + (v[3] - v[1]) * fx
        ax = (gf * d_sx).sum(dim=1)      # (N, HW): summed over channels
        ay = (gf * d_sy).sum(dim=1)
        dcoef = torch.stack([(ax * jj).sum(1), (ax * ii).sum(1), ax.sum(1),
                             (ay * jj).sum(1), (ay * ii).sum(1), ay.sum(1)],
                            dim=-1)
    return dx, dcoef


def _check_warp_args(name, x, coef):
    kernels.check_same_device(name, x, coef)
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous NCHW tensor, got "
                         f"shape {tuple(x.shape)}")
    if coef.shape != (x.shape[0], 6) or coef.dtype != torch.float32 \
            or not coef.is_contiguous():
        raise ValueError(f"{name}: coef must be contiguous float32 "
                         f"({x.shape[0]}, 6)")
    return kernels.dtype_code(x, name)


def _warp_cuda(x: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    name = "affine_warp"
    x_bf16 = _check_warp_args(name, x, coef)
    b, c, h, w = x.shape
    out = torch.empty_like(x)
    lib = kernels.library()
    kernels.check(lib.hifidiff_affine_warp(
        x.data_ptr(), coef.data_ptr(), out.data_ptr(), b, c, h, w, x_bf16,
        kernels.stream_ptr(x.device)), name)
    kernels.LAUNCHES[name] += 1
    return out


def _warp_bwd_cuda(g, x, coef, need_dx, need_dcoef):
    name = "affine_warp_bwd"
    x_bf16 = _check_warp_args(name, x, coef)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"{name}: g must match x, got {tuple(g.shape)} "
                         f"{g.dtype} on {g.device}")
    if not (need_dx or need_dcoef):
        return None, None
    g = g.contiguous()
    b, c, h, w = x.shape
    lib = kernels.library()
    dx = torch.empty_like(x) if need_dx else None
    f32 = dict(dtype=torch.float32, device=x.device)
    dcoef = scratch = None
    if need_dcoef:
        # the partial rows of dcoef (not zeroed: every row is written before
        # it is read)
        dcoef = torch.empty((b, 6), **f32)
        scratch = torch.empty(
            lib.hifidiff_affine_warp_bwd_scratch(b, c, h, w), **f32)
    kernels.check(lib.hifidiff_affine_warp_bwd(
        g.data_ptr(), x.data_ptr(), coef.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (dx, dcoef, scratch)),
        b, c, h, w, x_bf16, int(need_dx), int(need_dcoef),
        kernels.stream_ptr(x.device)), name)
    kernels.LAUNCHES[name] += 1
    return dx, dcoef


def _warp_forward(x: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    if kernels.on_cpu("affine_warp", x):
        return warp_plain(x, coef)
    return _warp_cuda(x, coef)


def warp_bwd(g: torch.Tensor, x: torch.Tensor, coef: torch.Tensor,
             need_dx: bool = True, need_dcoef: bool = True):
    """The warp's backward; returns what `warp_bwd_plain` returns. A CPU
    tensor takes that plain version; a CUDA tensor the hand-written kernel
    (csrc/warp_bwd.cu), which raises where it cannot run. There every sum is
    taken in a fixed order in float32, without atomics and without a
    memset: dx gathered per source pixel and rounded once to x's dtype,
    dcoef from per-block partial rows. One device launch (dx alone) or two
    (dcoef), and two calls on the same inputs give the same bits. g may
    arrive non-contiguous from autograd and is made contiguous."""
    if kernels.on_cpu("affine_warp", x):
        return warp_bwd_plain(g, x, coef, need_dx, need_dcoef)
    return _warp_bwd_cuda(g, x, coef, need_dx, need_dcoef)


class _AffineWarp(torch.autograd.Function):
    """The warp with its hand-written backward. Saves x and coef and nothing
    else. A CPU tensor takes the plain versions, forward and backward; a
    CUDA tensor the two kernels."""

    @staticmethod
    def forward(ctx, x, coef):
        ctx.save_for_backward(x, coef)
        return _warp_forward(x, coef)

    @staticmethod
    def backward(ctx, g):
        x, coef = ctx.saved_tensors
        return warp_bwd(g, x, coef, *ctx.needs_input_grad)


def warp(x: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Dispatch on the device: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor (which raises where it cannot run). Where a
    gradient is wanted the call is recorded for autograd with a hand-written
    backward (csrc/warp_bwd.cu on the card, `warp_bwd_plain` on the CPU),
    which gives dx and dcoef; dtheta follows through `pixel_coef`."""
    if kernels.wants_grad(x, coef):
        return _AffineWarp.apply(x, coef)
    return _warp_forward(x, coef)


def affine_warp(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Warp an NCHW map by per-sample (N, 2, 3) affine matrices."""
    return warp(x, pixel_coef(theta, x.shape[2], x.shape[3]))
