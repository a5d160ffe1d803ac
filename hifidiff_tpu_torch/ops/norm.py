"""Channel LayerNorm for NCHW maps, the fused LayerNorm+FiLM kernel's
dispatch, and GroupNorm+SiLU (counterpart of hifidiff_tpu/ops/norm.py).

LayerNorm2d semantics follow the reference's hand-rolled op: per pixel,
normalise over the channel axis with the biased variance,
`y = (x - mu) / sqrt(var + eps) * weight + bias`, eps 1e-6, statistics in
float32 and the output in x's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hifidiff_tpu_torch.ops import kernels


def _normalize_f32(x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=1, keepdim=True)
    var = (xf - mu).square().mean(dim=1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps)


def _chan(v: torch.Tensor) -> torch.Tensor:
    """(C,) or (B, C) -> broadcastable over (B, C, H, W), float32."""
    return v.float().reshape(v.shape[0] if v.dim() == 2 else 1, -1, 1, 1)


def layer_norm_2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Normalise the channel axis (dim 1) of an NCHW tensor."""
    y = _normalize_f32(x, eps) * _chan(weight) + _chan(bias)
    return y.to(x.dtype)


def ln_film_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  scale: torch.Tensor, shift: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """The kernel's plain PyTorch version:
    `(LN(x) * w + b) * (1 + scale) + shift`, scale/shift (B or 1, C)."""
    y = _normalize_f32(x, eps) * _chan(weight) + _chan(bias)
    return (y * (1.0 + _chan(scale)) + _chan(shift)).to(x.dtype)


def _ln_film_cuda(x, weight, bias, scale, shift, eps):
    name = "ln_film"
    kernels.check_launchable(name, x, weight, bias, scale, shift)
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous NCHW tensor, got "
                         f"shape {tuple(x.shape)}")
    b, c, h, w = x.shape
    is_bf16 = kernels.dtype_code(x, name)
    for t in (weight, bias, scale, shift):
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: weight, bias, scale and shift must "
                            f"have x's dtype {x.dtype}, got {t.dtype}")
    if weight.shape != (c,) or bias.shape != (c,) \
            or not weight.is_contiguous() or not bias.is_contiguous():
        raise ValueError(f"{name}: weight and bias must be contiguous ({c},)")
    if scale.dim() != 2 or scale.shape[1] != c or scale.shape != shift.shape \
            or scale.shape[0] not in (1, b) or scale.stride(1) != 1 \
            or shift.stride(1) != 1 or scale.stride(0) != shift.stride(0):
        raise ValueError(f"{name}: scale and shift must be ({b} or 1, {c}) "
                         "rows with unit channel stride and one row stride, "
                         f"got {tuple(scale.shape)} / {tuple(shift.shape)}")
    film_stride = scale.stride(0) if scale.shape[0] == b and b > 1 else 0
    out = torch.empty_like(x)
    lib = kernels.library()
    kernels.check(lib.hifidiff_ln_film(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), out.data_ptr(), b, c, h * w, film_stride,
        float(eps), is_bf16, kernels.stream_ptr(x.device)), name)
    kernels.LAUNCHES[name] += 1
    return out


def ln_film(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            scale: torch.Tensor, shift: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Fused LayerNorm2d + FiLM with a per-sample (B, C) or shared (1, C)
    scale/shift. A CPU tensor takes the plain version; a CUDA tensor the
    hand-written kernel (csrc/ln_film.cu), which raises where it cannot
    run."""
    if x.device.type == "cpu":
        return ln_film_plain(x, weight, bias, scale, shift, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_film: unsupported device {x.device}")
    return _ln_film_cuda(x, weight, bias, scale, shift, eps)


def _group_norm_f32(x, weight, bias, num_groups, eps):
    return F.group_norm(x.float(), num_groups, weight.float(), bias.float(),
                        eps)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm with float32 statistics, output in x's dtype."""
    return _group_norm_f32(x, weight, bias, num_groups, eps).to(x.dtype)


def group_norm_silu_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, num_groups: int = 32,
                          eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm (float32 statistics) + per-channel affine + SiLU, the
    SD-VAE block prologue, in plain PyTorch: the default path, and the
    fused kernel's plain version."""
    y = _group_norm_f32(x, weight, bias, num_groups, eps)
    return F.silu(y).to(x.dtype)


def _group_norm_silu_cuda(x, weight, bias, num_groups, eps):
    name = "group_norm_silu"
    kernels.check_launchable(name, x, weight, bias)
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous NCHW tensor, got "
                         f"shape {tuple(x.shape)}")
    b, c, h, w = x.shape
    is_bf16 = kernels.dtype_code(x, name)
    if weight.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(f"{name}: weight and bias must have x's dtype "
                        f"{x.dtype}, got {weight.dtype} / {bias.dtype}")
    if weight.shape != (c,) or bias.shape != (c,) \
            or not weight.is_contiguous() or not bias.is_contiguous():
        raise ValueError(f"{name}: weight and bias must be contiguous ({c},)")
    if num_groups < 1 or c % num_groups or b == 0:
        raise ValueError(f"{name}: {c} channels do not split into "
                         f"{num_groups} groups, or the batch is empty")
    kernels.check_aligned(name, x)
    out = torch.empty_like(x)
    lib = kernels.library()
    kernels.check(lib.hifidiff_gn_silu(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
        c, h * w, num_groups, float(eps), is_bf16,
        kernels.stream_ptr(x.device)), name)
    kernels.LAUNCHES[name] += 1
    return out


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-6,
                    fused: bool = False) -> torch.Tensor:
    """GroupNorm + per-channel affine + SiLU. `fused=False` (the default) is
    the plain version on any device. `fused=True` is the one-pass kernel
    (csrc/gn_silu.cu) for a CUDA tensor, which raises where it cannot run; a
    CPU tensor takes the plain version."""
    if not fused or x.device.type == "cpu":
        return group_norm_silu_plain(x, weight, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu: unsupported device {x.device}")
    return _group_norm_silu_cuda(x, weight, bias, num_groups, eps)
