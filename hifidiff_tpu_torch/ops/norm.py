"""Channel LayerNorm for NCHW maps, the fused LayerNorm+FiLM kernels'
dispatch (forward and backward), and GroupNorm+SiLU (counterpart of
hifidiff_tpu/ops/norm.py).

LayerNorm2d semantics follow the reference's hand-rolled op: per pixel,
normalise over the channel axis with the biased variance,
`y = (x - mu) / sqrt(var + eps) * weight + bias`, eps 1e-6, statistics in
float32 and the output in x's dtype.
"""

from __future__ import annotations

import ctypes

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


def ln_film_bwd_plain(g: torch.Tensor, x: torch.Tensor,
                      weight: torch.Tensor, bias: torch.Tensor,
                      scale: torch.Tensor, eps: float = 1e-6,
                      need_wb: bool = True):
    """The backward kernel's plain PyTorch version, the closed form (not
    autograd of `ln_film_plain`): from x and the output's gradient g,
    recomputing mean, rstd and y,

        gw = g * (1 + scale) * w
        dx = rstd * (gw - y * mean_C(gw * y) - mean_C(gw))

    and the float32 sums over the pixels `dw = sum g1 * y`, `db = sum g1`
    (g1 = g * (1 + scale); also summed over the batch),
    `dscale = sum g * (y * w + b)`, `dshift = sum g` (per sample, or summed
    over the batch for a (1, C) FiLM). Returns (dx in x's dtype, dw, db,
    dscale, dshift in float32); dw and db are None without `need_wb`."""
    xf, gf = x.float(), g.float()
    mu = xf.mean(dim=1, keepdim=True)
    var = (xf - mu).square().mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mu) * rstd
    w, b = _chan(weight), _chan(bias)
    g1 = gf * (1.0 + _chan(scale))
    gw = g1 * w
    dx = rstd * (gw - y * (gw * y).mean(dim=1, keepdim=True)
                 - gw.mean(dim=1, keepdim=True))
    dscale = (gf * (y * w + b)).sum(dim=(2, 3))
    dshift = gf.sum(dim=(2, 3))
    if scale.shape[0] == 1 and x.shape[0] > 1:
        dscale = dscale.sum(dim=0, keepdim=True)
        dshift = dshift.sum(dim=0, keepdim=True)
    dw = (g1 * y).sum(dim=(0, 2, 3)) if need_wb else None
    db = g1.sum(dim=(0, 2, 3)) if need_wb else None
    return dx.to(x.dtype), dw, db, dscale, dshift


def _check_ln_film_args(name, x, weight, bias, film_rows):
    """Shapes, dtypes and strides the two ln_film kernels take; returns
    (is_bf16, film_stride)."""
    kernels.check_same_device(name, x, weight, bias, *film_rows)
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous NCHW tensor, got "
                         f"shape {tuple(x.shape)}")
    b, c = x.shape[0], x.shape[1]
    is_bf16 = kernels.dtype_code(x, name)
    tables = (weight, bias, *film_rows)
    if any(t.dtype != x.dtype for t in tables):
        raise TypeError(f"{name}: weight, bias, scale and shift must have "
                        f"x's dtype {x.dtype}, got "
                        f"{[t.dtype for t in tables]}")
    if weight.shape != (c,) or bias.shape != (c,) \
            or not weight.is_contiguous() or not bias.is_contiguous():
        raise ValueError(f"{name}: weight and bias must be contiguous ({c},)")
    first = film_rows[0]
    for t in film_rows:
        if t.dim() != 2 or t.shape[1] != c or t.shape[0] not in (1, b) \
                or t.stride(1) != 1 or t.shape != first.shape \
                or t.stride(0) != first.stride(0):
            raise ValueError(
                f"{name}: scale and shift must be ({b} or 1, {c}) rows with "
                "unit channel stride and one row stride, got "
                f"{[tuple(r.shape) for r in film_rows]}")
    film_stride = first.stride(0) if first.shape[0] == b and b > 1 else 0
    return is_bf16, film_stride


def _ln_film_cuda(x, weight, bias, scale, shift, eps):
    name = "ln_film"
    is_bf16, film_stride = _check_ln_film_args(
        name, x, weight, bias, (scale, shift))
    b, c, h, w = x.shape
    out = torch.empty_like(x)
    kernels.check_aligned(name, x, out)
    lib = kernels.library()
    kernels.check(lib.hifidiff_ln_film(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), out.data_ptr(), b, c, h * w, film_stride,
        float(eps), is_bf16, kernels.stream_ptr(x.device)), name)
    kernels.LAUNCHES[name] += 1
    return out


def _ln_film_bwd_cuda(g, x, weight, bias, scale, eps, need_wb):
    name = "ln_film_bwd"
    is_bf16, film_stride = _check_ln_film_args(
        name, x, weight, bias, (scale,))
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"{name}: g must match x, got {tuple(g.shape)} "
                         f"{g.dtype} on {g.device}")
    g = g.contiguous()
    b, c, h, w = x.shape
    rows = scale.shape[0]
    dx = torch.empty_like(x)
    kernels.check_aligned(name, x, g, dx)
    f32 = dict(dtype=torch.float32, device=x.device)
    dw, db = (torch.empty(c, **f32) for _ in range(2)) if need_wb \
        else (None, None)
    dscale, dshift = (torch.empty(rows, c, **f32) for _ in range(2))
    lib = kernels.library()
    # the partial sums' rows, where the kernel needs them (not zeroed: every
    # row is written before it is read)
    scratch = torch.empty(lib.hifidiff_ln_film_bwd_scratch(
        b, c, h * w, is_bf16, int(need_wb), rows), **f32)
    kernels.check(lib.hifidiff_ln_film_bwd(
        x.data_ptr(), g.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        scale.data_ptr(), dx.data_ptr(), *(
            0 if t is None else t.data_ptr()
            for t in (dw, db, dscale, dshift, scratch)),
        b, c, h * w, film_stride, rows, float(eps), is_bf16, int(need_wb),
        kernels.stream_ptr(x.device)), name)
    kernels.LAUNCHES[name] += 1
    return dx, dw, db, dscale, dshift


def _ln_film_forward(x, weight, bias, scale, shift, eps):
    if kernels.on_cpu("ln_film", x):
        return ln_film_plain(x, weight, bias, scale, shift, eps)
    return _ln_film_cuda(x, weight, bias, scale, shift, eps)


def ln_film_bwd(g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
                need_wb: bool = True):
    """`ln_film`'s backward from x and the output's gradient g; returns what
    `ln_film_bwd_plain` returns. A CPU tensor takes that plain version; a
    CUDA tensor the hand-written kernel (csrc/ln_film_bwd.cu), which raises
    where it cannot run. g may arrive non-contiguous from autograd and is
    made contiguous. The sums over the pixels and the batch are taken in a
    fixed order, without atomics, in at most two device launches and no
    memset: two calls on the same inputs give the same bits."""
    if kernels.on_cpu("ln_film_bwd", x):
        return ln_film_bwd_plain(g, x, weight, bias, scale, eps, need_wb)
    return _ln_film_bwd_cuda(g, x, weight, bias, scale, eps, need_wb)


class _LnFilm(torch.autograd.Function):
    """`ln_film` with its hand-written backward. Saves x, weight, bias and
    scale and nothing else: the backward recomputes the statistics from x,
    as the TPU kernel does. A CPU tensor takes the plain versions, forward
    and backward; a CUDA tensor the two kernels, whose outputs and gradients
    are deterministic (the backward's sums in a fixed order, no atomics)."""

    @staticmethod
    def forward(ctx, x, weight, bias, scale, shift, eps):
        ctx.save_for_backward(x, weight, bias, scale)
        ctx.eps = eps
        return _ln_film_forward(x, weight, bias, scale, shift, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, scale = ctx.saved_tensors
        need_wb = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dx, dw, db, dscale, dshift = ln_film_bwd(g, x, weight, bias, scale,
                                                 ctx.eps, need_wb)
        # float32 sums, cast to the primals' dtypes last
        if need_wb:
            dw, db = dw.to(weight.dtype), db.to(bias.dtype)
        return (dx, dw, db, dscale.to(scale.dtype), dshift.to(scale.dtype),
                None)


def ln_film(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            scale: torch.Tensor, shift: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Fused LayerNorm2d + FiLM with a per-sample (B, C) or shared (1, C)
    scale/shift. A CPU tensor takes the plain version; a CUDA tensor the
    hand-written kernel (csrc/ln_film.cu), which raises where it cannot
    run. Where a gradient is wanted the call is recorded for autograd with
    a hand-written backward (csrc/ln_film_bwd.cu on the card,
    `ln_film_bwd_plain` on the CPU).

    Dtypes: on the card weight, bias, scale and shift have x's dtype, all
    float32 or all bf16 (a module cast as a whole), else the kernels raise.
    Training runs in float32: float32 master weights beside bf16 maps are
    not taken. The backward's sums are float32 and are cast to each table's
    dtype last."""
    if kernels.wants_grad(x, weight, bias, scale, shift):
        return _LnFilm.apply(x, weight, bias, scale, shift, eps)
    return _ln_film_forward(x, weight, bias, scale, shift, eps)


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


def group_norm_silu_plan(shape, dtype, num_groups: int = 32) -> dict:
    """The path the fused kernel takes for an NCHW map of `shape` and
    `dtype`: "on_chip" (each (sample, group) run read from device memory
    once, held in the shared memory of a cluster of blocks) or "streaming"
    (read three times), the cluster's size, the bytes and dynamic shared
    memory of a block, such blocks resident on an SM, and the map's reads.
    Asks the kernel library (the card)."""
    _, c, h, w = shape
    plan = (ctypes.c_int * 6)()
    kernels.library().hifidiff_gn_silu_plan(
        c, h * w, num_groups, int(dtype == torch.bfloat16), plan)
    return {"path": "on_chip" if plan[0] else "streaming",
            "cluster": plan[1], "slice_bytes": plan[2], "smem_bytes": plan[3],
            "blocks_per_sm": plan[4], "reads": plan[5]}


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-6,
                    fused: bool = False) -> torch.Tensor:
    """GroupNorm + per-channel affine + SiLU. `fused=False` (the default) is
    the plain version on any device. `fused=True` is the kernel
    (csrc/gn_silu.cu) for a CUDA tensor, which raises where it cannot run; a
    CPU tensor takes the plain version. The kernel reads the map from device
    memory once where a (sample, group) run fits the shared memory of a
    cluster of blocks (every shape of the SD-VAE's path), else three times
    (`group_norm_silu_plan` says which)."""
    if not fused or x.device.type == "cpu":
        return group_norm_silu_plain(x, weight, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu: unsupported device {x.device}")
    return _group_norm_silu_cuda(x, weight, bias, num_groups, eps)
