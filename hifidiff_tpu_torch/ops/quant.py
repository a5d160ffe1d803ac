"""Int8 weight quantization for inference (w8: int8 weights, bf16 compute;
counterpart of hifidiff_tpu/ops/quant.py).

Scheme: symmetric per-output-channel int8 weights with float32 scales. 1x1
convolutions and linear layers whose shapes fit the kernel run through
`matmul_w8` (csrc/matmul_w8.cu): the weights stay int8 in device memory and
the scale is applied to the float32 accumulator, which equals
dequantize-then-matmul without the rounding of `w_q * scale`. Everything
else (3x3, strided, grouped or padded convolutions; `cin % 32` or
`cout % 128`) dequantizes and calls the plain convolution or matmul: those
layers carry few weight bytes.

Weights here are in PyTorch's layout, output channel first: `(cout, cin)` for
a linear layer, `(cout, cin / groups, kh, kw)` for a convolution. The JAX
package keeps them `(..., cout)`; `convert.py` transposes.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from hifidiff_tpu_torch.ops import kernels

# Quantize a layer only when its weight is large enough that streaming it
# dominates its cost: 1M parameters = the 1024-channel 1x1 convolutions, which
# keeps every product of the enc3 / mid / dec0 blocks uniformly int8 (the
# fused NAF block streams a block's five matrices with one dtype).
W8_MIN_WEIGHT_PARAMS = 1 << 20


def w8_layer_eligible(weight_params: int) -> bool:
    return weight_params >= W8_MIN_WEIGHT_PARAMS


def quantize_weight_per_cout(weight: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """weight (cout, ...) -> (int8 weight, (cout,) float32 scales):
    `scale = max(amax, 1e-8) / 127`, `q = clip(round_half_even(w / scale))`,
    all in float32."""
    w = weight.detach().float()
    amax = w.abs().flatten(1).amax(dim=1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.round(w / scale.reshape(-1, *([1] * (w.dim() - 1))))
    return q.clamp(-127, 127).to(torch.int8), scale


def dequantize(weight_q: torch.Tensor, weight_scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    shape = (-1, *([1] * (weight_q.dim() - 1)))
    return (weight_q.float() * weight_scale.float().reshape(shape)).to(dtype)


def matmul_w8_plain(x: torch.Tensor, weight_q: torch.Tensor,
                    weight_scale: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: `(x @ weight_q.T) * scale` with a
    float32 product (exact inputs: bf16 or f32 activations, int8 weights)
    and the scale on the float32 result, output in x's dtype."""
    acc = x.float() @ weight_q.float().t()
    return (acc * weight_scale.float()).to(x.dtype)


def _matmul_w8_cuda(x, weight_q, weight_scale):
    name = "matmul_w8"
    kernels.check_launchable(name, x, weight_q, weight_scale)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16 activations "
                        f"only, got {x.dtype}")
    if weight_q.dtype != torch.int8 or weight_scale.dtype != torch.float32:
        raise TypeError(f"{name}: weight_q must be int8 and weight_scale "
                        f"float32, got {weight_q.dtype} / "
                        f"{weight_scale.dtype}")
    if x.dim() != 2 or weight_q.dim() != 2 or not x.is_contiguous() \
            or not weight_q.is_contiguous() \
            or not weight_scale.is_contiguous():
        raise ValueError(f"{name}: x (M, K) and weight_q (N, K) must be "
                         "contiguous matrices")
    (m, k), n = x.shape, weight_q.shape[0]
    if weight_q.shape[1] != k or weight_scale.shape != (n,):
        raise ValueError(f"{name}: shapes {tuple(x.shape)} x "
                         f"{tuple(weight_q.shape)}, scale "
                         f"{tuple(weight_scale.shape)} do not match")
    if k % 32 or n % 128 or m == 0:
        raise ValueError(f"{name}: needs K % 32 == 0, N % 128 == 0 and "
                         f"M > 0, got M={m} K={k} N={n}")
    kernels.check_aligned(name, x, weight_q, weight_scale)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = kernels.library()
    kernels.check(lib.hifidiff_matmul_w8(
        x.data_ptr(), weight_q.data_ptr(), weight_scale.data_ptr(),
        out.data_ptr(), m, k, n, kernels.stream_ptr(x.device)), name)
    kernels.LAUNCHES[name] += 1
    return out


def matmul_w8(x: torch.Tensor, weight_q: torch.Tensor,
              weight_scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ weight_q (N, K) int8, transposed, times the per-column
    float32 scale -> (M, N) in x's dtype. A CPU tensor takes the plain
    version; a CUDA tensor the hand-written kernel (bf16 activations,
    K % 32 == 0, N % 128 == 0), which raises where it cannot run."""
    if x.device.type == "cpu":
        return matmul_w8_plain(x, weight_q, weight_scale)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_w8: unsupported device {x.device}")
    return _matmul_w8_cuda(x, weight_q, weight_scale)


def dense_w8(x: torch.Tensor, weight_q: torch.Tensor,
             weight_scale: torch.Tensor) -> torch.Tensor:
    """x (..., cin) with weight_q (cout, cin) int8 -> (..., cout)."""
    cout, cin = weight_q.shape
    if cin % 32 or cout % 128:
        # below the kernel's tile granularity, by the JAX package's own
        # rule: a dequantized plain matmul (negligible weight bytes)
        return x @ dequantize(weight_q, weight_scale, x.dtype).t()
    y = matmul_w8(x.reshape(-1, cin), weight_q, weight_scale)
    return y.reshape(*x.shape[:-1], cout)


def conv_w8(x: torch.Tensor, weight_q: torch.Tensor,
            weight_scale: torch.Tensor, stride=(1, 1), padding=(0, 0),
            groups: int = 1) -> torch.Tensor:
    """NCHW convolution with int8-resident weights, weight_q OIHW int8.

    1x1 / stride 1 / ungrouped / unpadded convolutions (the weight-heavy
    ones) go to the matmul on (B*H*W, cin) rows; the NCHW <-> rows layout
    change is part of this call. Everything else dequantizes and calls the
    plain convolution."""
    cout, _, kh, kw = weight_q.shape
    if kh == kw == 1 and groups == 1 and tuple(stride) == (1, 1) \
            and tuple(padding) == (0, 0):
        b, cin, h, w = x.shape
        rows = x.permute(0, 2, 3, 1).reshape(b * h * w, cin)
        y = dense_w8(rows, weight_q.reshape(cout, cin), weight_scale)
        return y.reshape(b, h, w, cout).permute(0, 3, 1, 2).contiguous()
    return F.conv2d(x, dequantize(weight_q, weight_scale, x.dtype), None,
                    stride, padding, 1, groups)
