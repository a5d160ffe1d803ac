"""One whole ConditionalNAFBlock on a 1x1 or 2x2 map in one call
(counterpart of hifidiff_tpu/ops/pallas/naf_block.py).

At 16x16 latents the denoiser's enc3 / dec0 stages run at 2x2 and its middle
blocks at 1x1, where a block degenerates to five matrix products on
`(M = B * sp, C)` rows (sp = H * W) chained through cheap per-row work: the
3x3 depthwise convolution becomes an `(sp, sp)` per-channel position mix
(zero-padding taps drop out) and SCA's global pool a mean over the sp rows of
each sample. `fused_cnaf_block_small` computes the block from the rows, the
step's batch-1 FiLM row and a `CnafPack` of the block's weights:

    h   = dt(LN(x) * w1a + b1a)          LN affine and FiLM folded
    t1  = (h @ W1) * s1 + bias1          s* = int8 scales (1 for float)
    t1  = mix(t1) + dw_bias
    u   = t1[:, :C] * t1[:, C:]          SimpleGate
    g   = (dt(mean_sp u) @ Wsca) * s_sca + b_sca
    y1  = x + ((dt(u * g) @ W3) * s3 + b3) * beta
    h2  = dt(LN(y1) * w2a + b2a)
    t4  = (h2 @ W4) * s4 + b4
    out = dt(y1 + ((dt(t4[:, :C] * t4[:, C:]) @ W5) * s5 + b5) * gamma)

with float32 accumulation and `dt(.)` the rounding to the I/O dtype where an
activation enters a product. Inference only.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from hifidiff_tpu_torch.ops import kernels

# rows of CnafPack.vec_c
_BETA, _GAMMA, _S_SCA, _B_SCA, _S3, _B3, _S5, _B5 = range(8)


class CnafPack(NamedTuple):
    """A block's weights in the layout the fused block reads; everything
    that does not depend on the step, so a block packs once and keeps it
    (`ConditionalNAFBlock.fused_pack`)."""
    hw: int                  # the map's side: 1 or 2
    ln: torch.Tensor         # (4, C) I/O dtype: norm1 w, b, norm2 w, b
    vec_c: torch.Tensor      # (8, C) f32: beta, gamma, s_sca, b_sca, s3,
                             # b3, s5, b5
    vec_2c: torch.Tensor     # (5, 2C) f32: s1, b1, s4, b4, dw_bias
    vec_dw: torch.Tensor     # (hw^4, 2C) f32 position-mix taps
    weights: Tuple[torch.Tensor, ...]  # W1, Wsca, W3, W4, W5 as (cout,
    # cin): all int8 (scales in the s* rows) or all in the I/O dtype


def _affine(conv) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A 1x1 conv module (float or int8) -> (W (cout, cin), scale (cout,),
    bias (cout,)), scale == 1 for a float weight."""
    if hasattr(conv, "weight_q"):
        w, scale = conv.weight_q, conv.weight_scale.float()
    else:
        w = conv.weight
        scale = torch.ones(w.shape[0], dtype=torch.float32, device=w.device)
    bias = conv.bias
    bias = torch.zeros_like(scale) if bias is None else bias.float()
    return w.reshape(w.shape[0], -1), scale, bias


def pack_cnaf_block(*, ln1, ln2, conv1, conv2, sca_conv, conv3, conv4,
                    conv5, beta: torch.Tensor, gamma: torch.Tensor, hw: int,
                    dtype: torch.dtype) -> CnafPack:
    """ln1 / ln2: (weight, bias) tensors; conv*: the block's conv modules
    (`nn.Conv2d`, or `Conv2dW8` after quantization); conv2 is the 3x3
    depthwise convolution; `hw` the map's side and `dtype` the I/O dtype."""
    mats, scales, biases = map(list, zip(*(
        _affine(m) for m in (conv1, sca_conv, conv3, conv4, conv5))))
    int8 = [w.dtype == torch.int8 for w in mats]
    for j, w in enumerate(mats):
        # the block streams all five matrices with one dtype: if the w8 size
        # threshold split it, dequantize the int8 minority
        if int8[j] and not all(int8):
            mats[j] = (w.float() * scales[j][:, None]).to(dtype)
            scales[j] = torch.ones_like(scales[j])
        elif not int8[j]:
            mats[j] = w.to(dtype)
    if hasattr(conv2, "weight_q"):  # only when the size threshold is forced
        dwk = conv2.weight_q.float() * conv2.weight_scale[:, None, None, None]
    else:
        dwk = conv2.weight.float()
    dwk = dwk[:, 0]                                        # (2C, 3, 3)
    # position-mix taps: mix[p, q] = dwk[1 + qy - py, 1 + qx - px]
    taps = [dwk[:, 1 + qy - py, 1 + qx - px]
            for py in range(hw) for px in range(hw)
            for qy in range(hw) for qx in range(hw)]
    s1, ssca, s3, s4, s5 = scales
    b1, bsca, b3, b4, b5 = biases
    return CnafPack(
        hw=hw,
        ln=torch.stack([*ln1, *ln2]).to(dtype).contiguous(),
        vec_c=torch.stack([beta.float().flatten(), gamma.float().flatten(),
                           ssca, bsca, s3, b3, s5, b5]).contiguous(),
        vec_2c=torch.stack([s1, b1, s4, b4, conv2.bias.float()]).contiguous(),
        vec_dw=torch.stack(taps).contiguous(),
        weights=tuple(w.contiguous() for w in mats))


def _layer_norm(x: torch.Tensor, wa: torch.Tensor, ba: torch.Tensor,
                eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * wa + ba


def _rows(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b * h * w, c)


def _nchw(rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    b, c, h, w = like.shape
    return rows.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous()


def fused_cnaf_block_small_plain(x: torch.Tensor, film: torch.Tensor,
                                 pack: CnafPack,
                                 eps: float = 1e-6) -> torch.Tensor:
    """The kernel's plain PyTorch version: its arithmetic step by step on
    `(M, C)` rows, rounding to x's dtype where the kernel does."""
    b, c, hh, _ = x.shape
    sp, dt = hh * hh, x.dtype
    w1, wsca, w3, w4, w5 = pack.weights
    shift_a, scale_a, shift_f, scale_f = film.float()[0].chunk(4)
    ln = pack.ln.float()
    ln1_w, ln1_b = ln[0] * (1.0 + scale_a), ln[1] * (1.0 + scale_a) + shift_a
    ln2_w, ln2_b = ln[2] * (1.0 + scale_f), ln[3] * (1.0 + scale_f) + shift_f
    vc = pack.vec_c
    s1, b1, s4, b4, dwb = pack.vec_2c

    def mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return a.float() @ w.float().t()      # float32 accumulation

    xf = _rows(x).float()                                       # (M, C)
    h = _layer_norm(xf, ln1_w, ln1_b, eps).to(dt)
    t1 = (mm(h, w1) * s1 + b1).reshape(b, sp, 2 * c)
    mix = pack.vec_dw.reshape(sp, sp, 2 * c)
    t1 = (mix[None] * t1[:, None]).sum(dim=2) + dwb             # (B, sp, 2C)
    u = t1[..., :c] * t1[..., c:]                               # SimpleGate
    pooled = u.mean(dim=1).to(dt)
    gate = mm(pooled, wsca) * vc[_S_SCA] + vc[_B_SCA]           # (B, C)
    u = (u * gate[:, None]).reshape(b * sp, c).to(dt)
    y1 = xf + (mm(u, w3) * vc[_S3] + vc[_B3]) * vc[_BETA]
    h2 = _layer_norm(y1, ln2_w, ln2_b, eps).to(dt)
    t4 = mm(h2, w4) * s4 + b4
    u2 = (t4[:, :c] * t4[:, c:]).to(dt)
    out = y1 + (mm(u2, w5) * vc[_S5] + vc[_B5]) * vc[_GAMMA]
    return _nchw(out.to(dt), x)


def scratch_floats(m: int, b: int, c: int) -> int:
    """The float32 words of scratch the kernel chain needs for (m, c) rows of
    b samples: u and y1 (m, c) in float32, the normed rows and the gated rows
    (m, c) in bf16 (each buffer serves both halves of the block), and the
    pooled rows (b, c) in bf16. Every buffer starts 16-byte aligned while
    c % 8 == 0 (the wrapper asks for c % 128 == 0)."""
    return 3 * m * c + b * c // 2


def _fused_cuda(x, film, pack, eps):
    name = "cnaf_small"
    kernels.check_launchable(name, x, film, pack.ln, pack.vec_c, pack.vec_2c,
                             pack.vec_dw, *pack.weights)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16 maps only, "
                        f"got {x.dtype}")
    if x.dim() != 4 or x.shape[2] != x.shape[3] \
            or x.shape[2] != pack.hw or pack.hw not in (1, 2):
        raise ValueError(f"{name}: x must be a (B, C, {pack.hw}, {pack.hw}) "
                         f"map, got {tuple(x.shape)}")
    b, c = x.shape[0], x.shape[1]
    sp = pack.hw * pack.hw
    if c % 128 or not 128 <= c <= 2048 or b == 0:
        raise ValueError(f"{name}: needs C % 128 == 0, 128 <= C <= 2048 and "
                         f"a non-empty batch, got B={b} C={c}")
    if film.shape != (1, 4 * c) or film.dtype != x.dtype \
            or film.stride(1) != 1:
        raise ValueError(f"{name}: film must be a (1, {4 * c}) row of "
                         f"{x.dtype}, got {tuple(film.shape)} {film.dtype}")
    wdt = pack.weights[0].dtype
    shapes = [(2 * c, c), (c, c), (c, c), (2 * c, c), (c, c)]
    if wdt not in (torch.int8, torch.bfloat16) or any(
            w.dtype != wdt or tuple(w.shape) != s or not w.is_contiguous()
            for w, s in zip(pack.weights, shapes)):
        raise ValueError(f"{name}: the five weights must be contiguous "
                         f"{shapes}, all int8 or all bfloat16")
    for t, shape, dtype in ((pack.ln, (4, c), x.dtype),
                            (pack.vec_c, (8, c), torch.float32),
                            (pack.vec_2c, (5, 2 * c), torch.float32),
                            (pack.vec_dw, (sp * sp, 2 * c), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name}: packed vector {tuple(t.shape)} "
                             f"{t.dtype} is not contiguous {shape} {dtype}")
    rows = _rows(x).contiguous()
    kernels.check_aligned(name, rows, film, pack.ln, pack.vec_c, pack.vec_2c,
                          pack.vec_dw, *pack.weights)
    m = b * sp
    out = torch.empty_like(rows)
    scratch = torch.empty(scratch_floats(m, b, c), dtype=torch.float32,
                          device=x.device)
    lib = kernels.library()
    kernels.check(lib.hifidiff_cnaf_small(
        rows.data_ptr(), out.data_ptr(), pack.ln.data_ptr(), film.data_ptr(),
        pack.vec_c.data_ptr(), pack.vec_2c.data_ptr(),
        pack.vec_dw.data_ptr(), *(w.data_ptr() for w in pack.weights),
        scratch.data_ptr(), m, c, sp, int(wdt == torch.int8), float(eps),
        kernels.stream_ptr(x.device)), name)
    kernels.LAUNCHES[name] += 1
    return _nchw(out, x)


def fused_cnaf_block_small(x: torch.Tensor, film: torch.Tensor,
                           pack: CnafPack, eps: float = 1e-6) -> torch.Tensor:
    """One fused ConditionalNAFBlock on a (B, C, H, W) map with H = W in
    {1, 2}. film: (1, 4C) [shift_att, scale_att, shift_ffn, scale_ffn], the
    hoisted batch-1 FiLM row of this step. A CPU tensor takes the plain
    version; a CUDA tensor the hand-written kernel chain
    (csrc/cnaf_small.cu: bf16 maps, bf16 or int8 weights), which raises
    where it cannot run. The NCHW <-> rows layout change is part of the
    call."""
    if x.device.type == "cpu":
        return fused_cnaf_block_small_plain(x, film, pack, eps)
    if x.device.type != "cuda":
        raise ValueError(f"cnaf_small: unsupported device {x.device}")
    return _fused_cuda(x, film, pack, eps)
