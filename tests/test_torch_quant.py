"""The port's int8-weight path against the JAX package's (float32, CPU):
the quantizer bit for bit, `matmul_w8_plain` against the Pallas kernel in
interpret mode, `dense_w8` / `conv_w8` on every route, and the `LinearW8` /
`Conv2dW8` modules against `TorchDense` / `TorchConv` applied with a
quantized tree. The JAX package keeps kernels `(..., cout)`, the port
`(cout, ...)`: the tests transpose."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from hifidiff_tpu.nn.layers import TorchConv, TorchDense
from hifidiff_tpu.ops import quant as jquant
from hifidiff_tpu.ops.pallas.int8_matmul import matmul_w8 as j_matmul_w8
from hifidiff_tpu_torch.nn.layers import (Conv2dW8, LinearW8, compute_dtype,
                                          quantize_module_)
from hifidiff_tpu_torch.ops import quant
from torch_parity import nchw, nhwc, normal

torch.set_num_threads(1)

OIHW = (3, 2, 0, 1)  # HWIO -> OIHW


def close(actual, expected, rtol=1e-5):
    """float32 on both sides, sums in another order: `rtol` of each value
    plus `rtol` of the largest one for sums that cancel."""
    expected = np.asarray(expected, np.float32)
    np.testing.assert_allclose(
        np.asarray(actual, np.float32), expected, rtol=rtol,
        atol=rtol * max(1.0, float(np.abs(expected).max())))


def _quantized(kernel):
    """JAX-layout float kernel -> (JAX q, JAX scale, port q, port scale)."""
    jq, js = jquant.quantize_weight_per_cout(jnp.asarray(kernel))
    perm = OIHW if kernel.ndim == 4 else (1, 0)
    q, s = quant.quantize_weight_per_cout(torch.from_numpy(
        np.ascontiguousarray(np.transpose(kernel, perm))))
    return jq, js, q, s


@pytest.mark.parametrize("shape", [(64, 32), (3, 3, 8, 16), (1, 1, 128, 256),
                                   (256, 1024)])
def test_quantize_weight_per_cout_bit_equal(shape):
    rng = np.random.default_rng(0)
    kernel = normal(rng, *shape)
    kernel[..., 3] = 0.0            # an all-zero channel: the 1e-8 floor
    kernel[..., 5] *= 1e3
    jq, js, q, s = _quantized(kernel)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    perm = OIHW if kernel.ndim == 4 else (1, 0)
    np.testing.assert_array_equal(q.numpy(),
                                  np.transpose(np.asarray(jq), perm))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    assert int(q.abs().max()) == 127 and not q[3].any()


@pytest.mark.parametrize("m,k,n", [(50, 256, 256), (8, 1024, 1536),
                                   (300, 128, 128)])
def test_matmul_w8_plain_matches_pallas_interpret(m, k, n):
    """A ragged M (row padding on the JAX side) and multi-tile K / N."""
    rng = np.random.default_rng(1)
    x, kernel = normal(rng, m, k), normal(rng, k, n)
    jq, js, q, s = _quantized(kernel)
    ref = j_matmul_w8(jnp.asarray(x), jq, js, block_m=128, block_n=128,
                      block_k=128)
    out = quant.matmul_w8(torch.from_numpy(x), q, s)  # CPU: the plain version
    assert out.dtype == torch.float32 and out.shape == (m, n)
    close(out.numpy(), ref)
    assert torch.equal(out, quant.matmul_w8_plain(torch.from_numpy(x), q, s))


def test_int8_to_bf16_by_bit_placement_is_exact():
    """The CUDA tile (csrc/gemm_tile.cuh, `int8x2_to_bf16x2`) turns an int8
    weight into bf16 without the conversion unit: a byte q is l - 128 s with
    l its low seven bits and s its sign bit; beside the exponent byte 0x43,
    l is the bf16 128 + l and the bit s the bf16 128 (1 + s), and their bf16
    difference is q. The same arithmetic on the CPU, for every byte: exact."""
    q = np.arange(-128, 128, dtype=np.int8)
    byte = q.view(np.uint8).astype(np.int32)

    def bf16(bits):
        return torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(
            torch.bfloat16)

    low, sign = bf16(0x4300 | (byte & 0x7F)), bf16(0x4300 | (byte & 0x80))
    assert torch.equal(low.float(),
                       torch.from_numpy(128.0 + (byte & 0x7F)).float())
    assert torch.equal(sign.float(),
                       torch.from_numpy(128.0 * (1 + (byte >> 7))).float())
    assert torch.equal((low - sign).float(), torch.from_numpy(q).float())


def test_converted_weight_tile_fills_the_swizzled_rows():
    """The CUDA tile keeps bf16 rows of 64 k as eight 16-byte chunks, chunk
    c of row r at position c ^ (r & 7) (the 128-byte swizzle `wgmma` reads).
    An int8 chunk c (16 weights) of a row becomes the bf16 chunks 2c and
    2c + 1: every position of every row is written once."""
    for r in range(16):
        written = sorted(pos ^ (r & 7) for c in range(4)
                         for pos in (2 * c, 2 * c + 1))
        assert written == list(range(8))
        assert sorted(c ^ (r & 7) for c in range(8)) == list(range(8))


def test_matmul_w8_plain_bf16_rounds_once():
    """bf16 activations: a float32 product and scale, one rounding at the
    end, as the kernel's accumulator does."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(normal(rng, 16, 64)).bfloat16()
    _, _, q, s = _quantized(normal(rng, 64, 128))
    out = quant.matmul_w8_plain(x, q, s)
    ref = ((x.double() @ q.double().t()) * s.double()).float().bfloat16()
    assert out.dtype == torch.bfloat16
    assert float((out.float() - ref.float()).abs().max()) <= \
        2 ** -8 * float(ref.float().abs().max())


@pytest.mark.parametrize("cin,cout", [(128, 256), (128, 64), (48, 128)])
def test_dense_w8(cin, cout):
    """Through the matmul (cin % 32 == 0 and cout % 128 == 0) and through
    the dequantized matmul the JAX package uses for the other shapes."""
    rng = np.random.default_rng(3)
    x, kernel = normal(rng, 2, 5, cin), normal(rng, cin, cout)
    jq, js, q, s = _quantized(kernel)
    ref = jquant.dense_w8(jnp.asarray(x), jq, js)
    out = quant.dense_w8(torch.from_numpy(x), q, s)
    assert out.shape == (2, 5, cout)
    close(out.numpy(), ref)
    rel = np.linalg.norm(out.numpy() - x @ kernel) / np.linalg.norm(x @ kernel)
    assert 0 < rel < 0.02           # int8 drift: there, and small


@pytest.mark.parametrize("kshape,stride,pad,groups", [
    ((1, 1, 128, 128), (1, 1), 0, 1),      # the matmul route
    ((1, 1, 128, 64), (1, 1), 0, 1),       # 1x1, cout below the tile
    ((3, 3, 1, 128), (1, 1), 1, 128),      # depthwise: dequantized conv
    ((2, 2, 128, 256), (2, 2), 0, 1),      # strided down-conv
    ((3, 3, 128, 32), (1, 1), 1, 1)])
def test_conv_w8_routes(kshape, stride, pad, groups):
    rng = np.random.default_rng(4)
    x, kernel = normal(rng, 2, 4, 4, 128), normal(rng, *kshape)
    jq, js, q, s = _quantized(kernel)
    ref = jquant.conv_w8(jnp.asarray(x), jq, js, stride,
                         ((pad, pad), (pad, pad)), groups)
    out = quant.conv_w8(nchw(x), q, s, stride, (pad, pad), groups)
    assert out.is_contiguous()
    close(nhwc(out), ref)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_w8_module(bias, monkeypatch):
    monkeypatch.setattr(jquant, "W8_MIN_WEIGHT_PARAMS", 0)
    rng = np.random.default_rng(5)
    lin = nn.Linear(64, 128, bias=bias)
    x = normal(rng, 3, 64)
    w8 = LinearW8(lin)
    leaf = {"kernel": lin.weight.detach().numpy().T}
    if bias:
        leaf["bias"] = lin.bias.detach().numpy()
    jp = jquant.quantize_variables({"dense": leaf})
    assert "kernel_q" in jp["dense"]
    np.testing.assert_array_equal(w8.weight_q.numpy(),
                                  np.asarray(jp["dense"]["kernel_q"]).T)
    ref = TorchDense(128, use_bias=bias).apply({"params": jp}, jnp.asarray(x))
    with torch.inference_mode():
        close(w8(torch.from_numpy(x)).numpy(), ref)
    assert sorted(w8.state_dict()) == sorted(
        ["weight_q", "weight_scale"] + (["bias"] if bias else []))


@pytest.mark.parametrize("ksize,stride,pad,groups", [(1, 1, 0, 1),
                                                     (3, 1, 1, 128),
                                                     (2, 2, 0, 1)])
def test_conv2d_w8_module(ksize, stride, pad, groups, monkeypatch):
    monkeypatch.setattr(jquant, "W8_MIN_WEIGHT_PARAMS", 0)
    rng = np.random.default_rng(6)
    conv = nn.Conv2d(128, 128, ksize, stride=stride, padding=pad,
                     groups=groups)
    x = normal(rng, 2, 4, 4, 128)
    w8 = Conv2dW8(conv)
    jp = jquant.quantize_variables({"conv": {
        "kernel": np.transpose(conv.weight.detach().numpy(), (2, 3, 1, 0)),
        "bias": conv.bias.detach().numpy()}})
    np.testing.assert_array_equal(
        w8.weight_q.numpy(),
        np.transpose(np.asarray(jp["conv"]["kernel_q"]), OIHW))
    ref = TorchConv(128, (ksize, ksize), strides=(stride, stride),
                    padding=pad, feature_group_count=groups).apply(
        {"params": jp}, jnp.asarray(x))
    with torch.inference_mode():
        close(nhwc(w8(nchw(x))), ref)


def test_w8_module_casts_keep_float32_scales():
    w8 = Conv2dW8(nn.Conv2d(32, 128, 1))
    assert compute_dtype(w8) == torch.float32
    w8.to(torch.bfloat16)
    assert w8.weight_scale.dtype == torch.float32
    assert w8.weight_q.dtype == torch.int8
    assert w8.bias.dtype == torch.bfloat16
    assert compute_dtype(w8) == torch.bfloat16
    x = torch.randn(2, 32, 2, 2).bfloat16()
    with torch.inference_mode():
        assert w8(x).dtype == torch.bfloat16


def test_quantize_module_follows_the_size_threshold(monkeypatch):
    """Only layers with at least W8_MIN_WEIGHT_PARAMS weights change, as in
    `quantize_variables`; the module tree is the switch."""
    assert quant.W8_MIN_WEIGHT_PARAMS == jquant.W8_MIN_WEIGHT_PARAMS == 1 << 20
    assert quant.w8_layer_eligible(1 << 20)
    assert not quant.w8_layer_eligible((1 << 20) - 1)
    net = nn.Sequential(nn.Conv2d(8, 8, 1), nn.Linear(1024, 1024),
                        nn.Sequential(nn.Conv2d(16, 16, 3), nn.ReLU()))
    assert quantize_module_(net) == 1
    assert isinstance(net[1], LinearW8) and isinstance(net[0], nn.Conv2d)
    monkeypatch.setattr(quant, "W8_MIN_WEIGHT_PARAMS", 0)
    assert quantize_module_(net) == 2
    assert isinstance(net[0], Conv2dW8) and isinstance(net[2][0], Conv2dW8)
    assert quantize_module_(net) == 0
