"""The hand-written CUDA kernels against their plain PyTorch versions on the
card. Every test needs a CUDA device and nvcc, and skips elsewhere; run them
on a GPU machine with
`python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py`
(`--noconftest` because tests/conftest.py configures jax). chip_smoke.py
makes the same comparison at the main path's full shapes."""

import ctypes

import pytest
import torch

from hifidiff_tpu_torch.nn.layers import quantize_module_
from hifidiff_tpu_torch.nn.naf import ConditionalNAFBlock
from hifidiff_tpu_torch.ops import kernels, naf_block, norm, quant, warp
from hifidiff_tpu_torch.random_weights import (amplify_naf_blocks_,
                                               perturb_)

pytestmark = pytest.mark.cuda

# f32: ln_film sums in another order (a few ulps); the warp rounds each op
# in the plain version's order (bit-equal expected). bf16: both round the
# same float32 value once; a different sum order can move it one bf16 ulp
# (relative 2^-8), so 2^-7 relative plus a small absolute term.
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# The five maps of the denoiser's blocks (C, H, W) at the batches the paths
# and the tests take, and ragged maps: C of 48 and 200 at H*W of 15, 9 and 3
# (the kernels' element-wise variant), C*H*W not a whole number of 16-byte
# vectors, and C beyond what a block holds in registers.
LN_MAPS = ((128, 16, 16), (256, 8, 8), (512, 4, 4), (1024, 2, 2),
           (2048, 1, 1))
LN_SHAPES = [(b, *m) for b in (1, 3, 32, 128) for m in LN_MAPS] + [
    (3, c, h, w) for c in (48, 200) for h, w in ((5, 3), (3, 3), (3, 1))
] + [(2, 45, 2, 1), (4, 200, 2, 2), (2, 20000, 1, 1), (2, 2500, 3, 1),
     (4, 128, 16, 16), (4, 1024, 2, 2), (3, 48, 5, 3)]


# Tables at an odd element offset: the (C,) rows and the FiLM rows no longer
# start on whole vectors of channels, so the maps of one to four pixels
# (several channels a vector) read their tables element by element.
LN_CASES = [(s, 0) for s in LN_SHAPES] + [
    ((b, *m), 1) for b in (3, 32) for m in ((1024, 2, 2), (2048, 1, 1))]


def _tables(gen, c, dtype, cuda, offset):
    """weight, bias: (C,) rows `offset` elements into their storage."""
    return (torch.randn(c + offset, generator=gen, device=cuda)
            .to(dtype)[offset:] for _ in range(2))


def _film(gen, rows, c, dtype, cuda, offset=0):
    """scale, shift: rows 4C (+ offset) apart with unit channel stride, as a
    training block's `film.chunk(4, dim=1)` gives them, the first `offset`
    elements into their storage."""
    film = (0.3 * torch.randn(rows, 4 * c + offset, generator=gen,
                              device=cuda)).to(dtype)[:, offset:]
    _, scale, _, shift = film.chunk(4, dim=1)
    return scale, shift


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film", ["shared", "per_sample"])
@pytest.mark.parametrize("shape,offset", LN_CASES)
def test_ln_film_kernel_matches_plain(cuda, dtype, shape, offset, film):
    """Against the plain version, and twice on the same inputs for equal
    bits, with a shared (1, C) FiLM and per-sample rows 4C apart, the
    tables aligned or at an odd element offset."""
    g = torch.Generator(device=cuda).manual_seed(0)
    b, c = shape[0], shape[1]
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w, bb = _tables(g, c, dtype, cuda, offset)
    s, t = _film(g, 1 if film == "shared" else b, c, dtype, cuda, offset)
    before = kernels.LAUNCHES["ln_film"]
    with torch.inference_mode():
        out = norm.ln_film(x, w, bb, s, t)
        again = norm.ln_film(x, w, bb, s, t)
        ref = norm.ln_film_plain(x, w, bb, s, t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ln_film"] == before + 2
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    assert torch.equal(out, again)


# The STN maps of the CR at the batches of the CR train step, the refiner
# step's frozen CR and the sampler, and ragged maps; thetas near the
# identity, a shear, a zoom-in, a zoom-out that sends corners outside the
# image, random spreads up to 2, and zoom-outs whose windows exceed what a
# block stages (the kernel then gathers that tile from device memory).
STN_MAPS = ((32, 128, 128), (64, 64, 64), (128, 32, 32), (256, 16, 16),
            (512, 8, 8))
WARP_SHAPES = [(b, *m) for b in (8, 32, 128) for m in STN_MAPS] + [
    (2, 5, 7, 9), (4, 3, 192, 192), (3, 4, 13, 24)]
IDENT = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]
WARP_FWD_THETAS = {
    "identity": (IDENT, 0.0), "random": (IDENT, 0.05),
    "random_0.5": (IDENT, 0.5), "random_2": (IDENT, 2.0),
    "shear": ([[1.0, 0.3, 0.1], [0.4, 0.9, -0.2]], 0.02),
    "zoom_in": ([[0.5, 0.0, 0.1], [0.0, 0.5, -0.1]], 0.02),
    "out_of_bounds": ([[1.7, 0.2, 1.5], [-0.3, 2.0, -1.9]], 0.02),
    "zoom_out_8": ([[8.0, 0.0, 0.0], [0.0, 8.0, 0.0]], 0.0)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WARP_SHAPES)
@pytest.mark.parametrize("kind", list(WARP_FWD_THETAS))
def test_warp_kernel_matches_plain(cuda, dtype, shape, kind):
    """f32: bit-equal to the plain version (the kernel rounds each product
    and sum in its order); bf16: one rounding of the same float32 value.
    Two calls give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(1)
    b = shape[0]
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    base, spread = WARP_FWD_THETAS[kind]
    theta = torch.tensor(base, device=cuda) + spread * torch.randn(
        b, 2, 3, generator=g, device=cuda)
    coef = warp.pixel_coef(theta, shape[2], shape[3])
    before = kernels.LAUNCHES["affine_warp"]
    with torch.inference_mode():
        out = warp.warp(x, coef)
        again = warp.warp(x, coef)
        ref = warp.warp_plain(x, coef)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["affine_warp"] == before + 2
    assert torch.equal(out, again)
    if dtype == torch.float32:
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


def test_kernels_refuse_gradients(cuda):
    """The inference-only kernels raise where a gradient is wanted and do
    not fall back; `ln_film` and the warp have backward kernels and run."""
    x = torch.randn(2, 64, 4, 4, device=cuda, requires_grad=True)
    w, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(RuntimeError, match="backward"):
        norm.group_norm_silu(x, w, b, fused=True)
    xb = torch.randn(64, 128, device=cuda).bfloat16().requires_grad_()
    wq, scale = quant.quantize_weight_per_cout(
        torch.randn(128, 128, device=cuda))
    with pytest.raises(RuntimeError, match="backward"):
        quant.matmul_w8(xb, wq, scale)
    blk = _block(128, False, cuda)
    film = torch.zeros(1, 512, device=cuda).bfloat16()
    with pytest.raises(RuntimeError, match="backward"):
        blk(torch.randn(2, 128, 1, 1, device=cuda).bfloat16(), None, film,
            fuse_small=True)
    before = dict(kernels.LAUNCHES)
    s = torch.zeros(1, 64, device=cuda)
    norm.ln_film(x, w, b, s, s).sum().backward()
    warp.warp(x, warp.pixel_coef(torch.tensor(
        [[[1.0, 0, 0], [0, 1.0, 0]]], device=cuda).repeat(2, 1, 1), 4, 4)
    ).sum().backward()
    torch.cuda.synchronize()
    for name in ("ln_film", "ln_film_bwd", "affine_warp", "affine_warp_bwd"):
        assert kernels.LAUNCHES[name] == before[name] + 1, name


# The backward kernels against their plain versions (the closed forms). f32:
# the sums over channels, pixels and the batch are taken in another order
# (fixed from run to run, but not the plain version's); every
# sum has up to 2048 (channels) or 32768 (pixels) terms of order 1, so a few
# 1e-6 of the largest term per element, held relative to the gradient's
# largest value. bf16: dx is one rounding of a float32 value (2^-8 relative,
# plus the cancellation in `gw - y * mean - mean`); the float32 partials see
# the same bf16 inputs and differ as in f32.
BWD_REL = {torch.float32: 2e-5, torch.bfloat16: 2 ** -6}
SUM_REL = 2e-5


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("need_wb", [True, False])
@pytest.mark.parametrize("film", ["per_sample", "shared"])
@pytest.mark.parametrize("shape,offset", LN_CASES)
def test_ln_film_bwd_kernel_matches_plain(cuda, dtype, shape, offset, film,
                                          need_wb):
    """Against the closed form, with g made non-contiguous as autograd may
    hand it over, and twice on the same inputs for equal bits; the tables
    aligned or at an odd element offset."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    b, c = shape[0], shape[1]
    x, g = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    w, bb = _tables(gen, c, dtype, cuda, offset)
    scale, _ = _film(gen, 1 if film == "shared" else b, c, dtype, cuda,
                     offset)
    before = kernels.LAUNCHES["ln_film_bwd"]
    out = norm.ln_film_bwd(g.transpose(2, 3).contiguous().transpose(2, 3),
                           x, w, bb, scale, 1e-6, need_wb)
    again = norm.ln_film_bwd(g, x, w, bb, scale, 1e-6, need_wb)
    ref = norm.ln_film_bwd_plain(g, x, w, bb, scale, 1e-6, need_wb)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ln_film_bwd"] == before + 2
    assert out[0].dtype == dtype and out[3].shape == scale.shape
    assert _rel(out[0], ref[0]) <= BWD_REL[dtype]
    assert (out[1] is None) == (out[2] is None) == (not need_wb)
    for a, r in zip(out[1:], ref[1:]):
        if r is not None:
            assert a.dtype == torch.float32 and _rel(a, r) <= SUM_REL
    for a, r in zip(out, again):
        assert a is r is None or torch.equal(a, r)


def test_ln_film_kernels_refuse_misaligned_maps(cuda):
    """The kernels read 16 bytes a thread: a map at an odd element offset
    raises and is not computed another way."""
    shape = (2, 128, 4, 4)
    n = 2 * 128 * 16
    x = torch.randn(n + 1, device=cuda)[1:].view(shape)
    w, s = torch.ones(128, device=cuda), torch.zeros(1, 128, device=cuda)
    before = dict(kernels.LAUNCHES)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="aligned"):
            norm.ln_film(x, w, w, s, s)
        with pytest.raises(ValueError, match="aligned"):
            norm.ln_film_bwd(x.clone(), x, w, w, s)
        with pytest.raises(ValueError, match="aligned"):
            norm.ln_film_bwd(x, x.clone(), w, w, s)
    assert dict(kernels.LAUNCHES) == before


@pytest.mark.parametrize("need_wb", [True, False])
@pytest.mark.parametrize("film", ["per_sample", "shared"])
@pytest.mark.parametrize("shape", [(32, 128, 16, 16), (32, 512, 4, 4),
                                   (32, 2048, 1, 1), (3, 48, 5, 3)])
def test_ln_film_bwd_device_launches(cuda, shape, film, need_wb):
    """One backward call is at most two launches on the device, memsets
    included: every device event under `torch.profiler` over five calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(10)
    x, g = (torch.randn(shape, generator=gen, device=cuda) for _ in range(2))
    c = shape[1]
    w, b = torch.randn(c, device=cuda), torch.randn(c, device=cuda)
    scale, _ = _film(gen, 1 if film == "shared" else shape[0], c,
                     torch.float32, cuda)
    norm.ln_film_bwd(g, x, w, b, scale, need_wb=need_wb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            norm.ln_film_bwd(g, x, w, b, scale, need_wb=need_wb)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    assert 0 < len(events) <= 2 * 5, [e.name for e in events]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_film_autograd_on_the_card(cuda, dtype):
    """Through `ln_film` under autograd with per-sample FiLM rows 4C apart,
    as a training block calls it: the forward output and the gradients, each
    in its primal's dtype, against the plain version and its autograd."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(4, 256, 8, 8, generator=gen, device=cuda).to(dtype) \
        .requires_grad_()
    w, b = (torch.randn(256, generator=gen, device=cuda).to(dtype)
            .requires_grad_() for _ in range(2))
    film = (0.3 * torch.randn(4, 1024, generator=gen, device=cuda)) \
        .to(dtype).requires_grad_()
    _, sc, _, sh = film.chunk(4, dim=1)
    g = torch.randn(4, 256, 8, 8, generator=gen, device=cuda).to(dtype)
    out, plain = norm.ln_film(x, w, b, sc, sh), \
        norm.ln_film_plain(x, w, b, sc, sh)
    torch.testing.assert_close(out.float(), plain.float(), **TOL[dtype])
    got = torch.autograd.grad(out, (x, w, b, film), g)
    ref = torch.autograd.grad(plain, (x, w, b, film), g)
    for a, r, p in zip(got, ref, (x, w, b, film)):
        assert a.dtype == p.dtype and a.shape == p.shape
        assert _rel(a, r) <= BWD_REL[dtype]


WARP_THETAS = {
    "identity": ([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], 0.0),
    "random": ([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], 0.05),
    "shear": ([[1.0, 0.3, 0.1], [0.4, 0.9, -0.2]], 0.02),
    "out_of_bounds": ([[1.7, 0.2, 1.5], [-0.3, 2.0, -1.9]], 0.02),
    # a singular 2x2 part: every output pixel samples one line, and dx
    # searches the whole output for each source pixel
    "singular": ([[0.5, 0.5, 0.0], [0.5, 0.5, 0.1]], 0.0)}


def _device_launches(fn, calls=3):
    """Device events (kernels and memsets) of `calls` calls of `fn` under
    `torch.profiler`, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    return len(events) / calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 32, 128, 128), (8, 64, 64, 64),
                                   (8, 128, 32, 32), (8, 256, 16, 16),
                                   (8, 512, 8, 8), (2, 5, 7, 9)])
@pytest.mark.parametrize("kind", list(WARP_THETAS))
def test_warp_bwd_kernel_matches_plain(cuda, dtype, shape, kind):
    """dx: each element is a sum of a few order-1 terms near the identity,
    many under a strong minification, taken in another order than the
    plain version's scatter. dcoef sums C * H * W terms times pixel
    coordinates up to 127: relative to its largest entry. Every sum is in a
    fixed order: two calls give the same bits. One device launch for dx
    alone, two for dcoef (with or without dx), no memset."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    base, spread = WARP_THETAS[kind]
    theta = torch.tensor(base, device=cuda) + spread * torch.randn(
        shape[0], 2, 3, generator=gen, device=cuda)
    x, g = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    coef = warp.pixel_coef(theta, shape[2], shape[3])
    before = kernels.LAUNCHES["affine_warp_bwd"]
    dx, dcoef = warp.warp_bwd(g, x, coef)
    dx2, dcoef2 = warp.warp_bwd(g, x, coef)
    rdx, rdcoef = warp.warp_bwd_plain(g, x, coef)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["affine_warp_bwd"] == before + 2
    assert dx.dtype == dtype and dcoef.dtype == torch.float32
    assert torch.equal(dx, dx2) and torch.equal(dcoef, dcoef2)
    assert _rel(dx, rdx) <= BWD_REL[dtype]
    assert _rel(dcoef, rdcoef) <= 1e-4
    only_dx = warp.warp_bwd(g, x, coef, need_dcoef=False)
    only_dcoef = warp.warp_bwd(g, x, coef, need_dx=False)
    assert only_dx[1] is None and torch.equal(only_dx[0], dx)
    assert only_dcoef[0] is None and torch.equal(only_dcoef[1], dcoef)
    if kind == "random":
        assert _device_launches(lambda: warp.warp_bwd(g, x, coef)) == 2
        assert _device_launches(
            lambda: warp.warp_bwd(g, x, coef, need_dcoef=False)) == 1
        assert _device_launches(
            lambda: warp.warp_bwd(g, x, coef, need_dx=False)) == 2


def test_warp_autograd_matches_grid_sample_at_identity(cuda):
    """At the identity every coordinate is an integer (fx = 0): the kernel
    takes the slope of the cell right of `floor`, as F.grid_sample does."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(2, 16, 32, 32, generator=gen, device=cuda).requires_grad_()
    theta = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]], device=cuda) \
        .repeat(2, 1, 1).requires_grad_()
    g = torch.randn(2, 16, 32, 32, generator=gen, device=cuda)
    got = torch.autograd.grad(warp.affine_warp(x, theta), (x, theta), g)
    grid = torch.nn.functional.affine_grid(theta, list(x.shape),
                                           align_corners=False)
    ref = torch.autograd.grad(torch.nn.functional.grid_sample(
        x, grid, align_corners=False), (x, theta), g)
    assert _rel(got[0], ref[0]) <= 1e-5 and _rel(got[1], ref[1]) <= 1e-4
    assert float(got[1].abs().max()) > 0


def test_kernels_refuse_bad_input(cuda):
    x = torch.randn(2, 8, 4, 4, device=cuda)
    w, s = torch.ones(8, device=cuda), torch.zeros(1, 8, device=cuda)
    with torch.inference_mode():
        with pytest.raises(ValueError):
            norm.ln_film(x.transpose(2, 3), w, w, s, s)
        with pytest.raises(TypeError):
            norm.ln_film(x.half(), w, w, s, s)
        with pytest.raises(TypeError):  # float64 maps
            norm.ln_film(x.double(), w, w, s, s)
        with pytest.raises(TypeError):  # float32 tables beside bf16 maps
            norm.ln_film(x.bfloat16(), w, w, s, s)
        with pytest.raises(TypeError):
            norm.ln_film_bwd(x.bfloat16(), x.bfloat16(), w, w, s)
        with pytest.raises(ValueError):
            warp.warp(x, torch.zeros(2, 8, device=cuda))


# matmul_w8 and the fused block round to bf16 after float32 sums over K up
# to 2048 in another order than the plain version: one bf16 ulp of the
# output (2^-8 relative), plus an absolute term for sums that cancel. A
# block chains five such products, so an ulp of an intermediate can move the
# output by a few ulps of its own scale (inputs of order 1, outputs of
# order 1-4).
GEMM_TOL = dict(rtol=2 ** -7, atol=2e-2)
BLOCK_TOL = dict(rtol=2 ** -6, atol=6e-2)
# BLOCK_TOL alone would pass a block that does nothing: on the seeded
# weights both branches of a block lie near one bf16 ulp of its input, the
# first a thousandth of the second. The block tests run on blocks scaled by
# `amplify_naf_blocks_` (each branch a tenth of the input or more) and compare
# what the block adds, (out - x) against (plain - x), as the norm of the
# difference over the norm of (plain - x). Kernel and plain version round to
# bf16 at the same places and differ only where a float32 value lies on a
# rounding boundary; a block with a part left out must fail the limit.
BRANCH_TOL = 2e-2


@pytest.mark.parametrize("m,k,n", [(128, 256, 256), (50, 256, 1024),
                                   (8, 1024, 1536), (300, 128, 128),
                                   (512, 1024, 2048), (70, 96, 128),
                                   (3, 32, 256)])
def test_matmul_w8_kernel_matches_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    w = torch.randn(n, k, generator=g, device=cuda)
    wq, scale = quant.quantize_weight_per_cout(w)
    before = kernels.LAUNCHES["matmul_w8"]
    with torch.inference_mode():
        out = quant.matmul_w8(x, wq, scale)
        ref = quant.matmul_w8_plain(x, wq, scale)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["matmul_w8"] == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    torch.testing.assert_close(out.float(), ref.float(), **GEMM_TOL)


@pytest.mark.parametrize("n", [128, 384, 8192])
@pytest.mark.parametrize("k", [32, 96, 1024, 8192])
@pytest.mark.parametrize("m", [1, 50, 63, 64, 65, 128, 512])
def test_matmul_w8_kernel_edge_shapes(cuda, m, k, n):
    """Ragged rows (the tile takes 128 at a time and reads the rest as
    zero), K that ends inside a ring stage (64 deep) or leaves a K range of
    the cluster short or empty, one column tile and many; and the same call
    twice gives the same bits (the partial sums are reduced in a fixed
    order, no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    wq, scale = quant.quantize_weight_per_cout(
        torch.randn(n, k, generator=g, device=cuda))
    with torch.inference_mode():
        out = quant.matmul_w8(x, wq, scale)
        again = quant.matmul_w8(x, wq, scale)
        ref = quant.matmul_w8_plain(x, wq, scale)
    torch.cuda.synchronize()
    assert out.shape == (m, n)
    torch.testing.assert_close(out.float(), ref.float(), **GEMM_TOL)
    assert torch.equal(out, again)


@pytest.mark.parametrize("m,k,n", [(128, 2048, 2048), (128, 2048, 2304),
                                   (128, 2048, 2560), (128, 2048, 4096),
                                   (512, 1024, 1024), (128, 1984, 3072)])
def test_matmul_w8_kernel_every_cluster_size(cuda, m, k, n):
    """Column-tile counts from 16 to 32 with 16 to 32 K steps: the K range
    is split over clusters of 3 to 8 blocks (as many as the card holds at
    once), whose row slices are uneven where the size does not divide 128
    and whose last rank may have fewer K steps or none; the same bits
    twice."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    wq, scale = quant.quantize_weight_per_cout(
        torch.randn(n, k, generator=g, device=cuda))
    plan = (ctypes.c_int * 4)()
    kernels.library().hifidiff_matmul_w8_plan(m, k, n, plan)
    assert plan[0] * 128 == n and 1 <= plan[2] <= 8
    assert plan[0] * plan[1] <= plan[3]   # the clusters fit the card at once
    with torch.inference_mode():
        out = quant.matmul_w8(x, wq, scale)
        again = quant.matmul_w8(x, wq, scale)
        ref = quant.matmul_w8_plain(x, wq, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **GEMM_TOL)
    assert torch.equal(out, again)


def test_matmul_w8_leaves_its_neighbours_alone(cuda):
    """Rows beyond M are computed as zeros inside the tile and must not be
    stored: the output of an M = 50 call lies inside a larger buffer whose
    other bytes keep their values."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(50, 256, generator=g, device=cuda).bfloat16()
    wq, scale = quant.quantize_weight_per_cout(
        torch.randn(256, 256, generator=g, device=cuda))
    lib = kernels.library()
    buf = torch.full((3, 50, 256), 7.0, device=cuda, dtype=torch.bfloat16)
    kernels.check(lib.hifidiff_matmul_w8(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), buf[1].data_ptr(),
        50, 256, 256, kernels.stream_ptr(cuda)), "matmul_w8")
    torch.cuda.synchronize()
    assert bool((buf[0] == 7.0).all()) and bool((buf[2] == 7.0).all())
    torch.testing.assert_close(
        buf[1].float(), quant.matmul_w8_plain(x, wq, scale).float(),
        **GEMM_TOL)


# A child process that runs `n` matmul_w8 products, each on activations and
# weights at addresses no product before it used, so that every call adds
# two entries to the GEMM tile's cache of TMA descriptors, which empties
# itself past 16,384 entries; and holds every `every`-th product, and each
# product around the calls at which the cache empties, to the plain
# version. glibc fills freed memory with a byte pattern
# (MALLOC_PERTURB_, with its per-thread cache off) so that a descriptor read
# after the cache freed it is garbage and shows.
_DESCRIPTOR_CACHE_RUN = """
import sys
import torch
from hifidiff_tpu_torch.ops import quant
n, every = int(sys.argv[1]), int(sys.argv[2])
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(12)
K, N = 256, 128
xs = torch.randn(n + 64, K, generator=g, device=dev).bfloat16()
ws = torch.randint(-127, 128, (n, N, K), generator=g, device=dev,
                   dtype=torch.int8)
scale = 1e-2 * torch.rand(N, generator=g, device=dev) + 1e-3
edges = {8191, 8192, 8193, 16384, 16385, 16386}
bad = []
with torch.inference_mode():
    for i in range(n):
        m = 1 + i % 64
        out = quant.matmul_w8(xs[i:i + m], ws[i], scale)
        if i % every == 0 or i in edges:
            ref = quant.matmul_w8_plain(xs[i:i + m], ws[i], scale)
            err = float((out.float() - ref.float()).abs().max())
            if not err <= 2e-2 + 2 ** -7 * float(ref.float().abs().max()):
                bad.append((i, err))
    torch.cuda.synchronize()
print("products", n, "wrong", bad)
sys.exit(1 if bad else 0)
"""


def test_matmul_w8_descriptor_cache_past_its_limit(cuda):
    """More than 16,384 distinct (pointer, M) products: the descriptor cache
    empties itself at call 8,192 between the lookups of the call's
    activations and weights, and again at call 16,385; no product may use a
    descriptor the cache freed."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, MALLOC_PERTURB_="165",
               GLIBC_TUNABLES="glibc.malloc.tcache_count=0",
               PYTHONPATH=str(root))
    run = subprocess.run(
        [sys.executable, "-c", _DESCRIPTOR_CACHE_RUN, "16500", "97"],
        cwd=root, env=env, capture_output=True, text=True, timeout=180)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]


def test_gemm_kernels_from_two_threads(cuda):
    """matmul_w8 and the fused block (both through the GEMM tile's host
    caches, which ctypes calls reach without the GIL) from two Python
    threads at once, each on fresh activations every call: every result
    equals the same call made alone."""
    import sys
    import threading

    g = torch.Generator(device=cuda).manual_seed(13)
    wq, scale = quant.quantize_weight_per_cout(
        torch.randn(1024, 512, generator=g, device=cuda))
    blk = _block(256, True, cuda)
    pack = blk.fused_pack(2, torch.bfloat16)
    film = (0.2 * torch.randn(1, 1024, generator=g, device=cuda)).bfloat16()
    xs = [torch.randn(1 + i % 7 * 20, 512, generator=g, device=cuda)
          .bfloat16() for i in range(60)]
    bs = [torch.randn(1 + i % 5, 256, 2, 2, generator=g, device=cuda)
          .bfloat16() for i in range(60)]
    with torch.inference_mode():
        want_mm = [quant.matmul_w8(x, wq, scale) for x in xs]
        want_blk = [naf_block.fused_cnaf_block_small(x, film, pack)
                    for x in bs]
    torch.cuda.synchronize()
    got = {"mm": [], "blk": []}
    errors = []

    def run(name, fn, inputs):
        try:
            with torch.inference_mode():
                for _ in range(5):
                    # fresh copies: new addresses, new descriptors
                    got[name] = [fn(x.clone()) for x in inputs]
            torch.cuda.synchronize()
        except Exception as e:  # reported below, with the thread's name
            errors.append((name, repr(e)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [
            threading.Thread(target=run, args=(
                "mm", lambda x: quant.matmul_w8(x, wq, scale), xs)),
            threading.Thread(target=run, args=(
                "blk", lambda x: naf_block.fused_cnaf_block_small(
                    x, film, pack), bs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert all(torch.equal(a, b) for a, b in zip(got["mm"], want_mm))
    assert all(torch.equal(a, b) for a, b in zip(got["blk"], want_blk))
    assert len(got["mm"]) == len(xs) and len(got["blk"]) == len(bs)


def test_conv_w8_routes(cuda):
    """A 1x1 conv on a 2x2 map goes through the kernel on (B*4, C) rows and
    comes back NCHW; a 3x3 conv takes the dequantized plain convolution."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(6, 128, 2, 2, generator=g, device=cuda).bfloat16()
    wq, scale = quant.quantize_weight_per_cout(
        torch.randn(256, 128, 1, 1, generator=g, device=cuda))
    before = kernels.LAUNCHES["matmul_w8"]
    with torch.inference_mode():
        out = quant.conv_w8(x, wq, scale)
        ref = torch.nn.functional.conv2d(
            x.float(), quant.dequantize(wq, scale, torch.float32))
        w3, s3 = quant.quantize_weight_per_cout(
            torch.randn(128, 128, 3, 3, generator=g, device=cuda))
        out3 = quant.conv_w8(x, w3, s3, padding=(1, 1))
    assert kernels.LAUNCHES["matmul_w8"] == before + 1
    assert out.is_contiguous() and out.shape == (6, 256, 2, 2)
    torch.testing.assert_close(out.float(), ref, **GEMM_TOL)
    assert out3.shape == x.shape and bool(torch.isfinite(out3).all())


# The SD-VAE's GroupNorm+SiLU maps (C, H, W) at batches 1 to 128, and maps
# whose runs take the streaming path: a (sample, group) run of 1 MB (past
# what the largest cluster holds), H * W not a whole number of vectors.
GN_MAPS = ((128, 128, 128), (256, 64, 64), (512, 32, 32), (256, 128, 128),
           (512, 16, 16), (512, 64, 64), (128, 64, 64), (256, 32, 32))
GN_CASES = [((b, *m), 32, "on_chip") for b in (1, 3, 128) for m in GN_MAPS] \
    + [((4, 128, 32, 32), 32, "on_chip"), ((2, 256, 128, 128), 8, "streaming"),
       ((3, 32, 5, 3), 8, "streaming"), ((2, 64, 1, 1), 32, "streaming")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,path", GN_CASES)
def test_group_norm_silu_kernel_matches_plain(cuda, dtype, shape, groups,
                                              path):
    """Against the plain version, twice for equal bits (the partial sums of
    a cluster are added in rank order), on the path the plan names."""
    g = torch.Generator(device=cuda).manual_seed(4)
    c = shape[1]
    x = (2.0 * torch.randn(shape, generator=g, device=cuda) + 0.5).to(dtype)
    w, b = (torch.randn(c, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    before = kernels.LAUNCHES["group_norm_silu"]
    with torch.inference_mode():
        out = norm.group_norm_silu(x, w, b, groups, fused=True)
        again = norm.group_norm_silu(x, w, b, groups, fused=True)
        ref = norm.group_norm_silu_plain(x, w, b, groups)
        unfused = norm.group_norm_silu(x, w, b, groups)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["group_norm_silu"] == before + 2
    assert torch.equal(unfused, ref)  # fused=False never launches
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    assert torch.equal(out, again)
    plan = norm.group_norm_silu_plan(shape, dtype, groups)
    assert plan["path"] == path, plan
    assert plan["reads"] == (1 if path == "on_chip" else 3)


def test_group_norm_silu_near_constant_group(cuda):
    """A near-constant group with a large mean: the one-pass variance would
    go negative. The plain version computes `x * a + b` with a = rstd * w of
    about 1e3, which loses about 50 * 1e3 * 2^-24 = 3e-3 to cancellation, so
    the bound is the JAX package's for the same case (2e-2)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = 50.0 + 1e-3 * torch.randn(1, 128, 32, 32, generator=g, device=cuda)
    w, b = torch.ones(128, device=cuda), torch.zeros(128, device=cuda)
    with torch.inference_mode():
        out = norm.group_norm_silu(x, w, b, fused=True)
        ref = norm.group_norm_silu_plain(x, w, b)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, rtol=1e-2, atol=2e-2)


def _block(c, int8, cuda, seed=6):
    torch.manual_seed(seed)
    blk = ConditionalNAFBlock(c, 512)
    amplify_naf_blocks_(perturb_(blk, torch.Generator().manual_seed(seed)))
    if int8:
        # the five 1x1 convolutions (C^2 or 2 C^2 weights), not the depthwise
        # 3x3 (18 C); mlp.1 (1024 C) up to C = 1024
        for conv in (blk.conv1, blk.sca[1], blk.conv3, blk.conv4, blk.conv5):
            assert conv.weight.numel() >= c * c
        old, quant.W8_MIN_WEIGHT_PARAMS = quant.W8_MIN_WEIGHT_PARAMS, c * c
        try:
            assert quantize_module_(blk) == 5 + (c <= 1024)
        finally:
            quant.W8_MIN_WEIGHT_PARAMS = old
    return blk.to(cuda, torch.bfloat16).eval()


def _branch_error(out, ref, x):
    ref, x = ref.float(), x.float()
    return float((out.float() - ref).norm() / (ref - x).norm())


def _controls(pack):
    """{what is left out: the pack without it}."""
    w, sp = pack.weights, pack.hw * pack.hw
    gate_one, no_gamma = pack.vec_c.clone(), pack.vec_c.clone()
    gate_one[3] = 1.0   # vec_c rows: beta, gamma, s_sca, b_sca, ...
    no_gamma[1] = 0.0
    controls = {
        "the SCA gate": pack._replace(
            vec_c=gate_one, weights=(w[0], torch.zeros_like(w[1]), *w[2:])),
        "the second branch": pack._replace(vec_c=no_gamma)}
    if sp > 1:
        centre = [p * sp + p for p in range(sp)]
        taps = torch.zeros_like(pack.vec_dw)
        taps[centre] = pack.vec_dw[centre]
        controls["the off-centre taps"] = pack._replace(vec_dw=taps)
    return controls


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("batch,c,hw", [(5, 128, 1), (3, 256, 2),
                                        (128, 512, 1), (33, 128, 2)])
def test_fused_block_kernel_matches_plain(cuda, batch, c, hw, int8):
    blk = _block(c, int8, cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(batch, c, hw, hw, generator=g, device=cuda).bfloat16()
    film = (0.2 * torch.randn(1, 4 * c, generator=g, device=cuda)).bfloat16()
    pack = blk.fused_pack(hw, torch.bfloat16)
    before = dict(kernels.LAUNCHES)
    with torch.inference_mode():
        out = blk(x, None, film, fuse_small=True)
        ref = naf_block.fused_cnaf_block_small_plain(x, film, pack)
        std = blk(x, None, film)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cnaf_small"] == before["cnaf_small"] + 1
    assert kernels.LAUNCHES["ln_film"] == before["ln_film"] + 2  # `std` only
    assert out.shape == x.shape and out.is_contiguous()
    # the block acts: it adds a good part of its input's norm
    assert float((ref.float() - x.float()).norm() / x.float().norm()) > 0.1
    torch.testing.assert_close(out.float(), ref.float(), **BLOCK_TOL)
    assert _branch_error(out, ref, x) <= BRANCH_TOL
    # the standard path rounds at other places: a looser bound
    assert _branch_error(std, ref, x) <= 5 * BRANCH_TOL
    for what, wrong in _controls(pack).items():
        with torch.inference_mode():
            bad = naf_block.fused_cnaf_block_small(x, film, wrong)
        assert _branch_error(bad, ref, x) > 10 * BRANCH_TOL, what


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("hw", [1, 2])
@pytest.mark.parametrize("c", [128, 384, 1024, 2048])
def test_fused_block_kernel_edge_shapes(cuda, c, hw, batch, int8):
    """The narrowest and widest blocks the wrapper admits, a width that is
    no power of two (three paired column tiles, six K steps), one sample and
    three (a tile of 1 to 12 rows); and the same call twice gives the same
    bits."""
    blk = _block(c, int8, cuda)
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(batch, c, hw, hw, generator=g, device=cuda).bfloat16()
    film = (0.2 * torch.randn(1, 4 * c, generator=g, device=cuda)).bfloat16()
    pack = blk.fused_pack(hw, torch.bfloat16)
    with torch.inference_mode():
        out = naf_block.fused_cnaf_block_small(x, film, pack)
        again = naf_block.fused_cnaf_block_small(x, film, pack)
        ref = naf_block.fused_cnaf_block_small_plain(x, film, pack)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **BLOCK_TOL)
    assert _branch_error(out, ref, x) <= BRANCH_TOL
    assert torch.equal(out, again)


def test_fused_block_per_sample_film_takes_standard_path(cuda):
    blk = _block(128, False, cuda)
    x = torch.randn(3, 128, 1, 1, device=cuda).bfloat16()
    film = torch.zeros(3, 512, device=cuda).bfloat16()
    before = dict(kernels.LAUNCHES)
    with torch.inference_mode():
        blk(x, None, film, fuse_small=True)
    assert kernels.LAUNCHES["cnaf_small"] == before["cnaf_small"]
    assert kernels.LAUNCHES["ln_film"] == before["ln_film"] + 2


def test_new_kernels_refuse_bad_input(cuda):
    """A CUDA tensor the kernel cannot take raises; it never reaches the
    plain version."""
    x = torch.randn(64, 128, device=cuda)
    wq, scale = quant.quantize_weight_per_cout(
        torch.randn(128, 128, device=cuda))
    before = dict(kernels.LAUNCHES)
    with torch.inference_mode():
        with pytest.raises(TypeError):              # f32 activations
            quant.matmul_w8(x, wq, scale)
        with pytest.raises(TypeError):
            quant.matmul_w8(x.half(), wq, scale)
        with pytest.raises(ValueError):             # N % 128
            quant.matmul_w8(x.bfloat16(), wq[:64].contiguous(), scale[:64])
        with pytest.raises(ValueError):             # K % 32
            quant.matmul_w8(x.bfloat16()[:, :16].contiguous(),
                            wq[:, :16].contiguous(), scale)
        with pytest.raises(ValueError):             # not contiguous
            quant.matmul_w8(x.bfloat16().t(), wq, scale)
        xm = torch.randn(2, 64, 4, 4, device=cuda)
        w, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
        with pytest.raises(TypeError):
            norm.group_norm_silu(xm.half(), w.half(), b.half(), fused=True)
        with pytest.raises(TypeError):              # params in x's dtype
            norm.group_norm_silu(xm.bfloat16(), w, b, fused=True)
        with pytest.raises(ValueError):
            norm.group_norm_silu(xm, w, b, num_groups=48, fused=True)
        with pytest.raises(ValueError):
            norm.group_norm_silu(xm.transpose(2, 3), w, b, fused=True)
        blk = _block(128, False, cuda)
        pack = blk.fused_pack(1, torch.bfloat16)
        film = torch.zeros(1, 512, device=cuda).bfloat16()
        xb = torch.randn(2, 128, 1, 1, device=cuda)
        with pytest.raises(TypeError):              # f32 map
            naf_block.fused_cnaf_block_small(xb, film.float(), pack)
        with pytest.raises(TypeError):  # nor does the block step aside
            _block(128, False, cuda).float()(xb, None, film.float(),
                                             fuse_small=True)
        with pytest.raises(ValueError):             # 2x2 map, 1x1 pack
            naf_block.fused_cnaf_block_small(
                torch.randn(2, 128, 2, 2, device=cuda).bfloat16(), film, pack)
    assert dict(kernels.LAUNCHES) == before
