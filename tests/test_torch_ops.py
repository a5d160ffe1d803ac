"""Port ops against the JAX package: gates, time embedding, pixel shuffle,
LayerNorm2d, the ln_film kernel's plain version (against the Pallas kernel in
interpret mode and the jnp path; and chip_smoke.py's library yardsticks
against the plain versions), GroupNorm+SiLU, and the affine warp's plain
version (against the row-window Pallas kernel, the dense-mask path and the
gather formulation). All in float32 on the CPU."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifidiff_tpu.ops import norm as jnorm
from hifidiff_tpu.ops import warp as jwarp
from hifidiff_tpu.ops.embedding import sinusoidal_time_embed as j_embed
from hifidiff_tpu.ops.pallas import ln_film_pallas
from hifidiff_tpu.ops.pixel_shuffle import pixel_shuffle as j_pixel_shuffle
from hifidiff_tpu_torch.ops import kernels, norm, warp
from hifidiff_tpu_torch.ops.embedding import sinusoidal_time_embed
from hifidiff_tpu_torch.ops.gates import simple_gate
from hifidiff_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from torch_parity import assert_close, nchw, nhwc, normal

torch.set_num_threads(1)

# float32 on both sides; the sums over C / the gathers differ only in
# summation order, so errors stay at a few float32 ulps of O(1)-O(10) values
TOL = dict(rtol=1e-5, atol=2e-5)


def test_simple_gate():
    x = torch.arange(8.0).reshape(1, 8, 1, 1)
    assert simple_gate(x).flatten().tolist() == [0.0, 5.0, 12.0, 21.0]


def test_time_embed_matches_jax():
    t = np.asarray([0.0, 1.0, 500.0, 999.0], np.float32)
    assert_close(sinusoidal_time_embed(torch.from_numpy(t), 128).numpy(),
                 j_embed(jnp.asarray(t), 128), **TOL)


def test_pixel_shuffle_matches_jax():
    x = normal(np.random.default_rng(0), 2, 3, 5, 16)
    assert_close(nhwc(pixel_shuffle(nchw(x), 2)), j_pixel_shuffle(x, 2),
                 rtol=0, atol=0)


@pytest.mark.parametrize("c", [8, 48, 128])
def test_layer_norm_2d_matches_jax(c):
    rng = np.random.default_rng(c)
    x, w, b = normal(rng, 2, 4, 4, c, scale=3.0), normal(rng, c), normal(rng, c)
    out = norm.layer_norm_2d(nchw(x), torch.from_numpy(w), torch.from_numpy(b))
    assert_close(nhwc(out), jnorm.layer_norm_2d(x, w, b), **TOL)


def _film_inputs(seed, b, h, w, c, film_batch):
    rng = np.random.default_rng(seed)
    return (normal(rng, b, h, w, c, scale=2.0), normal(rng, c), normal(rng, c),
            normal(rng, film_batch, c, scale=0.1),
            normal(rng, film_batch, c, scale=0.1))


@pytest.mark.parametrize("film_batch", [2, 1])
def test_ln_film_plain_matches_pallas_interpret(film_batch):
    x, w, b, s, t = _film_inputs(1, 2, 4, 4, 128, film_batch)
    ref = ln_film_pallas(jnp.asarray(x), w, b,
                         jnp.broadcast_to(s, (2, 128)),
                         jnp.broadcast_to(t, (2, 128)))
    out = norm.ln_film(nchw(x), *map(torch.from_numpy, (w, b, s, t)))
    assert_close(nhwc(out), ref, **TOL)


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (3, 2, 2, 48),
                                   (2, 1, 1, 64), (2, 3, 5, 16)])
def test_ln_film_plain_matches_jnp_path(shape):
    x, w, b, s, t = _film_inputs(2, *shape, shape[0])
    ref = jnorm.ln_film(jnp.asarray(x), w, b, s, t)
    out = norm.ln_film(nchw(x), *map(torch.from_numpy, (w, b, s, t)))
    assert_close(nhwc(out), ref, **TOL)


def test_ln_film_cpu_takes_plain_version_uncounted():
    x, w, b, s, t = map(torch.from_numpy, _film_inputs(3, 2, 4, 4, 8, 1))
    x = x.permute(0, 3, 1, 2).contiguous()
    before = dict(kernels.LAUNCHES)
    torch.testing.assert_close(norm.ln_film(x, w, b, s, t),
                               norm.ln_film_plain(x, w, b, s, t),
                               rtol=0, atol=0)
    assert kernels.LAUNCHES == before


def _chip_smoke():
    """chip_smoke.py as a module (its top level imports numpy and torch)."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("film_batch", [3, 1])
def test_chip_smoke_layer_norm_routes_match_plain(film_batch):
    """chip_smoke.py times `ln_film` and its backward beside the nearest
    library route (F.layer_norm over a channels-last view and the FiLM's
    multiply-add; its autograd): the two routes compute what
    `ln_film_plain` and `ln_film_bwd_plain` compute, per-sample or shared
    FiLM."""
    cs = _chip_smoke()
    rng = np.random.default_rng(6)
    x, g = (torch.from_numpy(normal(rng, 3, 16, 4, 5, scale=2.0))
            for _ in range(2))
    w, b = (torch.from_numpy(normal(rng, 16)) for _ in range(2))
    s, t = (torch.from_numpy(normal(rng, film_batch, 16, scale=0.3))
            for _ in range(2))
    torch.testing.assert_close(cs.ln_film_route(x, w, b, s, t),
                               norm.ln_film_plain(x, w, b, s, t), **TOL)
    leaves = [u.clone().requires_grad_() for u in (x, w, b, s, t)]
    got = cs.ln_film_route_bwd(g, *leaves)
    ref = norm.ln_film_bwd_plain(g, x, w, b, s)
    assert [tuple(a.shape) for a in got] == [tuple(r.shape) for r in ref]
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, **TOL)


def test_group_norm_silu_matches_jax():
    rng = np.random.default_rng(4)
    x, w, b = normal(rng, 2, 4, 4, 64, scale=2.0), normal(rng, 64), normal(rng, 64)
    out = norm.group_norm_silu(nchw(x), torch.from_numpy(w),
                               torch.from_numpy(b))
    assert_close(nhwc(out), jnorm._gn_silu_ref(x, w, b, 32, 1e-6), **TOL)


def _theta(b, scale, seed):
    rng = np.random.default_rng(seed)
    ident = np.tile(np.asarray([[1, 0, 0], [0, 1, 0]], np.float32), (b, 1, 1))
    return (ident + rng.normal(0, scale, (b, 2, 3))).astype(np.float32)


# near-identity (the STNs at init), a strong shear, and thetas that map much
# of the output outside the input (must give exact zeros there)
THETAS = {"near": (0.03, None), "shear": (0.0, [[1.0, 0.3, 0.1],
                                                 [0.4, 0.9, -0.2]]),
          "out_of_bounds": (0.0, [[1.7, 0.2, 1.5], [-0.3, 2.0, -1.9]])}


def _thetas(kind, b, seed):
    scale, fixed = THETAS[kind]
    if fixed is None:
        return _theta(b, scale, seed)
    return np.tile(np.asarray(fixed, np.float32)[None], (b, 1, 1)) \
        + _theta(b, 0.02, seed) - _theta(b, 0.0, seed)


@pytest.mark.parametrize("kind", list(THETAS))
@pytest.mark.parametrize("res,c", [(8, 16), (32, 4)])
def test_warp_plain_matches_gather(kind, res, c):
    rng = np.random.default_rng(res)
    x, theta = normal(rng, 3, res, res, c), _thetas(kind, 3, res)
    ref = jwarp.affine_warp(jnp.asarray(x), jnp.asarray(theta),
                            method="gather")
    out = warp.affine_warp(nchw(x), torch.from_numpy(theta))
    assert_close(nhwc(out), ref, **TOL)
    grid = warp.affine_grid(torch.from_numpy(theta), (res, res))
    assert_close(grid.numpy(), jwarp.affine_grid(theta, (res, res)), **TOL)
    assert_close(nhwc(warp.grid_sample(nchw(x), grid)), ref, **TOL)
    if kind == "out_of_bounds":
        assert (np.asarray(ref) == 0).any()
        assert np.array_equal(nhwc(out) == 0, np.asarray(ref) == 0)


@pytest.mark.parametrize("res,c", [(16, 8), (64, 8)])
def test_warp_plain_matches_tpu_fast_path(monkeypatch, res, c):
    """16x16 reaches the dense interpolation-matrix einsum, 64x64 the
    row-window Pallas kernel in interpret mode."""
    monkeypatch.setenv("HIFIDIFF_FORCE_FAST_WARP", "1")
    rng = np.random.default_rng(res + 1)
    x, theta = normal(rng, 2, res, res, c), _theta(2, 0.03, res)
    ref = jwarp.affine_warp(jnp.asarray(x), jnp.asarray(theta))
    out = warp.affine_warp(nchw(x), torch.from_numpy(theta))
    assert_close(nhwc(out), ref, **TOL)


def test_warp_plain_via_pixel_coef_matches_jax_coef():
    theta = _thetas("shear", 2, 5)
    assert_close(warp.pixel_coef(torch.from_numpy(theta), 32, 16).numpy(),
                 np.asarray(jwarp._pixel_coef(theta, 32, 16))[:, :6], **TOL)


def test_warp_cpu_takes_plain_version_uncounted():
    rng = np.random.default_rng(6)
    x, theta = nchw(normal(rng, 2, 8, 8, 4)), torch.from_numpy(_theta(2, 0.1, 6))
    before = dict(kernels.LAUNCHES)
    coef = warp.pixel_coef(theta, 8, 8)
    torch.testing.assert_close(warp.affine_warp(x, theta),
                               warp.warp_plain(x, coef), rtol=0, atol=0)
    assert kernels.LAUNCHES == before
