"""The port's samplers against the JAX package's, on toy epsilon functions
(float32 latents, CPU): stochastic DDIM fed the noise that JAX draws from
the same key, x0 clipping, the cached DDIM sampler, DPM-Solver++ (2M) and
its coefficient tables, and ancestral DDPM.

Tolerances: both sides run the same float32 arithmetic on float32 latents;
the JAX package rounds its per-step constants to float32, the port keeps
them as float64 Python numbers until they meet a float32 tensor. That
leaves a few float32 ulps per step: 1e-5 (absolute and relative) for the
DDIM-type samplers of up to 50 steps. DDPM runs all 1000 timesteps, where
JAX's float32 table of alpha_bar loses up to 6e-4 of 1 - alpha_bar near
t = 0 (alpha_bar = 1 - 1e-4); it is compared on the JAX sampler given the
float64 tables (`J_SCHEDULE_F64`), to 1e-4. The DPM-Solver++ coefficients
come from the same float64 numpy arithmetic and are compared for exact
equality on the same float64 schedule, and to 1e-3 against JAX's float32
schedule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifidiff_tpu.diffusion import sampling as js
from hifidiff_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from hifidiff_tpu_torch.diffusion import sampling
from hifidiff_tpu_torch.diffusion.schedule import ALPHAS_CUMPROD, BETAS
from torch_parity import assert_close, nchw, nhwc, normal

torch.set_num_threads(1)
J_SCHEDULE = JSchedule.create()
J_SCHEDULE_F64 = JSchedule(betas=BETAS, alphas_cumprod=ALPHAS_CUMPROD)
SHAPE = (2, 4, 4, 3)   # NHWC on the JAX side


def _latents(seed=0):
    return normal(np.random.default_rng(seed), *SHAPE)


def eps_toy(x, t, a=1.0):
    """An epsilon that depends on x, t and the per-step aux; the same
    expression for jnp and torch arrays."""
    return 0.3 * x * a + 1e-3 * t[:, None, None, None] - 0.05


def _jax_noise(key, steps):
    """The per-step normals `sample_ddim` / `sample_ddpm` draw inside their
    scan: one per key of `jax.random.split(key, steps)`."""
    keys = jax.random.split(key, steps)
    return np.asarray(jax.vmap(lambda k: jax.random.normal(
        k, SHAPE, jnp.float32))(keys))


def _steps_nchw(noise):
    """(S, B, H, W, C) numpy -> (S, B, C, H, W) torch."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(noise, (0, 1, 4, 2, 3))))


@pytest.mark.parametrize("steps,eta", [(1, 0.5), (5, 1.0), (20, 0.3)])
def test_stochastic_ddim_matches_jax(steps, eta):
    """eta > 0: the port fed, as `step_noise`, the normals JAX draws from
    the same key gives JAX's samples."""
    x = _latents()
    key = jax.random.PRNGKey(7)
    ref = js.sample_ddim(eps_toy, jnp.asarray(x), J_SCHEDULE,
                         num_inference_steps=steps, eta=eta, key=key)
    noise = _steps_nchw(_jax_noise(key, steps))
    out = sampling.sample_ddim(eps_toy, nchw(x), num_inference_steps=steps,
                               eta=eta, step_noise=noise)
    assert_close(nhwc(out), ref, rtol=1e-5, atol=1e-5)
    # the noise reaches the samples: eta 0 gives other ones
    det = sampling.sample_ddim(eps_toy, nchw(x), num_inference_steps=steps)
    if steps > 1:
        assert np.abs(nhwc(det) - np.asarray(ref)).max() > 1e-2


def test_stochastic_ddim_needs_noise():
    x = nchw(_latents())
    with pytest.raises(ValueError, match="step_noise"):
        sampling.sample_ddim(eps_toy, x, num_inference_steps=3, eta=1.0)
    with pytest.raises(ValueError, match="step_noise must be"):
        sampling.sample_ddim(eps_toy, x, num_inference_steps=3, eta=1.0,
                             step_noise=torch.zeros(2, *x.shape))
    a, b = (sampling.sample_ddim(eps_toy, x, num_inference_steps=3, eta=1.0,
                                 generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert torch.equal(a, b)


@pytest.mark.parametrize("clip_range", [1.0, 3.0])
@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
def test_clip_sample_matches_jax(sampler, clip_range):
    x = _latents(1) * 2.0   # x0 passes +-3 at the noisy steps
    kw = dict(num_inference_steps=10, clip_sample=True,
              clip_sample_range=clip_range)
    j_fn, fn = ((js.sample_ddim, sampling.sample_ddim) if sampler == "ddim"
                else (js.sample_dpmpp_2m, sampling.sample_dpmpp_2m))
    ref = j_fn(eps_toy, jnp.asarray(x), J_SCHEDULE, **kw)
    out = fn(eps_toy, nchw(x), **kw)
    assert_close(nhwc(out), ref, rtol=1e-5, atol=1e-5)
    unclipped = fn(eps_toy, nchw(x), num_inference_steps=10)
    assert np.abs(nhwc(unclipped) - np.asarray(ref)).max() > 1e-2


def _toy_halves(mod):
    """A toy encode / decode pair for the cached sampler: `mod` is jnp or
    torch; the cache holds a bottleneck and one skip."""
    def encode(x, t, a=1.0):
        return {"x": 0.5 * x * a + 1e-3 * t[:, None, None, None],
                "skips": (0.1 * x,)}

    def decode(cache, t, a=1.0):
        return (0.3 * cache["x"] + cache["skips"][0] * a
                - 2e-4 * t[:, None, None, None])

    return encode, decode


@pytest.mark.parametrize("interval", [1, 2, 3])
@pytest.mark.parametrize("with_aux", [False, True])
def test_cached_ddim_matches_jax(interval, with_aux):
    steps = 7
    x = _latents(2)
    aux = np.linspace(0.5, 1.5, steps).astype(np.float32)
    enc, dec = _toy_halves(jnp)
    ref = js.sample_ddim_cached(
        enc, dec, jnp.asarray(x), J_SCHEDULE, num_inference_steps=steps,
        cache_interval=interval,
        per_step_aux=jnp.asarray(aux) if with_aux else None)
    enc, dec = _toy_halves(torch)
    out = sampling.sample_ddim_cached(
        enc, dec, nchw(x), num_inference_steps=steps,
        cache_interval=interval,
        per_step_aux=list(map(float, aux)) if with_aux else None)
    assert_close(nhwc(out), ref, rtol=1e-5, atol=1e-5)


def test_cached_ddim_interval_one_is_ddim():
    """Interval 1 refreshes every step: bit for bit `sample_ddim` of the
    composed network."""
    enc, dec = _toy_halves(torch)
    x = nchw(_latents(3))
    out = sampling.sample_ddim_cached(enc, dec, x, num_inference_steps=6)
    ref = sampling.sample_ddim(lambda x, t: dec(enc(x, t), t), x,
                               num_inference_steps=6)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("steps", [1, 2, 3, 20, 50])
def test_dpmpp_2m_coeffs_match_jax(steps):
    """Exactly equal on the same float64 schedule; against JAX's own
    schedule (float32 tables) to the tables' rounding, which 1 - alpha_bar
    near t = 0 magnifies."""
    ours = sampling.dpmpp_2m_coeffs(steps)
    same = js.dpmpp_2m_coeffs(J_SCHEDULE_F64, steps)
    assert set(ours) == set(same)
    for k in ours:
        assert ours[k].dtype == np.float64
        np.testing.assert_array_equal(ours[k], same[k], err_msg=k)
        np.testing.assert_allclose(
            ours[k], js.dpmpp_2m_coeffs(J_SCHEDULE, steps)[k], rtol=1e-3,
            atol=1e-7, err_msg=k)


@pytest.mark.parametrize("steps", [1, 2, 20])
@pytest.mark.parametrize("with_aux", [False, True])
def test_dpmpp_2m_matches_jax(steps, with_aux):
    x = _latents(4)
    aux = np.linspace(0.5, 1.5, steps).astype(np.float32)
    ref = js.sample_dpmpp_2m(
        eps_toy, jnp.asarray(x), J_SCHEDULE, num_inference_steps=steps,
        per_step_aux=jnp.asarray(aux) if with_aux else None)
    out = sampling.sample_dpmpp_2m(
        eps_toy, nchw(x), num_inference_steps=steps,
        per_step_aux=list(map(float, aux)) if with_aux else None)
    assert out.dtype == torch.float32
    assert_close(nhwc(out), ref, rtol=1e-5, atol=1e-5)


def test_dpmpp_2m_keeps_the_sample_dtype():
    """bf16 latents stay bf16 through the loop; the solver's arithmetic is
    float32 (the result is the float32 run rounded at every step, within
    bf16 noise of it)."""
    x = nchw(_latents(5))
    seen = []

    def eps(x, t):
        seen.append(x.dtype)
        return eps_toy(x.float(), t)

    out = sampling.sample_dpmpp_2m(eps, x.bfloat16(), num_inference_steps=5)
    assert out.dtype == torch.bfloat16 and set(seen) == {torch.bfloat16}
    ref = sampling.sample_dpmpp_2m(eps_toy, x, num_inference_steps=5)
    assert_close(out.float().numpy(), ref.numpy(), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("clip_sample", [True, False])
def test_ddpm_matches_jax(clip_sample):
    x = _latents(6)
    key = jax.random.PRNGKey(11)
    ref = js.sample_ddpm(eps_toy, jnp.asarray(x), J_SCHEDULE_F64, key,
                         clip_sample=clip_sample)
    noise = _steps_nchw(_jax_noise(key, 1000))
    out = sampling.sample_ddpm(eps_toy, nchw(x), step_noise=noise,
                               clip_sample=clip_sample)
    assert_close(nhwc(out), ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="step_noise"):
        sampling.sample_ddpm(eps_toy, nchw(x))
