"""The port's schedule and DDIM sampler against the JAX package's, with toy
epsilon functions (float32 latents, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifidiff_tpu.diffusion.sampling import ddim_timesteps as j_ddim_timesteps
from hifidiff_tpu.diffusion.sampling import sample_ddim as j_sample_ddim
from hifidiff_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from hifidiff_tpu_torch.diffusion.sampling import ddim_timesteps, sample_ddim
from hifidiff_tpu_torch.diffusion.schedule import (ALPHAS_CUMPROD, BETAS,
                                                   betas)
from torch_parity import assert_close, nchw, nhwc, normal

torch.set_num_threads(1)


@pytest.mark.parametrize("steps", [1, 3, 50, 1000])
def test_ddim_timesteps(steps):
    np.testing.assert_array_equal(ddim_timesteps(steps),
                                  j_ddim_timesteps(1000, steps))


def test_schedule_tables():
    """The port's constant tables are the JAX schedule at its defaults."""
    j = JSchedule.create()
    assert BETAS.dtype == np.float64 and BETAS.shape == (j.num_train_timesteps,)
    # JAX keeps the float64 tables as float32
    np.testing.assert_allclose(ALPHAS_CUMPROD, j.alphas_cumprod, rtol=1e-6)
    np.testing.assert_allclose(BETAS, j.betas, rtol=1e-6)


@pytest.mark.parametrize("kind, start, end, n", [
    ("linear", 1e-4, 0.02, 1000), ("linear", 1e-3, 0.012, 500),
    ("scaled_linear", 8.5e-4, 0.012, 1000)])
def test_beta_schedules_match_jax(kind, start, end, n):
    """`betas` against `DiffusionSchedule.create`'s two schedules: float64
    here, the JAX package's float32 rounding of the same float64 tables
    (equal after the cast); an unknown schedule raises in both."""
    j = JSchedule.create(num_train_timesteps=n, beta_schedule=kind,
                         beta_start=start, beta_end=end)
    b = betas(kind, start, end, n)
    assert b.dtype == np.float64 and b.shape == (n,)
    np.testing.assert_array_equal(b.astype(np.float32), np.asarray(j.betas))
    np.testing.assert_array_equal(np.cumprod(1.0 - b).astype(np.float32),
                                  np.asarray(j.alphas_cumprod))
    with pytest.raises(ValueError, match="unknown beta schedule"):
        betas("cosine")
    with pytest.raises(ValueError, match="unknown beta schedule"):
        JSchedule.create(beta_schedule="cosine")


@pytest.mark.parametrize("steps", [1, 5, 50])
@pytest.mark.parametrize("with_aux", [False, True])
def test_sample_ddim_matches_jax(steps, with_aux):
    x = normal(np.random.default_rng(0), 2, 4, 4, 3)
    aux = np.linspace(0.5, 1.5, steps).astype(np.float32)

    def j_eps(x, t, a=1.0):
        return 0.3 * x * a + 1e-3 * t[:, None, None, None]

    def t_eps(x, t, a=1.0):
        return 0.3 * x * a + 1e-3 * t[:, None, None, None]

    ref = j_sample_ddim(j_eps, jnp.asarray(x), JSchedule.create(),
                        num_inference_steps=steps,
                        per_step_aux=jnp.asarray(aux) if with_aux else None)
    out = sample_ddim(t_eps, nchw(x), num_inference_steps=steps,
                      per_step_aux=list(map(float, aux)) if with_aux
                      else None)
    # float32 latents; the port takes the per-step constants in float64
    assert_close(nhwc(out), ref, rtol=1e-5, atol=1e-5)
