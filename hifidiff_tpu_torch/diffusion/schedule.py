"""The diffusion noise schedule as constant float64 numpy tables: the
counterpart of hifidiff_tpu/diffusion/schedule.py at its defaults, the one
schedule the refiner is trained and sampled with. 1000 train timesteps,
`scaled_linear` betas (linspace from sqrt(1e-4) to sqrt(0.02), squared) and
their cumulative alpha products; `add_noise` is the forward process that
training draws its noisy latents with."""

import numpy as np
import torch

NUM_TRAIN_TIMESTEPS = 1000
BETAS = np.linspace(1e-4 ** 0.5, 0.02 ** 0.5, NUM_TRAIN_TIMESTEPS,
                    dtype=np.float64) ** 2
ALPHAS_CUMPROD = np.cumprod(1.0 - BETAS)
BETAS.flags.writeable = False
ALPHAS_CUMPROD.flags.writeable = False


def add_noise(x0, noise, t):
    """The forward process `x_t = sqrt(abar_t) * x0 + sqrt(1 - abar_t) * eps`
    for integer timesteps t (B,); x0 and noise (B, ...) torch tensors. The
    table is rounded to float32 before the square roots, as the JAX package
    holds it."""
    acp = torch.from_numpy(ALPHAS_CUMPROD.astype(np.float32)).to(x0.device)[
        t.to(x0.device).long()]
    shape = (-1,) + (1,) * (x0.dim() - 1)
    return torch.sqrt(acp).reshape(shape) * x0 \
        + torch.sqrt(1.0 - acp).reshape(shape) * noise
