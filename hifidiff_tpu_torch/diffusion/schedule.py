"""The diffusion noise schedule as constant float64 numpy tables: the
counterpart of hifidiff_tpu/diffusion/schedule.py at its defaults, the one
schedule the refiner is trained and sampled with. 1000 train timesteps,
`scaled_linear` betas (linspace from sqrt(1e-4) to sqrt(0.02), squared) and
their cumulative alpha products; `add_noise` is the forward process that
training draws its noisy latents with. `betas` also gives the JAX package's
other schedule, `linear` (linspace from beta_start to beta_end), and other
ends or lengths, as `DiffusionSchedule.create` takes them."""

import numpy as np
import torch

NUM_TRAIN_TIMESTEPS = 1000


def betas(beta_schedule: str = "scaled_linear", beta_start: float = 1e-4,
          beta_end: float = 0.02,
          num_train_timesteps: int = NUM_TRAIN_TIMESTEPS) -> np.ndarray:
    """The float64 beta table: `scaled_linear` (linspace between the square
    roots, squared) or `linear`; the cumulative alpha products are
    `np.cumprod(1 - betas)`."""
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                           num_train_timesteps, dtype=np.float64) ** 2
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float64)
    raise ValueError(f"unknown beta schedule: {beta_schedule}")


BETAS = betas()
ALPHAS_CUMPROD = np.cumprod(1.0 - BETAS)
BETAS.flags.writeable = False
ALPHAS_CUMPROD.flags.writeable = False


_ACP_ON = {}


def _alphas_cumprod(device: torch.device) -> torch.Tensor:
    """The float32 table on `device`, copied there once: a step captured as
    a CUDA graph cannot copy from the host."""
    table = _ACP_ON.get(device)
    if table is None:
        table = _ACP_ON[device] = torch.from_numpy(
            ALPHAS_CUMPROD.astype(np.float32)).to(device)
    return table


def add_noise(x0, noise, t):
    """The forward process `x_t = sqrt(abar_t) * x0 + sqrt(1 - abar_t) * eps`
    for integer timesteps t (B,); x0 and noise (B, ...) torch tensors. The
    table is rounded to float32 before the square roots, as the JAX package
    holds it."""
    acp = _alphas_cumprod(x0.device)[t.to(x0.device).long()]
    shape = (-1,) + (1,) * (x0.dim() - 1)
    return torch.sqrt(acp).reshape(shape) * x0 \
        + torch.sqrt(1.0 - acp).reshape(shape) * noise
