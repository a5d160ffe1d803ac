"""Reverse-diffusion samplers as Python loops (counterpart of
hifidiff_tpu/diffusion/sampling.py): DDIM (deterministic or stochastic),
DDIM with encoder-propagation caching, DPM-Solver++ (2M) and ancestral DDPM.
Epsilon prediction, diffusers' "leading" timestep spacing, alpha_bar 1 as the
final step's target.

The per-step constants are Python floats (float64) computed before the loop,
and no loop body reads anything back from the device, so a loop never waits
on the card and can be captured as a CUDA graph. The JAX package draws the
stochastic samplers' noise from per-step keys inside its scan; here the noise
of every step is a tensor (S, *latents.shape) given as `step_noise`, or drawn
from a `torch.Generator` before the loop.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from hifidiff_tpu_torch.diffusion.schedule import (ALPHAS_CUMPROD, BETAS,
                                                   NUM_TRAIN_TIMESTEPS)


def ddim_timesteps(num_inference_steps: int) -> np.ndarray:
    """diffusers 'leading' spacing: descending [.., 2r, r, 0]."""
    step_ratio = NUM_TRAIN_TIMESTEPS // num_inference_steps
    ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1]
    return ts.astype(np.int64)


def _ddim_alphas(num_inference_steps: int):
    """(timesteps, alpha_bar at each, alpha_bar at each step's target), the
    last target 1 (diffusers' set_alpha_to_one)."""
    ts = ddim_timesteps(num_inference_steps)
    prev_ts = ts - NUM_TRAIN_TIMESTEPS // num_inference_steps
    a_prev = np.where(prev_ts >= 0, ALPHAS_CUMPROD[np.clip(prev_ts, 0, None)],
                      1.0)
    return ts, ALPHAS_CUMPROD[ts], a_prev


def _step_noise(step_noise: Optional[torch.Tensor],
                generator: Optional[torch.Generator], steps: int,
                latents: torch.Tensor, who: str) -> torch.Tensor:
    """The noise of every step, (steps, *latents.shape), on the latents'
    device and in their dtype: `step_noise`, or drawn from `generator`."""
    shape = (steps, *latents.shape)
    if step_noise is None:
        if generator is None:
            raise ValueError(f"{who} needs `step_noise` {shape} or a "
                             "torch.Generator to draw it from")
        return torch.randn(shape, generator=generator, device=latents.device,
                           dtype=latents.dtype)
    if tuple(step_noise.shape) != shape:
        raise ValueError(f"{who}: step_noise must be {shape}, got "
                         f"{tuple(step_noise.shape)}")
    return step_noise.to(latents.device, latents.dtype)


def _x0(x: torch.Tensor, eps: torch.Tensor, a_t: float, clip_sample: bool,
        clip_sample_range: float) -> torch.Tensor:
    x0 = (x - math.sqrt(1.0 - a_t) * eps) / math.sqrt(a_t)
    return x0.clamp(-clip_sample_range, clip_sample_range) if clip_sample \
        else x0


def _call(fn: Callable, per_step_aux: Optional[Sequence], k: int, *args):
    return fn(*args) if per_step_aux is None else fn(*args, per_step_aux[k])


def sample_ddim(eps_fn: Callable, latents: torch.Tensor,
                num_inference_steps: int = 50, eta: float = 0.0,
                clip_sample: bool = False, clip_sample_range: float = 1.0,
                step_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                per_step_aux: Optional[Sequence] = None) -> torch.Tensor:
    """DDIM from the initial noise `latents` (float32): deterministic at
    `eta` 0, stochastic above, where each step adds `sigma * noise[k]` from
    `step_noise` (S, *latents.shape) or from noise drawn from `generator`
    before the loop. `clip_sample` clips each step's x0 prediction to
    +-`clip_sample_range`.

    eps_fn(x, t_batch) -> epsilon, or eps_fn(x, t_batch, aux) with
    `per_step_aux[k]` for step k (the hoisted FiLM tables)."""
    ts, a_ts, a_prevs = _ddim_alphas(num_inference_steps)
    noise = (_step_noise(step_noise, generator, num_inference_steps, latents,
                         "sample_ddim with eta > 0") if eta > 0.0 else None)
    batch = latents.shape[0]
    x = latents
    for k, t in enumerate(ts):
        a_t, a_prev = float(a_ts[k]), float(a_prevs[k])
        t_batch = torch.full((batch,), float(t), device=x.device)
        eps = _call(eps_fn, per_step_aux, k, x, t_batch).float()
        x0 = _x0(x, eps, a_t, clip_sample, clip_sample_range)
        sigma = eta * math.sqrt((1.0 - a_prev) / (1.0 - a_t)
                                * (1.0 - a_t / a_prev)) if eta > 0.0 else 0.0
        x = math.sqrt(a_prev) * x0 + math.sqrt(1.0 - a_prev - sigma ** 2) * eps
        if sigma > 0.0:
            x = x + sigma * noise[k]
    return x


def sample_ddim_cached(encode_fn: Callable, decode_fn: Callable,
                       latents: torch.Tensor, num_inference_steps: int = 50,
                       cache_interval: int = 1, clip_sample: bool = False,
                       clip_sample_range: float = 1.0,
                       per_step_aux: Optional[Sequence] = None
                       ) -> torch.Tensor:
    """Deterministic DDIM with encoder-propagation caching: steps 0,
    `cache_interval`, 2 * `cache_interval`, ... run the full network and
    refresh the cache (`encode_fn`: the conditioned bottleneck and the
    skips); every step runs the decoder half on the cache with its own
    timestep (`decode_fn`). Interval 1 is `sample_ddim` at eta 0. Which steps
    refresh is fixed before the loop (Python booleans; the JAX package takes
    a `lax.cond` per step).

    encode_fn(x, t_batch) -> cache, decode_fn(cache, t_batch) -> epsilon;
    with `per_step_aux`, both get `per_step_aux[k]` as a third argument."""
    ts, a_ts, a_prevs = _ddim_alphas(num_inference_steps)
    interval = max(1, cache_interval)
    batch = latents.shape[0]
    x, cache = latents, None
    for k, t in enumerate(ts):
        t_batch = torch.full((batch,), float(t), device=x.device)
        if k % interval == 0:
            cache = _call(encode_fn, per_step_aux, k, x, t_batch)
        eps = _call(decode_fn, per_step_aux, k, cache, t_batch).float()
        x0 = _x0(x, eps, float(a_ts[k]), clip_sample, clip_sample_range)
        a_prev = float(a_prevs[k])
        x = math.sqrt(a_prev) * x0 + math.sqrt(1.0 - a_prev) * eps
    return x


def dpmpp_2m_coeffs(num_inference_steps: int) -> Dict[str, np.ndarray]:
    """Per-step constants of DPM-Solver++ (2M), float64: the timesteps (the
    DDIM 'leading' grid), alpha_bar at each, and the coefficients of
    `x_next = c_x * x + c_d0 * m0 + c_d1 * (m0 - m_prev)`. With alpha =
    sqrt(alpha_bar), sigma = sqrt(1 - alpha_bar), lambda = ln(alpha / sigma)
    and h the step in lambda. The final target is alpha_bar 1 (sigma 0,
    lambda infinite), so the first and the last step are first order
    (diffusers' lower_order_final), and a masked h keeps every coefficient
    finite."""
    ts = ddim_timesteps(num_inference_steps)
    prev_ts = ts - NUM_TRAIN_TIMESTEPS // num_inference_steps
    acp_t = ALPHAS_CUMPROD[ts]
    acp_next = np.where(prev_ts >= 0,
                        ALPHAS_CUMPROD[np.clip(prev_ts, 0, None)], 1.0)
    alpha_t, sigma_t = np.sqrt(acp_t), np.sqrt(1.0 - acp_t)
    alpha_n, sigma_n = np.sqrt(acp_next), np.sqrt(1.0 - acp_next)
    lam_t = np.log(alpha_t) - np.log(np.maximum(sigma_t, 1e-300))
    lam_n = np.log(alpha_n) - np.log(np.maximum(sigma_n, 1e-300))
    h = lam_n - lam_t
    finite = np.isfinite(h)
    h_safe = np.where(finite, h, 1.0)
    ehm1 = np.where(finite, np.expm1(-h_safe), -1.0)
    c_x = np.where(sigma_t > 0, sigma_n / np.maximum(sigma_t, 1e-300), 0.0)
    c_d0 = -alpha_n * ehm1
    r0 = np.concatenate([[1.0], h_safe[:-1]]) / h_safe
    second = np.ones(num_inference_steps, bool)
    second[0] = second[-1] = False
    c_d1 = np.where(second, c_d0 * 0.5 / r0, 0.0)
    return {"t": ts.astype(np.float64), "acp_t": acp_t, "c_x": c_x,
            "c_d0": c_d0, "c_d1": c_d1}


def sample_dpmpp_2m(eps_fn: Callable, latents: torch.Tensor,
                    num_inference_steps: int = 20, clip_sample: bool = False,
                    clip_sample_range: float = 1.0,
                    per_step_aux: Optional[Sequence] = None) -> torch.Tensor:
    """DPM-Solver++ (2M), diffusers' DPMSolverMultistepScheduler semantics
    (dpmsolver++, order 2, midpoint, epsilon prediction, final sigma 0) on
    the DDIM grid. The solver's arithmetic is float32; the sample it carries
    keeps the dtype of `latents`. Per step:
        m0     = (x - sigma_t * eps) / alpha_t
        x_next = c_x * x + c_d0 * m0 + c_d1 * (m0 - m_prev)
    `eps_fn` and `per_step_aux` as in `sample_ddim`."""
    co = dpmpp_2m_coeffs(num_inference_steps)
    batch = latents.shape[0]
    x, m_prev = latents, None
    for k in range(num_inference_steps):
        t_batch = torch.full((batch,), float(co["t"][k]), device=x.device)
        eps = _call(eps_fn, per_step_aux, k, x, t_batch).float()
        xf = x.float()
        m0 = _x0(xf, eps, float(co["acp_t"][k]), clip_sample,
                 clip_sample_range)
        x_next = float(co["c_x"][k]) * xf + float(co["c_d0"][k]) * m0
        if co["c_d1"][k] != 0.0:
            x_next = x_next + float(co["c_d1"][k]) * (m0 - m_prev)
        x, m_prev = x_next.to(latents.dtype), m0
    return x


def sample_ddpm(eps_fn: Callable, latents: torch.Tensor,
                step_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                clip_sample: bool = True,
                clip_sample_range: float = 1.0) -> torch.Tensor:
    """Ancestral DDPM over all 1000 training timesteps (fixed_small
    variance), diffusers' DDPMScheduler.step semantics: the posterior mean
    of x_{t-1} given x_t and the clipped x0 prediction, plus `sigma_t *
    noise[k]` (sigma 0 at t = 0). The noise of every step is `step_noise`
    (1000, *latents.shape), or drawn from `generator` before the loop."""
    steps = NUM_TRAIN_TIMESTEPS
    noise = _step_noise(step_noise, generator, steps, latents, "sample_ddpm")
    ts = np.arange(steps)[::-1]
    a_t = ALPHAS_CUMPROD[ts]
    a_prev = np.where(ts >= 1, ALPHAS_CUMPROD[np.clip(ts - 1, 0, None)], 1.0)
    beta_t = BETAS[ts]
    x0_coef = np.sqrt(a_prev) * beta_t / (1.0 - a_t)
    xt_coef = np.sqrt(1.0 - beta_t) * (1.0 - a_prev) / (1.0 - a_t)
    sigma = np.sqrt(np.clip((1.0 - a_prev) / (1.0 - a_t) * beta_t, 1e-20,
                            None)) * (ts > 0)
    batch = latents.shape[0]
    x = latents
    for k, t in enumerate(ts):
        t_batch = torch.full((batch,), float(t), device=x.device)
        eps = eps_fn(x, t_batch).float()
        x0 = _x0(x, eps, float(a_t[k]), clip_sample, clip_sample_range)
        x = float(x0_coef[k]) * x0 + float(xt_coef[k]) * x
        if sigma[k] > 0.0:
            x = x + float(sigma[k]) * noise[k]
    return x
