"""Distillation: progressive distillation of the DDIM sampler, and the
tiny-denoiser, tiny-CR and tiny-autoencoder students (counterpart of
hifidiff_tpu/train/distill.py).

Progressive distillation (Salimans & Ho, arXiv:2202.00512): a student with
N steps is trained so that one of its DDIM steps matches `substeps` of the
teacher's on the same trajectory (substeps 2 halves the step count; 5
distills the reference's 50 steps into 10 at once). One deterministic DDIM
step from alpha_bar a to a' is linear in the model output eps:

    x' = sqrt(a'/a) x + (sqrt(1-a') - sqrt(a'/a) sqrt(1-a)) eps

so the eps that lands on the teacher's result x'' in one step is

    eps~ = (x'' - sqrt(a'/a) x) / (sqrt(1-a') - sqrt(a'/a) sqrt(1-a))

and the loss is the x0-space error weighted by the truncated SNR
w = max(a / (1 - a), 1). The JAX package measured the 50 -> 10 student below
the naive 10-step teacher on its discriminating stack (DISTILL_QUALITY_R5
.json), and the tiny denoiser 2 dB under the full one (TINY_DN_QUALITY
.json): they are ported for completeness, not as a sanctioned fast mode.

Each factory returns `step(state, ...) -> (state, metrics)`, as
`train/steps.py`'s do: the `TrainState` holds the student; teachers and
frozen networks run under `torch.no_grad()` in eval mode. Randomness is
explicit: the noise, timesteps and student-step indices are optional
tensors, drawn from the `generator` argument where absent, in the order of
the step's arguments. Everything runs on the card: `device=None` means
`torch.device("cuda")` and raises without one; pass `device="cpu"` for the
CPU, as the tests do. The DDIM constants are float64 tables; a step reads
them rounded to float32, the values the JAX package holds.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from hifidiff_tpu_torch.devices import resolve_device
from hifidiff_tpu_torch.diffusion.sampling import ddim_timesteps
from hifidiff_tpu_torch.diffusion.schedule import (ALPHAS_CUMPROD,
                                                   NUM_TRAIN_TIMESTEPS)
from hifidiff_tpu_torch.parallel.distributed import global_means
from hifidiff_tpu_torch.train.losses import mse_loss
from hifidiff_tpu_torch.train.steps import (Device, Metrics, TrainState,
                                            _check_state, _finish, _frozen,
                                            _normal, _random_input, _rows,
                                            _timesteps, _to_range)
from hifidiff_tpu_torch.vae.model import SD_VAE_SCALING


def _per_sample(a: torch.Tensor, ndim: int) -> torch.Tensor:
    return a.reshape((-1,) + (1,) * (ndim - 1))


def ddim_step(x: torch.Tensor, eps: torch.Tensor, alpha_t: torch.Tensor,
              alpha_prev: torch.Tensor, clip_sample: bool = False,
              clip_sample_range: float = 1.0) -> torch.Tensor:
    """One deterministic DDIM step (eta 0) with per-sample alphas (B,)."""
    a_t = _per_sample(alpha_t, x.dim())
    a_p = _per_sample(alpha_prev, x.dim())
    x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    if clip_sample:
        x0 = x0.clamp(-clip_sample_range, clip_sample_range)
    return torch.sqrt(a_p) * x0 + torch.sqrt(1.0 - a_p) * eps


def distill_eps_target(x_t: torch.Tensor, x_two: torch.Tensor,
                       alpha_t: torch.Tensor,
                       alpha_prev: torch.Tensor) -> torch.Tensor:
    """The one-step DDIM eps that maps x_t (at alpha_t) to the teacher's
    result x_two (at alpha_prev): `ddim_step` inverted, without clipping."""
    a_t = _per_sample(alpha_t, x_t.dim())
    a_p = _per_sample(alpha_prev, x_t.dim())
    ratio = torch.sqrt(a_p / a_t)
    denom = torch.sqrt(1.0 - a_p) - ratio * torch.sqrt(1.0 - a_t)
    return (x_two - ratio * x_t) / denom


def student_step_tables(num_student_steps: int,
                        substeps: int = 2) -> Dict[str, np.ndarray]:
    """Per-student-step float64 tables. One student step from t = ts[i]
    spans `substeps` teacher DDIM steps on the (N * substeps)-step grid, so
    the student's step ratio must divide by `substeps`.

      t          (N,)     the student's timestep
      t_sub      (N, k)   the teacher's timesteps per sub-step, clamped to 0
                          (once the running alpha reaches 1 the step is the
                          identity, whatever t the embedding sees)
      alpha_sub  (N, k+1) alpha_bar waypoints: [:, 0] the student's alpha_t,
                          [:, k] its alpha_prev (1 after the last step)."""
    k = substeps
    r = NUM_TRAIN_TIMESTEPS // num_student_steps
    if r % k:
        raise ValueError(
            f"student step ratio {NUM_TRAIN_TIMESTEPS}/{num_student_steps}="
            f"{r} must be divisible by substeps={k} so the teacher grid "
            "subdivides the student grid")
    ts = ddim_timesteps(num_student_steps)
    sub = ts[:, None] - (r // k) * np.arange(k + 1)[None, :]
    alpha = np.where(sub >= 0, ALPHAS_CUMPROD[np.clip(sub, 0, None)], 1.0)
    return {"t": ts.astype(np.float64),
            "t_sub": np.maximum(sub[:, :k], 0).astype(np.float64),
            "alpha_sub": alpha}


def _f32(table: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(table.astype(np.float32)).to(device)


def _conditioning(cr_model, vae, batch, hf_posterior_noise,
                  cr_posterior_noise, generator, device, scaling, group):
    """Without gradient: the target's latent, the CR face and its latent,
    the VAE posteriors sampled (the refiner step's conditioning)."""
    def encode(images, given, what):
        mean, logvar = vae.moments(_to_range(images))
        eps = _normal(given, mean.shape, generator, device, what, group)
        return (mean + torch.exp(0.5 * logvar) * eps) * scaling

    with torch.no_grad():
        hf_latent = encode(batch["gt"].to(device), hf_posterior_noise,
                           "hf_posterior_noise")
        cr_face = cr_model(batch["lr"].to(device))
        cr_latent = encode(cr_face, cr_posterior_noise, "cr_posterior_noise")
    return hf_latent, cr_face, cr_latent


def _student_steps(given, batch: int, n: int, stratified: bool,
                   generator, device, group) -> torch.Tensor:
    def draw(gen):
        if stratified:
            # as the JAX package draws it: a permutation of arange(b) % n
            # over the global batch b, so with b < n the steps >= b are
            # never drawn (ROADMAP §C)
            def rows(shape):
                perm = torch.randperm(shape[0], generator=gen,
                                      device=gen.device).cpu()
                return (torch.arange(shape[0]) % n)[perm]
        else:
            def rows(shape):
                return torch.randint(0, n, shape, generator=gen,
                                     device=gen.device)
        return _rows(rows, (batch,), group).to(device)

    if given is not None:
        return _random_input("student_steps", draw, given.to(device).long())
    if generator is None:
        raise ValueError("pass the student steps or a torch.Generator to "
                         "draw them from")
    return _random_input("student_steps", draw, draw(generator))


def make_distill_train_step(cr_model: nn.Module, vae: nn.Module,
                            num_student_steps: int, substeps: int = 2,
                            clip_sample: bool = False,
                            clip_sample_range: float = 1.0,
                            stratified: bool = False,
                            scaling: float = SD_VAE_SCALING,
                            device: Device = None) -> Callable:
    """Progressive distillation of the conditional refiner:
    `step(state, teacher, batch, hf_posterior_noise=None,
    cr_posterior_noise=None, student_steps=None, noise=None,
    generator=None)`. `state` holds the student (made as a copy of the
    teacher), `teacher` the frozen FacialRefiner, batch {"lr", "gt"}
    (B, 3, H, W) in [0, 1].

    Per sample: a student step i (uniform, or with `stratified` a
    permutation of arange(B) % N, bug-compatible with the JAX package), the
    target's latent forward-diffused to t = ts[i], the teacher's `substeps`
    DDIM sub-steps, the eps target solved, and the truncated-SNR-weighted
    x0-space MSE of the student's eps in training mode. Metrics: loss."""
    device = resolve_device(device, "make_distill_train_step")
    cr_model, vae = _frozen(cr_model, device), _frozen(vae, device)
    tab = {k: _f32(v, device) for k, v in student_step_tables(
        num_student_steps, substeps).items()}

    def step(state: TrainState, teacher: nn.Module, batch,
             hf_posterior_noise=None, cr_posterior_noise=None,
             student_steps=None, noise=None, generator=None
             ) -> Tuple[TrainState, Metrics]:
        _check_state(state, device, "distill train step")
        teacher = teacher.eval()
        hf_latent, cr_face, cr_latent = _conditioning(
            cr_model, vae, batch, hf_posterior_noise, cr_posterior_noise,
            generator, device, scaling, state.group)
        b, nd = hf_latent.shape[0], hf_latent.dim()
        i = _student_steps(student_steps, b, num_student_steps, stratified,
                           generator, device, state.group)
        t, a_sub, t_sub = tab["t"][i], tab["alpha_sub"][i], tab["t_sub"][i]
        a_t, a_prev = a_sub[:, 0], a_sub[:, -1]
        eps = _normal(noise, hf_latent.shape, generator, device, "noise",
                      state.group)
        x_t = (torch.sqrt(_per_sample(a_t, nd)) * hf_latent
               + torch.sqrt(1.0 - _per_sample(a_t, nd)) * eps)
        with torch.no_grad():
            x = x_t
            for j in range(substeps):
                eps_t = teacher(x, t_sub[:, j], cr_face, cr_latent)
                x = ddim_step(x, eps_t, a_sub[:, j], a_sub[:, j + 1],
                              clip_sample, clip_sample_range)
            target = distill_eps_target(x_t, x, a_t, a_prev)
        a_b = _per_sample(a_t, nd)
        w = torch.clamp(a_b / (1.0 - a_b), min=1.0)
        eps_s = state.module.train()(x_t, t, cr_face, cr_latent)
        x0_err = torch.sqrt(1.0 - a_b) / torch.sqrt(a_b) * (eps_s - target)
        return _finish(state, (w * x0_err.square()).mean(), b)

    return step


def make_tiny_dn_train_step(cr_model: nn.Module, vae: nn.Module,
                            rollout_steps: int = 10, fwd_weight: float = 0.5,
                            clip_sample: bool = False,
                            clip_sample_range: float = 1.0,
                            scaling: float = SD_VAE_SCALING,
                            device: Device = None) -> Callable:
    """Width distillation of the denoiser: `step(state, teacher, batch,
    hf_posterior_noise=None, cr_posterior_noise=None, latents_noise=None,
    fwd_timesteps=None, noise=None, generator=None, update=True)`. `state`
    holds a narrower FacialRefiner, `teacher` the frozen full-width one.

    On-policy (weight 1): the teacher's `rollout_steps` DDIM steps from
    `latents_noise`, and the student's eps at every (x_t, t) visited in one
    (K*B)-batch call against the teacher's. Forward-diffused (weight
    `fwd_weight`): the target's latent at uniform timesteps, the student
    against the teacher there. Both student calls in training mode, the
    second seeing the BatchNorm statistics the first left. Metrics: loss,
    onpolicy_loss, fwd_loss. With `update=False` the step computes the
    metrics without a gradient and leaves the state (the BatchNorm
    statistics included) as it was: the JAX CLI's validation, which runs the
    step and drops its new state."""
    device = resolve_device(device, "make_tiny_dn_train_step")
    cr_model, vae = _frozen(cr_model, device), _frozen(vae, device)
    ts = ddim_timesteps(rollout_steps)
    prev = ts - NUM_TRAIN_TIMESTEPS // rollout_steps
    tab_t = _f32(ts.astype(np.float64), device)
    tab_a = _f32(ALPHAS_CUMPROD[ts], device)
    tab_prev = _f32(np.where(prev >= 0, ALPHAS_CUMPROD[np.clip(prev, 0, None)],
                             1.0), device)
    acp = _f32(ALPHAS_CUMPROD, device)

    def step(state: TrainState, teacher: nn.Module, batch,
             hf_posterior_noise=None, cr_posterior_noise=None,
             latents_noise=None, fwd_timesteps=None, noise=None,
             generator=None, update: bool = True
             ) -> Tuple[TrainState, Metrics]:
        _check_state(state, device, "tiny-dn train step")
        teacher = teacher.eval()
        hf_latent, cr_face, cr_latent = _conditioning(
            cr_model, vae, batch, hf_posterior_noise, cr_posterior_noise,
            generator, device, scaling, state.group)
        b, nd = hf_latent.shape[0], hf_latent.dim()
        x = _normal(latents_noise, hf_latent.shape, generator, device,
                    "latents_noise", state.group)
        t_fwd = _timesteps(fwd_timesteps, b, generator, device, state.group,
                           "fwd_timesteps")
        eps = _normal(noise, hf_latent.shape, generator, device, "noise",
                      state.group)
        with torch.no_grad():
            xs, eps_on = [], []
            for k in range(rollout_steps):
                e = teacher(x, tab_t[k].expand(b), cr_face, cr_latent)
                xs.append(x)
                eps_on.append(e)
                x = ddim_step(x, e, tab_a[k].expand(b), tab_prev[k].expand(b),
                              clip_sample, clip_sample_range)
            xs, eps_on = torch.cat(xs), torch.cat(eps_on)
            t_on = tab_t.repeat_interleave(b)
            a_fwd = _per_sample(acp[t_fwd], nd)
            x_fwd = torch.sqrt(a_fwd) * hf_latent \
                + torch.sqrt(1.0 - a_fwd) * eps
            t_fwd = t_fwd.float()
            eps_fwd = teacher(x_fwd, t_fwd, cr_face, cr_latent)
        student = state.module.train()
        saved = None if update else {
            n: v.clone() for n, v in student.named_buffers()}
        with torch.set_grad_enabled(update):
            tile = (rollout_steps,) + (1,) * (nd - 1)
            on_loss = mse_loss(student(xs, t_on, cr_face.repeat(tile),
                                       cr_latent.repeat(tile)), eps_on)
            fwd_loss = mse_loss(student(x_fwd, t_fwd, cr_face, cr_latent),
                                eps_fwd)
            loss = on_loss + fwd_weight * fwd_loss
        if update:
            return _finish(state, loss, b, onpolicy_loss=on_loss,
                           fwd_loss=fwd_loss)
        with torch.no_grad():
            for n, v in student.named_buffers():
                v.copy_(saved[n])
        return state, global_means(
            {"loss": loss, "onpolicy_loss": on_loss, "fwd_loss": fwd_loss},
            b, state.group, equal_rows=True)

    return step


def make_tiny_cr_train_step(cr_model: nn.Module, gt_weight: float = 0.3,
                            device: Device = None) -> Callable:
    """The tiny CR against the frozen exact CR: `step(state, batch)`, batch
    {"lr", and optionally "gt"} (B, 3, H, W) in [0, 1]; deterministic. Loss
    MSE(tiny(lr), cr(lr)) + gt_weight * MSE(tiny(lr), gt), on the CR's
    unclipped output. Metrics: loss, teacher_loss, gt_loss."""
    device = resolve_device(device, "make_tiny_cr_train_step")
    cr_model = _frozen(cr_model, device)

    def step(state: TrainState, batch) -> Tuple[TrainState, Metrics]:
        _check_state(state, device, "tiny-cr train step")
        lr = batch["lr"].to(device)
        with torch.no_grad():
            teacher = cr_model(lr)
        out = state.module.train()(lr)
        t_loss = mse_loss(out, teacher)
        g_loss = mse_loss(out, batch["gt"].to(device)) if "gt" in batch \
            else torch.zeros((), device=device)
        return _finish(state, t_loss + gt_weight * g_loss, len(lr),
                       teacher_loss=t_loss, gt_loss=g_loss)

    return step


def make_tae_train_step(vae: nn.Module, gt_weight: float = 0.3,
                        device: Device = None) -> Callable:
    """The tiny autoencoder against the frozen SD VAE:
    `step(state, batch, posterior_noise=None, generator=None)`; `state`
    holds `nn.ModuleDict({"enc": TinyEncoder, "dec": TinyDecoder})`, batch
    {"image" (B, 3, H, W) in [0, 1], optionally "extra_z" (N, 4, h, w)
    unscaled latents from the sampler}. In the teacher's conventions
    ([-1, 1] images, unscaled latents): dec MSE(dec(z), vae_dec(z)) +
    gt_weight * MSE(dec(z), x) with z the sampled posterior, plus
    MSE(dec(z'), vae_dec(z')) on the extra latents; enc MSE(enc(x),
    posterior mean). Metrics: loss, dec_loss, enc_loss."""
    device = resolve_device(device, "make_tae_train_step")
    vae = _frozen(vae, device)

    def step(state: TrainState, batch, posterior_noise=None,
             generator=None) -> Tuple[TrainState, Metrics]:
        _check_state(state, device, "tae train step")
        x = _to_range(batch["image"].to(device))
        extra_z = batch.get("extra_z")
        with torch.no_grad():
            mean, logvar = vae.moments(x)
            eps = _normal(posterior_noise, mean.shape, generator, device,
                          "posterior_noise", state.group)
            z = mean + torch.exp(0.5 * logvar) * eps
            teacher_img = vae.decode(z)
            if extra_z is not None:
                extra_z = extra_z.to(device)
                extra_img = vae.decode(extra_z)
        pair = state.module.train()
        rec = pair["dec"](z)
        dec_loss = mse_loss(rec, teacher_img) + gt_weight * mse_loss(rec, x)
        if extra_z is not None:
            dec_loss = dec_loss + mse_loss(pair["dec"](extra_z), extra_img)
        enc_loss = mse_loss(pair["enc"](x), mean)
        return _finish(state, dec_loss + enc_loss, len(x), dec_loss=dec_loss,
                       enc_loss=enc_loss)

    return step
