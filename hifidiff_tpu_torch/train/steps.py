"""The training steps of the four stages, the VAE step and the cached-latent
denoiser step (counterpart of hifidiff_tpu/train/steps.py).

Each factory returns `step(state, batch, ...) -> (state, metrics)`. The
`TrainState` holds the module under training, its optimizer and schedule, the
step count and an optional EMA copy of the parameters; a step updates it in
place and returns it. Frozen networks (the CR under the IDC and the refiner,
the VAE under the denoiser and the refiner) are arguments of the factory and
run under `torch.no_grad()` in eval mode.

Stages (reference entry points):
  * CR       `train_cr.py:56-94`: cr_loss(pred, gt, patches), Adam.
  * IDC      `pretrain_idc.py:13-34`: triplet(IDC(CR(lr)), IDC(gt),
             IDC(other)), frozen CR; the BatchNorm statistics are updated by
             the anchor, the positive and the negative forward, in that order.
  * Denoiser `pretrain_denoiser.py:123-227`: VAE-encode, add noise at a
             uniform t, MSE(eps_hat, eps), AdamW + cosine.
  * Refiner  `train_refiner.py:128-209`: frozen CR and frozen VAE feed the
             FacialRefiner; partial freeze through `optim.refiner_freeze_mask`.

Randomness is explicit. Torch cannot reproduce JAX's PRNG streams, so a step
takes its Gaussian noise, its integer timesteps and the VAE posterior noise
as tensors; what is not given is drawn from the `generator` argument (a
`torch.Generator` on the state's device), and without either the step raises.

Everything runs on the card: `device=None` means `torch.device("cuda")` and
raises without one; pass `device="cpu"` for the CPU, as the tests do. On the
card `ln_film` and the warp run their hand-written forward and backward
kernels. The steps compute in the dtype of the module under training,
float32 as its parameters are made.

Data parallelism (one process per card, `TrainState.create(...,
group=mesh.data_group)`): each process steps on its own rows of the global
batch, rank 0's rows first, and the run equals one process stepping on the
concatenated batch, as the JAX steps jitted over a "data" mesh do. What
makes it so: the parameters start equal (`parallel.replicate_global`);
BatchNorm takes its training statistics over the global batch
(`parallel.sync_batch_norm`); what a step draws from `generator` is drawn
for the global batch on every process and each takes its rows
(`parallel.global_rows`; given tensors are this process's rows); the
optimizer step averages the gradients over the group in flat buckets
(`parallel.all_reduce_gradients`, once per `accumulate_steps`); and the
logged metrics are the global means.
"""

from __future__ import annotations

import contextvars
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from hifidiff_tpu_torch.devices import resolve_device
from hifidiff_tpu_torch.parallel.distributed import (all_reduce_gradients,
                                                     global_means,
                                                     global_rows,
                                                     sync_batch_norm)
from hifidiff_tpu_torch.parallel.mesh import replicate_global
from hifidiff_tpu_torch.diffusion.schedule import (NUM_TRAIN_TIMESTEPS,
                                                   add_noise)
from hifidiff_tpu_torch.train.losses import (cr_loss, mse_loss,
                                             triplet_margin_loss)
from hifidiff_tpu_torch.train.optim import Optim, trainable_parameters
from hifidiff_tpu_torch.vae.model import SD_VAE_SCALING

Device = Union[None, str, torch.device]
Metrics = Dict[str, torch.Tensor]

# while `train.graphs` warms a step up: the list that each random input of
# the step is appended to, as (name, draw, value), in the order the step
# draws
DRAWS: contextvars.ContextVar[Optional[List]] = contextvars.ContextVar(
    "DRAWS", default=None)


def _random_input(what: str, draw: Callable[[torch.Generator], torch.Tensor],
                  value: torch.Tensor) -> torch.Tensor:
    """`value`, the step's random input `what`; tells a capture what the
    step draws: `draw(generator)` makes the input as the step makes it
    where it is not given."""
    seen = DRAWS.get()
    if seen is not None:
        seen.append((what, draw, value))
    return value


class TrainState:
    """The module under training with its optimizer, schedule, step count and
    optional EMA of the parameters (`ema_decay` 0 turns it off). `step`
    counts calls of `apply_gradients`, accumulation mini-steps included, as
    the JAX package's state counts them. `group` is the data-parallel
    process group (None: this process alone)."""

    def __init__(self, module: nn.Module, optim: Optim,
                 ema_decay: float = 0.0, group=None):
        self.module = module
        self.group = group
        self.optimizer, self.scheduler, self.accumulate_steps = optim
        self.step = 0
        self.mini_step = 0
        self.ema_decay = float(ema_decay)
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None
        # set by `train.graphs` while it runs a captured step's body: whether
        # this call applies the update (see `apply_gradients`)
        self.graph_applies: Optional[bool] = None
        if ema_decay:
            self.ema_params = {n: p.detach().clone()
                               for n, p in module.named_parameters()}

    @classmethod
    def create(cls, module: nn.Module,
               make_optim: Callable[[list], Optim], ema_decay: float = 0.0,
               device: Device = None, group=None) -> "TrainState":
        """Move `module` to the device (the card unless `device="cpu"`), then
        build the optimizer over its trainable parameters with
        `make_optim(params)` (`optim.adam`, `optim.adamw_cosine` or a
        `functools.partial` of them). Freeze parameters before this call.
        With a data-parallel `group`, every process of it must call this
        with the same module: its BatchNorms then reduce over the group and
        its parameters and buffers are checked equal and broadcast from the
        group's first process. Every step then needs as many rows on every
        process (the sharded `Loader` pads its shards so), and raises before
        the optimizer step where they differ."""
        device = resolve_device(device, "TrainState.create")
        module.to(device)
        if group is not None:
            sync_batch_norm(module, group)
            replicate_global(module, group)
        return cls(module, make_optim(trainable_parameters(module)),
                   ema_decay, group)

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    @property
    def eval_params(self) -> Dict[str, torch.Tensor]:
        """The EMA parameters when enabled, else the live ones, by name."""
        if self.ema_params is not None:
            return self.ema_params
        return {n: p.detach() for n, p in self.module.named_parameters()}

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The BatchNorm running statistics, by state-dict name."""
        return {n: b for n, b in self.module.named_buffers()
                if n.endswith(("running_mean", "running_var"))}

    @torch.no_grad()
    def apply_gradients(self) -> None:
        """One (mini-)step on the gradients that `backward()` left in the
        parameters' `.grad`: every `accumulate_steps`-th call applies the
        mean of the accumulated gradients and advances the schedule; the EMA
        follows the parameters after every call.

        Inside a captured step's body (`graph_applies` set) only the device
        work runs: the update where `graph_applies` says so, the gradients
        zeroed in place (a graph keeps them at fixed addresses) rather than
        dropped; the counters and the schedule are the host's, which
        `train.graphs` advances around each replay."""
        if self.graph_applies is not None:
            self._update(self.graph_applies, set_to_none=False)
            return
        self.mini_step += 1
        applies = self.mini_step == self.accumulate_steps
        self._update(applies, set_to_none=True)
        if applies:
            if self.scheduler is not None:
                self.scheduler.step()
            self.mini_step = 0
        self.step += 1

    def _update(self, applies: bool, set_to_none: bool) -> None:
        if applies:
            if self.group is not None:
                all_reduce_gradients(trainable_parameters(self.module),
                                     self.group)
            if self.accumulate_steps > 1:
                for p in trainable_parameters(self.module):
                    if p.grad is not None:
                        p.grad.div_(self.accumulate_steps)
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=set_to_none)
        if self.ema_params is not None:
            for n, p in self.module.named_parameters():
                if p.requires_grad:
                    self.ema_params[n].lerp_(p.to(self.ema_params[n].dtype),
                                             1.0 - self.ema_decay)

    def state_dict(self) -> Dict:
        return {"module": self.module.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": None if self.scheduler is None
                else self.scheduler.state_dict(),
                "step": self.step, "mini_step": self.mini_step,
                "grads": {n: p.grad for n, p in self.module.named_parameters()
                          if p.grad is not None} if self.mini_step else {},
                "ema_params": self.ema_params, "ema_decay": self.ema_decay}

    def load_state_dict(self, sd: Dict) -> None:
        self.module.load_state_dict(sd["module"])
        groups = [dict(g) for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(sd["optimizer"])
        keep_capturable(self.optimizer, groups)
        if self.scheduler is not None:
            self.scheduler.load_state_dict(sd["scheduler"])
        self.step, self.mini_step = sd["step"], sd["mini_step"]
        params = dict(self.module.named_parameters())
        self.optimizer.zero_grad(set_to_none=True)
        for n, g in sd["grads"].items():
            params[n].grad = g.to(params[n].device)
        self.ema_decay = sd["ema_decay"]
        self.ema_params = None if sd["ema_params"] is None else {
            n: e.to(self.device) for n, e in sd["ema_params"].items()}


def keep_capturable(optimizer: torch.optim.Optimizer, before) -> None:
    """After `optimizer.load_state_dict`, which takes the saved groups'
    settings: give each group back its own `capturable` flag and rate
    (`before`: the groups as they were), so that a state saved by an eager
    run loads into a captured one and the other way round. A device-tensor
    rate keeps its address (a captured step reads it there) and takes the
    saved value; a capturable optimizer's step counts go to its
    parameters' device, where it reads them."""
    for group, old in zip(optimizer.param_groups, before):
        group["capturable"] = old.get("capturable", False)
        rate = old["lr"]
        if isinstance(rate, torch.Tensor):
            rate.fill_(float(group["lr"]))
            group["lr"] = rate
        else:
            group["lr"] = float(group["lr"])
        if not group["capturable"]:
            continue
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if isinstance(st.get("step"), torch.Tensor):
                st["step"] = st["step"].to(p.device, torch.float32)


def _frozen(module: nn.Module, device: torch.device) -> nn.Module:
    return module.to(device).eval().requires_grad_(False)


def _check_state(state: TrainState, device: torch.device, who: str) -> None:
    if state.device.type != device.type:
        raise ValueError(f"{who}: the step was made for {device} and the "
                         f"state's module is on {state.device}")


def _rows(draw: Callable, shape, group) -> torch.Tensor:
    """`draw(shape)`, or this process's rows of the global batch's draw."""
    if group is None:
        return draw(tuple(shape))
    return global_rows(draw, shape, group)


def _normal(given: Optional[torch.Tensor], shape,
            generator: Optional[torch.Generator], device: torch.device,
            what: str, group=None) -> torch.Tensor:
    def draw(gen):
        return _rows(lambda s: torch.randn(s, generator=gen,
                                           device=gen.device),
                     shape, group).to(device)

    if given is not None:
        if tuple(given.shape) != tuple(shape):
            raise ValueError(f"{what} must be {tuple(shape)}, got "
                             f"{tuple(given.shape)}")
        return _random_input(what, draw, given.to(device))
    if generator is None:
        raise ValueError(f"pass {what} or a torch.Generator to draw it from")
    return _random_input(what, draw, draw(generator))


def _timesteps(given: Optional[torch.Tensor], batch: int,
               generator: Optional[torch.Generator],
               device: torch.device, group=None,
               what: str = "timesteps") -> torch.Tensor:
    def draw(gen):
        return _rows(lambda s: torch.randint(0, NUM_TRAIN_TIMESTEPS, s,
                                             generator=gen,
                                             device=gen.device),
                     (batch,), group).to(device)

    if given is not None:
        return _random_input(what, draw, given.to(device).long())
    if generator is None:
        raise ValueError("pass the timesteps or a torch.Generator to draw "
                         "them from")
    return _random_input(what, draw, draw(generator))


def _capturing() -> bool:
    return torch.cuda.is_available() \
        and torch.cuda.is_current_stream_capturing()


def _to_range(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] images -> the VAE's [-1, 1]."""
    return images.clamp(0.0, 1.0) * 2.0 - 1.0


def _finish(state: TrainState, loss: torch.Tensor, rows: int,
            **more) -> Tuple:
    """Backward, the step's metrics as global-batch means over `rows` rows a
    process (raising where the processes hold unequal batches), then the
    optimizer step."""
    loss.backward()
    # a capture cannot read the host; it checks the rows once, in its
    # warm-up, and the shapes are fixed
    metrics = global_means(
        {"loss": loss.detach(), **{k: v.detach() for k, v in more.items()}},
        rows, state.group, equal_rows=not _capturing())
    state.apply_gradients()
    return state, metrics


def make_cr_train_step(loss_fn: Optional[Callable] = None,
                       device: Device = None) -> Callable:
    """`step(state, batch)`, batch {"lr", "gt" (B, 3, H, W) in [0, 1],
    "patches" (B, P, 3, H, W)}. `loss_fn(pred, gt, patches)` defaults to
    `cr_loss`; pass a `composite_cr_loss` variant for the optional CRLoss."""
    device = resolve_device(device, "make_cr_train_step")
    loss_fn = loss_fn or cr_loss

    def step(state: TrainState, batch) -> Tuple[TrainState, Metrics]:
        _check_state(state, device, "cr train step")
        state.module.train()
        pred = state.module(batch["lr"].to(device))
        loss = loss_fn(pred, batch["gt"].to(device),
                       batch["patches"].to(device))
        return _finish(state, loss, len(pred))

    return step


def make_cr_eval_step(device: Device = None) -> Callable:
    """`step(model, batch) -> (pred, {"loss"})`, no gradient, eval mode."""
    device = resolve_device(device, "make_cr_eval_step")

    @torch.no_grad()
    def step(model: nn.Module, batch):
        pred = model.to(device).eval()(batch["lr"].to(device))
        return pred, {"loss": cr_loss(pred, batch["gt"].to(device),
                                      batch["patches"].to(device))}

    return step


def make_idc_train_step(cr_model: nn.Module,
                        device: Device = None) -> Callable:
    """Triplet pretraining of the IDC; the CR that produces the anchor is
    frozen. batch {"lr", "other", and "pos" (another photo of the identity)
    or else "gt"}."""
    device = resolve_device(device, "make_idc_train_step")
    cr_model = _frozen(cr_model, device)

    def step(state: TrainState, batch) -> Tuple[TrainState, Metrics]:
        _check_state(state, device, "idc train step")
        positive = batch["pos"] if "pos" in batch else batch["gt"]
        idc = state.module.train()
        with torch.no_grad():
            cr_face = cr_model(batch["lr"].to(device))
        # three forwards in this order: each updates the BatchNorm running
        # statistics the one before it left
        anchor = idc(cr_face)
        positive = idc(positive.to(device))
        negative = idc(batch["other"].to(device))
        loss = triplet_margin_loss(anchor, positive, negative)
        return _finish(state, loss, len(anchor))

    return step


def _denoiser_loss(state, latents, noise, timesteps, generator, device):
    noise = _normal(noise, latents.shape, generator, device, "noise",
                    state.group)
    t = _timesteps(timesteps, latents.shape[0], generator, device,
                   state.group)
    noisy = add_noise(latents, noise, t)
    state.module.train()
    return mse_loss(state.module(noisy, t.float()), noise)


def make_denoiser_train_step(vae: nn.Module,
                             scaling: float = SD_VAE_SCALING,
                             device: Device = None) -> Callable:
    """Unconditional latent-DDPM pretraining:
    `step(state, images, posterior_noise=None, noise=None, timesteps=None,
    generator=None)`, images (B, 3, H, W) in [0, 1]. The VAE is frozen. What
    is drawn from `generator` is drawn in the order posterior noise, noise,
    timesteps."""
    device = resolve_device(device, "make_denoiser_train_step")
    vae = _frozen(vae, device)

    def step(state: TrainState, images, posterior_noise=None, noise=None,
             timesteps=None, generator=None):
        _check_state(state, device, "denoiser train step")
        with torch.no_grad():
            mean, logvar = vae.moments(_to_range(images.to(device)))
        eps = _normal(posterior_noise, mean.shape, generator, device,
                      "posterior_noise", state.group)
        latents = (mean + torch.exp(0.5 * logvar) * eps) * scaling
        loss = _denoiser_loss(state, latents, noise, timesteps, generator,
                              device)
        return _finish(state, loss, len(latents))

    return step


def make_denoiser_train_step_cached(scaling: float = SD_VAE_SCALING,
                                    device: Device = None) -> Callable:
    """The denoiser step on cached posterior moments: the stage-3 VAE is
    frozen and the data is not augmented, so (mean, logvar) of every image
    are constants; `batch` is {"mean", "logvar"} (B, 4, h, w), unscaled, as
    `AutoencoderKL.moments` gives them. With the same posterior noise, noise
    and timesteps it computes what `make_denoiser_train_step` computes."""
    device = resolve_device(device, "make_denoiser_train_step_cached")

    def step(state: TrainState, batch, posterior_noise=None, noise=None,
             timesteps=None, generator=None):
        _check_state(state, device, "cached denoiser train step")
        mean = batch["mean"].to(device).float()
        logvar = batch["logvar"].to(device).float()
        eps = _normal(posterior_noise, mean.shape, generator, device,
                      "posterior_noise", state.group)
        latents = (mean + torch.exp(0.5 * logvar) * eps) * scaling
        loss = _denoiser_loss(state, latents, noise, timesteps, generator,
                              device)
        return _finish(state, loss, len(latents))

    return step


def make_vae_train_step(beta_kl: float = 1e-6,
                        device: Device = None) -> Callable:
    """Reconstruction + KL step for `AutoencoderKL` (the plain GroupNorm +
    SiLU path: the fused kernel is inference only):
    `step(state, batch, posterior_noise=None, generator=None)`, batch
    {"image" (B, 3, H, W) in [0, 1]}; metrics loss, rec, kl."""
    device = resolve_device(device, "make_vae_train_step")

    def step(state: TrainState, batch, posterior_noise=None, generator=None):
        _check_state(state, device, "vae train step")
        vae = state.module.train()
        x = _to_range(batch["image"].to(device))
        mean, logvar = vae.moments(x)
        eps = _normal(posterior_noise, mean.shape, generator, device,
                      "posterior_noise", state.group)
        rec = vae.decode(mean + torch.exp(0.5 * logvar) * eps)
        rec_loss = mse_loss(rec, x)
        kl = -0.5 * (1.0 + logvar - mean.square() - logvar.exp()).mean()
        loss = rec_loss + beta_kl * kl
        return _finish(state, loss, len(x), rec=rec_loss, kl=kl)

    return step


def make_refiner_train_step(cr_model: nn.Module, vae: nn.Module,
                            scaling: float = SD_VAE_SCALING,
                            device: Device = None) -> Callable:
    """Stage-4 conditional training:
    `step(state, batch, hf_posterior_noise=None, cr_posterior_noise=None,
    noise=None, timesteps=None, generator=None)`, batch {"lr", "gt"}
    (B, 3, H, W) in [0, 1]. Without gradient: the target's latent, the CR
    face and its latent. Then noise at a uniform t and the MSE between the
    refiner's epsilon and the noise. The refiner runs in training mode (HCA
    BatchNorm on batch statistics; its IDC stays in eval mode). What is
    drawn from `generator` is drawn in the order of the arguments."""
    device = resolve_device(device, "make_refiner_train_step")
    cr_model, vae = _frozen(cr_model, device), _frozen(vae, device)

    def step(state: TrainState, batch, hf_posterior_noise=None,
             cr_posterior_noise=None, noise=None, timesteps=None,
             generator=None):
        _check_state(state, device, "refiner train step")

        def encode(images, given, what):
            mean, logvar = vae.moments(_to_range(images))
            eps = _normal(given, mean.shape, generator, device, what,
                          state.group)
            return (mean + torch.exp(0.5 * logvar) * eps) * scaling

        with torch.no_grad():
            hf_latent = encode(batch["gt"].to(device), hf_posterior_noise,
                               "hf_posterior_noise")
            cr_face = cr_model(batch["lr"].to(device))
            cr_latent = encode(cr_face, cr_posterior_noise,
                               "cr_posterior_noise")
        eps = _normal(noise, hf_latent.shape, generator, device, "noise",
                      state.group)
        t = _timesteps(timesteps, hf_latent.shape[0], generator, device,
                       state.group)
        noisy = add_noise(hf_latent, eps, t)
        refiner = state.module.train()
        loss = mse_loss(refiner(noisy, t.float(), cr_face, cr_latent), eps)
        return _finish(state, loss, len(noisy))

    return step
