"""The exact refiner sampler, in three stages (counterpart of
`build_refiner_sampler_split` in hifidiff_tpu/pipeline.py).

  prep:   uint8 LR faces -> CR -> SD-VAE encode (a posterior sample,
          x 0.18215) -> FPG prior pyramid + IDC embedding; the initial
          noise.
  scan:   the loop invariants (`FusedDenoiser.precompute`: FiLM tables for
          every DDIM timestep, identity injection, HCA gates), then the
          DDIM (eta 0) steps of the FusedDenoiser.
  decode: SD-VAE decode, then the image is quantised to uint8.

Images enter and leave as NHWC uint8 (B, H, W, 3), the JAX package's layout;
inside, everything is NCHW. The models compute in the dtype of their
parameters (bf16 or f32); the latents of the DDIM loop stay float32.

The sampler runs on the card: `device=None` means `torch.device("cuda")`,
and without a CUDA device it raises unless the caller asks for `"cpu"`.

Three options, independent and off by default (the JAX package's `--quant
int8`, `HIFIDIFF_FUSE_NAF` and `HIFIDIFF_PALLAS_GN`):
  * int8 denoiser weights: `models.refiner.quantize_denoiser_(refiner)`
    before building the sampler; the module tree is the switch;
  * `RefinerPipelineConfig(fuse_small_naf=True)`: the denoiser's blocks on
    1x1 and 2x2 maps run as one fused call each;
  * `RefinerPipelineConfig(fused_gn_silu=True)`: the VAE's GroupNorm + SiLU
    sites run through the fused kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from hifidiff_tpu_torch.devices import resolve_device
from hifidiff_tpu_torch.diffusion.sampling import ddim_timesteps, sample_ddim
from hifidiff_tpu_torch.models.cr import CoarseRestoration
from hifidiff_tpu_torch.models.refiner import FacialRefiner
from hifidiff_tpu_torch.vae.model import SD_VAE_SCALING, AutoencoderKL


@dataclasses.dataclass(frozen=True)
class RefinerPipelineConfig:
    num_inference_steps: int = 50
    latent_size: int = 16
    fuse_small_naf: bool = False
    fused_gn_silu: bool = False


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def build_refiner_sampler_split(
    refiner: FacialRefiner,
    cr_model: CoarseRestoration,
    vae: AutoencoderKL,
    config: RefinerPipelineConfig = RefinerPipelineConfig(),
    device: Union[None, str, torch.device] = None,
) -> Callable:
    """Returns `sample(lr_images, generator=None, latents_noise=None,
    posterior_noise=None) -> images`, uint8 NHWC in and out. `latents_noise`
    and `posterior_noise` are NHWC (B, latent, latent, 4) standard normals;
    the ones not given are drawn from `generator` (posterior noise first),
    which must live on the sampler's device.

    `device=None` is the card, `torch.device("cuda")`; it raises when there
    is none, and the CPU is used only when asked for with `device="cpu"`.
    The three models are moved to the device and put in eval mode; `sample`
    moves its inputs there and returns the faces there.

    The three stages are exposed as `sample.stages` ("prep", "scan",
    "decode") for per-stage timing; they take tensors on the device."""
    device = resolve_device(device, "build_refiner_sampler_split")
    for m in (refiner, cr_model, vae):
        m.to(device).eval()
    ts = ddim_timesteps(config.num_inference_steps)

    def stage_prep(lr_images, posterior_noise, latents_noise):
        lr = _nchw(lr_images).float() / 255.0
        cr_face = cr_model(lr)
        cr_in = cr_face.clamp(0.0, 1.0) * 2.0 - 1.0
        cr_latent = vae.encode(cr_in, noise=_nchw(posterior_noise),
                               fused_gn_silu=config.fused_gn_silu) \
            * SD_VAE_SCALING
        priors = refiner.fpg(cr_latent)
        id_emb = refiner.idc(cr_face)
        return _nchw(latents_noise).float(), priors, id_emb

    def stage_scan(latents, priors, id_emb):
        den = refiner.denoiser
        t_all = torch.as_tensor(ts, dtype=torch.float32,
                                device=latents.device)
        pre = den.precompute(t_all, priors, id_emb)
        # batch-1 FiLM rows of each step, shared across the sample batch
        per_step = [[f[k:k + 1] for f in pre["films"]]
                    for k in range(len(ts))]

        def eps_fn(x, t, films):
            return den(x, t, priors, id_emb, films=films,
                       idc_pre=pre["idc"], hca_gates=pre["gates"],
                       fuse_small_naf=config.fuse_small_naf)

        return sample_ddim(eps_fn, latents,
                           num_inference_steps=config.num_inference_steps,
                           per_step_aux=per_step)

    def stage_decode(latents):
        img = vae.decode(latents / SD_VAE_SCALING,
                         fused_gn_silu=config.fused_gn_silu).float()
        img = ((img + 1.0) * 0.5).clamp(0.0, 1.0)
        return torch.round(img * 255.0).to(torch.uint8) \
            .permute(0, 2, 3, 1).contiguous()

    @torch.inference_mode()
    def sample(lr_images: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               latents_noise: Optional[torch.Tensor] = None,
               posterior_noise: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        if lr_images.dtype != torch.uint8 or lr_images.dim() != 4 \
                or lr_images.shape[-1] != 3:
            raise ValueError("lr_images must be uint8 (B, H, W, 3), got "
                             f"{lr_images.dtype} {tuple(lr_images.shape)}")
        shape = (lr_images.shape[0], config.latent_size, config.latent_size,
                 vae.post_quant_conv.in_channels)
        noise = []
        for given in (posterior_noise, latents_noise):
            if given is None:
                if generator is None:
                    raise ValueError("pass the noise tensors or a "
                                     "torch.Generator to draw them from")
                given = torch.randn(shape, generator=generator,
                                    device=device)
            if tuple(given.shape) != shape:
                raise ValueError(f"noise must be {shape}, got "
                                 f"{tuple(given.shape)}")
            noise.append(given.to(device))
        latents, priors, id_emb = stage_prep(lr_images.to(device), *noise)
        return stage_decode(stage_scan(latents, priors, id_emb))

    sample.stages = {"prep": stage_prep, "scan": stage_scan,
                     "decode": stage_decode}
    return sample
