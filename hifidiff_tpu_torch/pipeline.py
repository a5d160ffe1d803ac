"""The refiner samplers and the unconditional sampler (counterpart of
hifidiff_tpu/pipeline.py).

`build_refiner_sampler_split` runs in three stages:

  prep:   LR faces -> CR (or the tiny CR) -> SD-VAE encode (a posterior
          sample or its mean, or the tiny encoder's mean) x 0.18215 -> FPG
          prior pyramid + IDC embedding; the initial noise.
  scan:   the loop invariants (`FusedDenoiser.precompute`: FiLM tables for
          every timestep, identity injection, HCA gates; unless
          `hoist_invariants=False`), then the sampler's steps of the
          FusedDenoiser: DDIM, DDIM with encoder-propagation caching
          (`cache_interval > 1`) or DPM-Solver++ (2M) (`sampler="dpmpp"`).
  decode: SD-VAE decode (or the tiny decoder), clipped to [0, 1], then
          quantised to uint8 with `io_uint8`.

`build_refiner_sampler` is the same math in one function, and
`build_unconditional_sampler` draws faces from the unconditional `Denoiser`
through DDIM and the SD-VAE decoder.

Images enter and leave as NHWC (B, H, W, 3), the JAX package's layout: uint8
with `io_uint8` (the port's default), else float in [0, 1]. Inside,
everything is NCHW. The models compute in the dtype of their parameters
(bf16 or f32); the latents of the loop stay float32.

Every sampler runs on the card: `device=None` means `torch.device("cuda")`,
and without a CUDA device it raises unless the caller asks for `"cpu"`.

The split sampler's `warm_compile(lr_images, ...)` captures the three
stages as CUDA graphs for one input shape, the counterpart of the JAX
package's per-shape compiled executables; later calls with that shape copy
their inputs into the graphs' buffers and replay them. Shapes that were not
warmed run eagerly, as the JAX package's lazy jits do for shapes it did not
compile ahead of time.

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
import itertools
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from hifidiff_tpu_torch.devices import resolve_device
from hifidiff_tpu_torch.diffusion.sampling import (ddim_timesteps, sample_ddim,
                                                   sample_ddim_cached,
                                                   sample_dpmpp_2m)
from hifidiff_tpu_torch.models.cr import CoarseRestoration
from hifidiff_tpu_torch.models.denoiser import Denoiser
from hifidiff_tpu_torch.models.refiner import FacialRefiner
from hifidiff_tpu_torch.vae.model import SD_VAE_SCALING, AutoencoderKL

STAGES = ("prep", "scan", "decode")


@dataclasses.dataclass(frozen=True)
class RefinerPipelineConfig:
    num_inference_steps: int = 50
    eta: float = 0.0
    clip_sample: bool = False          # clip each step's x0 prediction
    clip_sample_range: float = 1.0     # to +-range (the test CLI uses 3.0)
    cache_interval: int = 1            # > 1: the full network every k-th
    # step, the decoder half between (diffusion.sampling.sample_ddim_cached)
    io_uint8: bool = True              # uint8 images at the boundary; else
    # float in [0, 1]
    latent_size: int = 16
    sample_posterior: bool = True      # VAE encode: a posterior sample, or
    # its mean
    hoist_invariants: bool = True      # FiLM tables, identity injection and
    # HCA gates once before the loop (else recomputed in every step)
    sampler: str = "ddim"              # "ddim" or "dpmpp" (DPM-Solver++ 2M)
    fuse_small_naf: bool = False
    fused_gn_silu: bool = False

    def __post_init__(self):
        if self.sampler not in ("ddim", "dpmpp"):
            raise ValueError(f"unknown sampler {self.sampler!r}")
        if self.sampler == "dpmpp" and (self.eta != 0.0
                                        or self.cache_interval != 1):
            raise ValueError("dpmpp is a deterministic full-network solver:"
                             " eta must be 0 and cache_interval 1")


def _refuse_unreachable(config: RefinerPipelineConfig, monolithic: bool):
    """Settings that the JAX package's refiner pipelines accept but cannot
    run: they call `sample_ddim` with `eta` and no key, so `eta > 0` raises
    there on every call, and the monolithic pipeline ignores
    `cache_interval`. Refused here at build time; stochastic DDIM is
    `diffusion.sampling.sample_ddim(eta=...)` itself."""
    if config.eta != 0.0:
        raise ValueError("the refiner pipelines sample deterministically "
                         "(eta 0): the JAX pipelines have no noise source for "
                         "eta > 0; call diffusion.sampling.sample_ddim with "
                         "step noise instead")
    if monolithic and config.cache_interval > 1:
        raise ValueError("build_refiner_sampler runs the full network every "
                         "step; cache_interval > 1 needs "
                         "build_refiner_sampler_split")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _to_images(img: torch.Tensor, io_uint8: bool) -> torch.Tensor:
    """NCHW in [-1, 1] -> NHWC in [0, 1], float32 or uint8."""
    img = ((img.float() + 1.0) * 0.5).clamp(0.0, 1.0)
    if io_uint8:
        img = torch.round(img * 255.0).to(torch.uint8)
    return img.permute(0, 2, 3, 1).contiguous()


def _refiner_stages(refiner: FacialRefiner, cr_model: CoarseRestoration,
                    vae: AutoencoderKL, config: RefinerPipelineConfig,
                    device: torch.device, tiny_enc: Optional[nn.Module],
                    tiny_dec: Optional[nn.Module],
                    tiny_cr: Optional[nn.Module]) -> Dict[str, Callable]:
    """The three stages on `device`, which take and return tensors there:
    prep(lr_images, posterior_noise, latents_noise) -> (latents, priors,
    id_emb), where posterior_noise is read only where the SD-VAE's posterior
    is sampled and may be None elsewhere; scan(...) -> final latents;
    decode(latents) -> images. Nothing in them copies between the host and
    the card."""
    cr = tiny_cr if tiny_cr is not None else cr_model
    den = refiner.denoiser
    # on the device once: a host-to-device copy cannot be captured
    t_all = torch.as_tensor(ddim_timesteps(config.num_inference_steps),
                            dtype=torch.float32, device=device)
    steps = config.num_inference_steps
    sample_kw = dict(num_inference_steps=steps,
                     clip_sample=config.clip_sample,
                     clip_sample_range=config.clip_sample_range)

    def stage_prep(lr_images, posterior_noise, latents_noise):
        lr = _nchw(lr_images).float()
        if config.io_uint8:
            lr = lr / 255.0
        cr_face = cr(lr)
        cr_in = cr_face.clamp(0.0, 1.0) * 2.0 - 1.0
        if tiny_enc is not None:
            z = tiny_enc(cr_in)
        else:
            z = vae.encode(cr_in, noise=_nchw(posterior_noise)
                           if config.sample_posterior else None,
                           fused_gn_silu=config.fused_gn_silu)
        cr_latent = z * SD_VAE_SCALING
        priors = refiner.fpg(cr_latent)
        id_emb = refiner.idc(cr_face)
        return _nchw(latents_noise).float(), priors, id_emb

    def stage_scan(latents, priors, id_emb):
        kw: Dict = dict(fuse_small_naf=config.fuse_small_naf)
        per_step, idc = None, {}
        if config.hoist_invariants:
            pre = den.precompute(t_all, priors, id_emb)
            # batch-1 FiLM rows of each step, shared across the sample batch
            per_step = [[f[k:k + 1] for f in pre["films"]]
                        for k in range(steps)]
            kw["hca_gates"] = pre["gates"]
            idc["idc_pre"] = pre["idc"]

        if config.cache_interval > 1:
            def encode_fn(x, t, films=None):
                return den.encode(x, t, priors, id_emb, films=films, **idc,
                                  **kw)

            def decode_fn(cache, t, films=None):
                return den.decode(cache, t, priors, films=films, **kw)

            return sample_ddim_cached(encode_fn, decode_fn, latents,
                                      cache_interval=config.cache_interval,
                                      per_step_aux=per_step, **sample_kw)

        def eps_fn(x, t, films=None):
            return den(x, t, priors, id_emb, films=films, **idc, **kw)

        if config.sampler == "dpmpp":
            return sample_dpmpp_2m(eps_fn, latents, per_step_aux=per_step,
                                   **sample_kw)
        return sample_ddim(eps_fn, latents, per_step_aux=per_step,
                           **sample_kw)

    def stage_decode(latents):
        z = latents / SD_VAE_SCALING
        img = tiny_dec(z) if tiny_dec is not None else \
            vae.decode(z, fused_gn_silu=config.fused_gn_silu)
        return _to_images(img, config.io_uint8)

    return {"prep": stage_prep, "scan": stage_scan, "decode": stage_decode}


class _Inputs:
    """Checks a sampler call's images and noise and puts them on the
    device: (lr_images, posterior_noise or None, latents_noise), the noise
    NHWC (B, latent, latent, channels). Noise that is not given is drawn
    from `generator` (posterior noise first), which must live on the
    sampler's device. Posterior noise is drawn and used only where the
    sampler samples the SD-VAE's posterior."""

    def __init__(self, config: RefinerPipelineConfig, channels: int,
                 device: torch.device, needs_posterior: bool):
        self.config, self.channels, self.device = config, channels, device
        self.needs_posterior = needs_posterior

    def __call__(self, lr_images: torch.Tensor,
                 generator: Optional[torch.Generator],
                 latents_noise: Optional[torch.Tensor],
                 posterior_noise: Optional[torch.Tensor]) -> Tuple:
        ok = lr_images.dim() == 4 and lr_images.shape[-1] == 3 and (
            lr_images.dtype == torch.uint8 if self.config.io_uint8
            else lr_images.dtype.is_floating_point)
        if not ok:
            want = "uint8" if self.config.io_uint8 else "float"
            raise ValueError(f"lr_images must be {want} (B, H, W, 3), got "
                             f"{lr_images.dtype} {tuple(lr_images.shape)}")
        size = self.config.latent_size
        shape = (lr_images.shape[0], size, size, self.channels)
        noise = []
        for given, needed in ((posterior_noise, self.needs_posterior),
                              (latents_noise, True)):
            if not needed:
                noise.append(None)
                continue
            if given is None:
                if generator is None:
                    raise ValueError("pass the noise tensors or a "
                                     "torch.Generator to draw them from")
                given = torch.randn(shape, generator=generator,
                                    device=self.device)
            if tuple(given.shape) != shape:
                raise ValueError(f"noise must be {shape}, got "
                                 f"{tuple(given.shape)}")
            noise.append(given.to(self.device))
        return (lr_images.to(self.device), *noise)


def _prepare(refiner, cr_model, vae, config, device, tiny_enc, tiny_dec,
             tiny_cr, who):
    """Move the models the sampler runs to the device in eval mode; return
    them, the stages and the input checker."""
    device = resolve_device(device, who)
    modules = [m for m in (refiner, tiny_cr if tiny_cr is not None
                           else cr_model, tiny_enc, tiny_dec)
               if m is not None]
    if tiny_enc is None or tiny_dec is None:
        modules.append(vae)
    for m in modules:
        m.to(device).eval()
    stages = _refiner_stages(refiner, cr_model, vae, config, device,
                             tiny_enc, tiny_dec, tiny_cr)
    inputs = _Inputs(config, vae.post_quant_conv.in_channels, device,
                     tiny_enc is None and config.sample_posterior)
    return device, modules, stages, inputs


class CapturedStages:
    """The three stages captured as CUDA graphs for one input shape, over
    static input buffers (`inputs`) and sharing one memory pool.
    `graphs` maps each stage's name to its graph, in the order they run;
    `load(inputs)` copies a call's inputs into the buffers, and after the
    three replays `output` holds the images."""

    def __init__(self, stages: Dict[str, Callable], inputs: Sequence,
                 device: torch.device):
        self.inputs = tuple(None if t is None else t.clone() for t in inputs)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        # the eager warm-up, on the capture stream: what is built at first
        # use (the kernel library, the fused blocks' packs, the GEMM tile's
        # launch attributes, cuBLAS / cuDNN workspaces) is built outside the
        # capture
        with torch.cuda.stream(stream):
            stages["decode"](stages["scan"](*stages["prep"](*self.inputs)))
        pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        args = self.inputs
        for name in STAGES:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                out = stages[name](*args)
            self.graphs[name] = graph
            args = out if isinstance(out, tuple) else (out,)
        self.output = out
        torch.cuda.current_stream(device).wait_stream(stream)

    def load(self, inputs: Sequence) -> None:
        for static, given in zip(self.inputs, inputs):
            if static is not None:
                static.copy_(given)

    def run(self, inputs: Sequence) -> torch.Tensor:
        """Copy `inputs` in, replay the three graphs; a fresh tensor."""
        self.load(inputs)
        for graph in self.graphs.values():
            graph.replay()
        return self.output.clone()


class RefinerSampler:
    """What `build_refiner_sampler_split` returns:
    `sample(lr_images, generator=None, latents_noise=None,
    posterior_noise=None) -> images`, on the sampler's device.

    `stages` ("prep", "scan", "decode") are the eager stages, for per-stage
    timing; they take tensors on the device. `warm_compile(lr_images, ...)`
    captures them as CUDA graphs for the shape and dtype of `lr_images`
    (`CapturedStages`, returned) and `clear_compiled()` drops every capture;
    `replays` counts the calls that replayed graphs.

    The captures are keyed by the images' shape and dtype, and hold for one
    state of the models: the config, the tiny modules present, every
    parameter's and buffer's (pointer, dtype, shape), and every module's
    training flag and (fused NAF blocks) pack generation. A graph bakes in the
    pointers of the weights and of the fused blocks' packs, so when any of
    these changes (`.to()` and casts, `load_state_dict`, `quantize_module_`,
    `clear_fused_packs()`) every capture is dropped at the next call, which
    runs eagerly."""

    def __init__(self, modules, stages, inputs, config, device, tiny):
        self.stages, self.config, self.device = stages, config, device
        self._modules, self._inputs, self._tiny = modules, inputs, tiny
        self._compiled: Dict[Tuple, CapturedStages] = {}
        self._state: Optional[Tuple] = None
        self.replays = 0

    def _state_key(self) -> Tuple:
        # each module's own __dict__: a `getattr` that misses raises inside
        # `Module.__getattr__`, which at ~1,600 modules doubled the key's
        # host time
        tensors, modes = [], []
        for m in self._modules:
            for sub in m.modules():
                d = sub.__dict__
                for t in itertools.chain(d["_parameters"].values(),
                                         d["_buffers"].values()):
                    if t is not None:
                        tensors.append((t.data_ptr(), t.dtype, t.shape))
                modes.append((d["training"], d.get("pack_generation")))
        return self.config, self._tiny, tuple(tensors), tuple(modes)

    @staticmethod
    def _image_key(lr_images: torch.Tensor) -> Tuple:
        return tuple(lr_images.shape), lr_images.dtype

    def _captured(self, lr_images: torch.Tensor) -> Optional[CapturedStages]:
        if not self._compiled:
            return None
        if self._state_key() != self._state:
            self.clear_compiled()
            return None
        return self._compiled.get(self._image_key(lr_images))

    def _eager(self, lr_images, posterior_noise, latents_noise):
        st = self.stages
        return st["decode"](st["scan"](*st["prep"](
            lr_images, posterior_noise, latents_noise)))

    @torch.inference_mode()
    def __call__(self, lr_images: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 latents_noise: Optional[torch.Tensor] = None,
                 posterior_noise: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        inputs = self._inputs(lr_images, generator, latents_noise,
                              posterior_noise)
        captured = self._captured(lr_images)
        if captured is None:
            return self._eager(*inputs)
        self.replays += 1
        return captured.run(inputs)

    @torch.inference_mode()
    def warm_compile(self, lr_images: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     latents_noise: Optional[torch.Tensor] = None,
                     posterior_noise: Optional[torch.Tensor] = None
                     ) -> CapturedStages:
        """One eager warm-up call on these inputs, then the three stages
        captured as CUDA graphs, kept for calls with this shape and dtype of
        `lr_images`. Raises on the CPU, and where a capture fails. The
        kernels' launch counts (`ops.kernels.LAUNCHES`) count the warm-up
        and the capture, and no replay."""
        if self.device.type != "cuda":
            raise RuntimeError("warm_compile captures CUDA graphs; this "
                               f"sampler runs on {self.device}")
        inputs = self._inputs(lr_images, generator, latents_noise,
                              posterior_noise)
        state = self._state_key()
        if state != self._state:
            self.clear_compiled()
        captured = CapturedStages(self.stages, inputs, self.device)
        self._state = state
        self._compiled[self._image_key(lr_images)] = captured
        return captured

    def clear_compiled(self) -> None:
        self._compiled.clear()
        self._state = None


def build_refiner_sampler_split(
    refiner: FacialRefiner,
    cr_model: Optional[CoarseRestoration],
    vae: AutoencoderKL,
    config: RefinerPipelineConfig = RefinerPipelineConfig(),
    device: Union[None, str, torch.device] = None,
    tiny_enc: Optional[nn.Module] = None,
    tiny_dec: Optional[nn.Module] = None,
    tiny_cr: Optional[nn.Module] = None,
) -> RefinerSampler:
    """The three-stage refiner sampler (see the module's docstring and
    `RefinerSampler`). `latents_noise` and `posterior_noise` are NHWC
    (B, latent, latent, 4) standard normals.

    `tiny_enc` / `tiny_dec` (`vae.tiny`'s TinyEncoder / TinyDecoder) take
    the SD-VAE's place at the encode / decode seam; the tiny encode is the
    latent mean, so no posterior noise is used. `tiny_cr` (`models.tiny_cr`'s
    TinyCR) takes the CR's place, and `cr_model` may then be None.

    `device=None` is the card, `torch.device("cuda")`; it raises when there
    is none, and the CPU is used only when asked for with `device="cpu"`.
    The models that run are moved to the device and put in eval mode."""
    _refuse_unreachable(config, monolithic=False)
    device, modules, stages, inputs = _prepare(
        refiner, cr_model, vae, config, device, tiny_enc, tiny_dec, tiny_cr,
        "build_refiner_sampler_split")
    tiny = tuple(name for name, m in (("tiny_enc", tiny_enc),
                                      ("tiny_dec", tiny_dec),
                                      ("tiny_cr", tiny_cr)) if m is not None)
    return RefinerSampler(modules, stages, inputs, config, device, tiny)


def build_refiner_sampler(
    refiner: FacialRefiner,
    cr_model: CoarseRestoration,
    vae: AutoencoderKL,
    config: RefinerPipelineConfig = RefinerPipelineConfig(),
    device: Union[None, str, torch.device] = None,
) -> Callable:
    """The refiner sampler as one function, `sample(lr_images,
    generator=None, latents_noise=None, posterior_noise=None) -> images`:
    the split sampler's math and options, run eagerly, without the tiny
    seams. `cache_interval > 1` is refused (the JAX package's monolithic
    pipeline ignores it)."""
    _refuse_unreachable(config, monolithic=True)
    _, _, stages, inputs = _prepare(refiner, cr_model, vae, config, device,
                                    None, None, None, "build_refiner_sampler")

    @torch.inference_mode()
    def sample(lr_images: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               latents_noise: Optional[torch.Tensor] = None,
               posterior_noise: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        lr, post, lat = inputs(lr_images, generator, latents_noise,
                               posterior_noise)
        return stages["decode"](stages["scan"](*stages["prep"](lr, post,
                                                               lat)))

    return sample


def build_unconditional_sampler(
    denoiser: Denoiser,
    vae: AutoencoderKL,
    num_inference_steps: int = 50,
    latent_size: int = 16,
    batch: int = 8,
    device: Union[None, str, torch.device] = None,
) -> Callable:
    """Stage-3 sample grids: `sample(generator=None, latents_noise=None) ->
    images`, float32 NHWC (batch, H, W, 3) in [0, 1], from the unconditional
    `Denoiser` through deterministic DDIM and the SD-VAE decoder.
    `latents_noise` is NHWC (batch, latent_size, latent_size, 4), or drawn
    from `generator` (on the sampler's device). Runs on the card unless
    `device="cpu"`."""
    device = resolve_device(device, "build_unconditional_sampler")
    for m in (denoiser, vae):
        m.to(device).eval()
    shape = (batch, latent_size, latent_size, vae.post_quant_conv.in_channels)

    @torch.inference_mode()
    def sample(generator: Optional[torch.Generator] = None,
               latents_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if latents_noise is None:
            if generator is None:
                raise ValueError("pass latents_noise or a torch.Generator "
                                 "to draw it from")
            latents_noise = torch.randn(shape, generator=generator,
                                        device=device)
        if tuple(latents_noise.shape) != shape:
            raise ValueError(f"latents_noise must be {shape}, got "
                             f"{tuple(latents_noise.shape)}")
        final = sample_ddim(denoiser, _nchw(latents_noise.to(device)).float(),
                            num_inference_steps=num_inference_steps)
        return _to_images(vae.decode(final / SD_VAE_SCALING), False)

    return sample
