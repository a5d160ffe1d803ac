"""The port's three-stage refiner sampler against the JAX modules composed
the same way, on the tiny stack of tests/test_pipeline.py (float32, CPU,
3 DDIM steps), with the same weights, latents and posterior noise:

  JAX: CR -> VAE moments -> mean + exp(logvar / 2) * noise -> x 0.18215 ->
  FPG + IDC -> _precompute_invariants -> sample_ddim over the hoisted
  films -> decode -> clip -> uint8.

The second half runs the int8 + fused configuration on a stack whose deepest
levels pass the fused block's gate (width 16, four levels at 16x16 latents:
128 channels at 2x2, 256 at 1x1): the JAX side with the denoiser subtree
through `quantize_variables` (size threshold 0) and the fused block forced
on (its Pallas kernel in interpret mode), the port with
`quantize_denoiser_`, `fuse_small_naf` and `fused_gn_silu`, on the same int8
bytes through `convert.py`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifidiff_tpu.diffusion import DiffusionSchedule as JSchedule
from hifidiff_tpu.diffusion.sampling import sample_ddim as j_sample_ddim
from hifidiff_tpu.models import CoarseRestoration as JCR
from hifidiff_tpu.models import FacialRefiner as JRefiner
from hifidiff_tpu.ops import quant as jquant
from hifidiff_tpu.pipeline import RefinerPipelineConfig as JConfig
from hifidiff_tpu.pipeline import _films_slice, _precompute_invariants
from hifidiff_tpu.utils import torch_import as ti
from hifidiff_tpu.vae import AutoencoderKL as JVAE
from hifidiff_tpu.vae.import_torch import vae_params_from_torch
from hifidiff_tpu_torch import convert
from hifidiff_tpu_torch.models.cr import CoarseRestoration
from hifidiff_tpu_torch.models.refiner import (FacialRefiner,
                                               quantize_denoiser_)
from hifidiff_tpu_torch.nn import naf
from hifidiff_tpu_torch.ops import naf_block, quant
from hifidiff_tpu_torch.pipeline import (RefinerPipelineConfig,
                                         build_refiner_sampler_split)
from hifidiff_tpu_torch.vae.model import SD_VAE_SCALING, AutoencoderKL
from torch_parity import jax_weights, nhwc, normal

torch.set_num_threads(1)
RES, LATENT, STEPS, B = 32, 8, 3, 2
CR = dict(width=8, resolution=RES, enc_nums=(1, 1), mid_num=1,
          dec_nums=(1, 1))
REF = dict(latent_size=LATENT, width=16, enc_nums=(1, 1), mid_num=1,
           dec_nums=(1, 1), idc_stage_sizes=(1, 1, 1, 1))
VAE = dict(block_out=(32, 32, 32), layers_per_block=1)
J_SCHEDULE = JSchedule.create()  # concrete tables, outside the jit below


# the int8 + fused configuration: latents 16x16 from a two-level VAE
LATENT_F = 16
REF_F = dict(latent_size=LATENT_F, width=16, enc_nums=(1, 1, 1, 1), mid_num=1,
             dec_nums=(1, 1, 1, 1), idc_stage_sizes=(1, 1, 1, 1))
VAE_F = dict(block_out=(32, 32), layers_per_block=1)


def _refiner_import(sd, ref=REF):
    enc, mid, dec = ref["enc_nums"], ref["mid_num"], ref["dec_nums"]
    parts = ti.split_by_prefix(sd)
    den_p, den_s = ti.fused_denoiser_params(parts["denoiser"], enc, mid, dec)
    idc_p, idc_s = ti.resnet50_params(parts["idc"], (1, 1, 1, 1))
    return {"params": {"idc": idc_p, "denoiser": den_p,
                       "fpg": ti.fpg_params(parts["fpg"], enc)},
            "batch_stats": {"idc": idc_s, "denoiser": den_s}}


def _jax_pipeline_fn(ref_kw, vae_kw, latent):
    return jax.jit(lambda *a: _jax_pipeline_body(ref_kw, vae_kw, latent, *a))


def _jax_pipeline_body(ref_kw, vae_kw, latent, cr_p, rv, vae_p, lr_u8,
                       post_noise, lat_noise):
    cr, vae, refiner = JCR(**CR), JVAE(**vae_kw), JRefiner(**ref_kw)
    schedule = J_SCHEDULE
    cfg = JConfig(num_inference_steps=STEPS, latent_size=latent)
    cr_face = cr.apply({"params": cr_p}, lr_u8.astype(np.float32) / 255.0)
    cr_in = jnp.clip(cr_face, 0.0, 1.0) * 2.0 - 1.0
    mean, logvar = vae.apply({"params": vae_p}, cr_in, method=vae.moments)
    cr_latent = (mean + jnp.exp(0.5 * logvar) * post_noise) * SD_VAE_SCALING
    priors = refiner.apply(rv, cr_latent, method=lambda m, z: m.fpg(z))
    id_emb = refiner.apply(rv, cr_face,
                           method=lambda m, f: m.idc(f, train=False))
    pre = _precompute_invariants(refiner, rv, priors, id_emb, schedule, cfg)

    def eps_fn(x, t, film_slice):
        return refiner.apply(
            rv, x, t, priors, id_emb,
            method=lambda m, x, t, p, e: m.denoiser(
                x, t, p, e, train=False, films=_films_slice(film_slice),
                idc_pre=pre["idc"], hca_gates=pre["gates"]))

    final = j_sample_ddim(eps_fn, jnp.asarray(lat_noise), schedule,
                          num_inference_steps=STEPS,
                          per_step_aux=pre["films"])
    img = vae.apply({"params": vae_p}, final / SD_VAE_SCALING,
                    method=vae.decode)
    img = jnp.clip((img + 1.0) * 0.5, 0.0, 1.0)
    return final, img, jnp.round(img * 255.0).astype(jnp.uint8)


@pytest.fixture(scope="module")
def runs():
    torch.manual_seed(0)  # module inits, independent of earlier tests
    cr, vae, refiner = (CoarseRestoration(**CR), AutoencoderKL(**VAE),
                        FacialRefiner(**REF))
    cr_p = jax_weights(cr, lambda sd: ti.cr_params(sd, (1, 1), 1, (1, 1)),
                       convert.cr_state_dict, seed=1)
    vae_p = jax_weights(vae, lambda sd: vae_params_from_torch(sd, 3, 1),
                        convert.vae_state_dict, seed=2)
    rv = jax_weights(refiner, _refiner_import, convert.refiner_state_dict,
                     seed=3)
    rng = np.random.default_rng(0)
    lr_u8 = rng.integers(0, 256, (B, RES, RES, 3), dtype=np.uint8)
    post, lat = normal(rng, B, LATENT, LATENT, 4), \
        normal(rng, B, LATENT, LATENT, 4)

    sample = build_refiner_sampler_split(
        refiner, cr, vae,
        RefinerPipelineConfig(num_inference_steps=STEPS, latent_size=LATENT),
        device="cpu")
    ref = _jax_pipeline_fn(REF, VAE, LATENT)(cr_p, rv, vae_p, lr_u8, post,
                                             lat)
    return (*_port_run(sample, vae, lr_u8, post, lat), ref)


def _port_run(sample, vae, lr_u8, post, lat):
    noise = dict(posterior_noise=torch.from_numpy(post),
                 latents_noise=torch.from_numpy(lat))
    out = sample(torch.from_numpy(lr_u8), **noise)
    with torch.inference_mode():
        st = sample.stages
        final = st["scan"](*st["prep"](torch.from_numpy(lr_u8), *noise.values()))
        img = ((vae.decode(final / SD_VAE_SCALING) + 1.0) * 0.5).clamp(0, 1)
        staged = st["decode"](final)
    return out, staged, final, img


def test_uint8_output_within_one_level(runs):
    out, staged, _, _, (_, _, ref_u8) = runs
    assert out.dtype == torch.uint8 and out.shape == (B, RES, RES, 3)
    assert torch.equal(out, staged)
    diff = np.abs(out.numpy().astype(int) - np.asarray(ref_u8).astype(int))
    assert diff.max() <= 1
    assert len(np.unique(out.numpy())) > 10  # not a saturated image


def test_final_latents_and_float_image(runs):
    """float32 through ~40 convs and 3 steps on both sides: relative error
    a few 1e-6, bounded here at 1e-4 of the values' scale."""
    _, _, final, img, (ref_final, ref_img, _) = runs
    for a, b in ((nhwc(final), ref_final), (nhwc(img), ref_img)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(b).max()))


def test_noise_drawn_from_generator_when_not_given():
    cr, vae, refiner = (CoarseRestoration(**CR), AutoencoderKL(**VAE),
                        FacialRefiner(**REF))
    sample = build_refiner_sampler_split(
        refiner, cr, vae,
        RefinerPipelineConfig(num_inference_steps=1, latent_size=LATENT),
        device="cpu")
    lr = torch.zeros((1, RES, RES, 3), dtype=torch.uint8)
    a = sample(lr, generator=torch.Generator().manual_seed(5))
    b = sample(lr, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        sample(lr)


@pytest.fixture(scope="module")
def runs_int8_fused():
    torch.manual_seed(0)
    cr, vae, refiner = (CoarseRestoration(**CR), AutoencoderKL(**VAE_F),
                        FacialRefiner(**REF_F))
    cr_p = jax_weights(cr, lambda sd: ti.cr_params(sd, (1, 1), 1, (1, 1)),
                       convert.cr_state_dict, seed=1)
    vae_p = jax_weights(vae, lambda sd: vae_params_from_torch(sd, 2, 1),
                        convert.vae_state_dict, seed=2)
    rv = jax_weights(refiner, lambda sd: _refiner_import(sd, REF_F),
                     convert.refiner_state_dict, seed=3)
    rng = np.random.default_rng(1)
    lr_u8 = rng.integers(0, 256, (B, RES, RES, 3), dtype=np.uint8)
    post, lat = normal(rng, B, LATENT_F, LATENT_F, 4), \
        normal(rng, B, LATENT_F, LATENT_F, 4)
    fused_calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quant, "W8_MIN_WEIGHT_PARAMS", 0)
        mp.setattr(jquant, "W8_MIN_WEIGHT_PARAMS", 0)
        mp.setenv("HIFIDIFF_FORCE_FUSED_NAF", "1")
        mp.setattr(naf, "fused_cnaf_block_small",
                   lambda x, *a, **k: fused_calls.append(tuple(x.shape)) or
                   naf_block.fused_cnaf_block_small(x, *a, **k))
        # both sides quantize the same float weights with their own
        # quantizer; the port then loads the JAX tree's int8 bytes
        rv_q = {"params": {**rv["params"], "denoiser": jquant.
                           quantize_variables(rv["params"]["denoiser"])},
                "batch_stats": rv["batch_stats"]}
        n_q = quantize_denoiser_(refiner)
        own = {k: v.clone() for k, v in refiner.state_dict().items()}
        refiner.load_state_dict(convert.refiner_state_dict(rv_q), strict=True)
        sample = build_refiner_sampler_split(
            refiner, cr, vae,
            RefinerPipelineConfig(num_inference_steps=STEPS,
                                  latent_size=LATENT_F, fuse_small_naf=True,
                                  fused_gn_silu=True), device="cpu")
        port = _port_run(sample, vae, lr_u8, post, lat)
        ref = _jax_pipeline_fn(REF_F, VAE_F, LATENT_F)(cr_p, rv_q, vae_p,
                                                       lr_u8, post, lat)
    return (*port, ref), refiner, own, n_q, fused_calls


def test_int8_fused_quantizers_agree(runs_int8_fused):
    """`quantize_denoiser_` on the port's float weights gives the bytes that
    `quantize_variables` + convert.py give: every conv and linear layer of
    the denoiser (size threshold 0), and none outside it."""
    _, refiner, own, n_q, _ = runs_int8_fused
    sd = refiner.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), own[k].numpy(), err_msg=k)
    q_keys = [k for k in sd if k.endswith(".weight_q")]
    assert len(q_keys) == n_q > 60
    assert all(k.startswith("denoiser.") for k in q_keys)
    assert not any(k.startswith("denoiser.") and k.endswith((
        "conv1.weight", "conv3.weight", "time_mlp.1.weight", "intro.weight"))
        for k in sd)


def test_int8_fused_path_taken(runs_int8_fused):
    """enc3 and dec0 (128 ch at 2x2) and the middle block (256 ch at 1x1)
    go through the fused block at every step, four calls per stage run."""
    *_, fused_calls = runs_int8_fused
    per_eps = [(B, 128, 2, 2), (B, 256, 1, 1), (B, 128, 2, 2)]
    assert fused_calls == per_eps * STEPS * 2   # sample() and the staged run


def test_int8_fused_uint8_output_within_one_level(runs_int8_fused):
    (out, staged, _, _, (_, _, ref_u8)), *_ = runs_int8_fused
    assert out.dtype == torch.uint8 and out.shape == (B, RES, RES, 3)
    assert torch.equal(out, staged)
    diff = np.abs(out.numpy().astype(int) - np.asarray(ref_u8).astype(int))
    assert diff.max() <= 1
    assert len(np.unique(out.numpy())) > 10


def test_int8_fused_final_latents_and_float_image(runs_int8_fused):
    """Both sides hold the same int8 weights and compute in float32, so the
    bound is the float configuration's: 1e-4 of the values' scale."""
    (_, _, final, img, (ref_final, ref_img, _)), *_ = runs_int8_fused
    for a, b in ((nhwc(final), ref_final), (nhwc(img), ref_img)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(b).max()))
