"""The port's refiner samplers against the JAX package's own pipeline
builders, on every path the split sampler has beyond the exact default one:
DPM-Solver++ (2M), the cached sampler (`cache_interval`, hoisted and not),
the invariants recomputed in every step, the posterior mean, float image
I/O, x0 clipping, the three tiny seams, the monolithic sampler, and the
unconditional sampler; the config's refusals, and the two faults of the
reference that the port refuses at build time.

The tiny stack of tests/test_torch_pipeline.py (float32, CPU, 3 steps).
The JAX sampler draws its noise from a key: `k_lat, k_enc =
jax.random.split(key)`, the initial latents `normal(k_lat)` and the
posterior sample's noise `normal(k_enc)`; the port is given the same
normals as `latents_noise` and `posterior_noise`. Both run the JAX stages'
and the port's stages on the same weights; compared are the final latents
and the float image (1e-4 of the values' scale: float32 sums in another
order through ~40 layers and 3 steps, readings a few 1e-6) and the uint8
faces (within one level: a value on a rounding boundary)."""

import jax
import numpy as np
import pytest
import torch

from hifidiff_tpu import pipeline as jpipe
from hifidiff_tpu.models import CoarseRestoration as JCR
from hifidiff_tpu.models import Denoiser as JDenoiser
from hifidiff_tpu.models import FacialRefiner as JRefiner
from hifidiff_tpu.models.tiny_cr import TinyCR as JTinyCR
from hifidiff_tpu.ops import quant as jquant
from hifidiff_tpu.utils import torch_import as ti
from hifidiff_tpu.vae import AutoencoderKL as JVAE
from hifidiff_tpu.vae import tiny as jtiny
from hifidiff_tpu.vae.import_torch import vae_params_from_torch
from hifidiff_tpu_torch import convert
from hifidiff_tpu_torch.models.cr import CoarseRestoration
from hifidiff_tpu_torch.models.denoiser import Denoiser
from hifidiff_tpu_torch.models.refiner import (FacialRefiner,
                                               quantize_denoiser_)
from hifidiff_tpu_torch.models.tiny_cr import TinyCR
from hifidiff_tpu_torch.nn import naf
from hifidiff_tpu_torch.ops import naf_block, quant
from hifidiff_tpu_torch.pipeline import (RefinerPipelineConfig,
                                         build_refiner_sampler,
                                         build_refiner_sampler_split,
                                         build_unconditional_sampler)
from hifidiff_tpu_torch.vae import tiny
from hifidiff_tpu_torch.vae.model import AutoencoderKL
from test_torch_pipeline import (B, CR, J_SCHEDULE, LATENT, LATENT_F, REF,
                                 REF_F, RES, STEPS, VAE, VAE_F,
                                 _refiner_import)
from torch_parity import jax_weights, nhwc

torch.set_num_threads(1)

TINY_ENC, TINY_DEC = (8, 8, 16), (16, 8, 8)   # image 32 <-> latent 8
TINY_CR = dict(width=8, blocks=1, up_width=4)


def _flax(module, shape, seed):
    """flax init params of a JAX tiny module, as a numpy tree."""
    return jax.device_get(jax.jit(module.init)(
        jax.random.PRNGKey(seed), np.zeros(shape, np.float32))["params"])


@pytest.fixture(scope="module")
def stack():
    """Port models and their JAX trees on the same perturbed weights, the
    tiny modules from flax inits, and one batch of LR faces."""
    torch.manual_seed(0)
    cr, vae, refiner = (CoarseRestoration(**CR), AutoencoderKL(**VAE),
                        FacialRefiner(**REF))
    trees = {
        "cr": jax_weights(cr, lambda sd: ti.cr_params(sd, (1, 1), 1, (1, 1)),
                          convert.cr_state_dict, seed=1),
        "vae": jax_weights(vae, lambda sd: vae_params_from_torch(sd, 3, 1),
                           convert.vae_state_dict, seed=2),
        "refiner": jax_weights(refiner, _refiner_import,
                               convert.refiner_state_dict, seed=3),
        "tiny_enc": _flax(jtiny.TinyEncoder(widths=TINY_ENC),
                          (1, RES, RES, 3), 4),
        "tiny_dec": _flax(jtiny.TinyDecoder(widths=TINY_DEC),
                          (1, LATENT, LATENT, 4), 5),
        "tiny_cr": _flax(JTinyCR(**TINY_CR), (1, RES, RES, 3), 6)}
    ports = {"tiny_enc": tiny.TinyEncoder(widths=TINY_ENC),
             "tiny_dec": tiny.TinyDecoder(widths=TINY_DEC),
             "tiny_cr": TinyCR(**TINY_CR)}
    for name, conv in (("tiny_enc", convert.tiny_encoder_state_dict),
                       ("tiny_dec", convert.tiny_decoder_state_dict),
                       ("tiny_cr", convert.tiny_cr_state_dict)):
        ports[name].load_state_dict(conv(trees[name]), strict=True)
    lr = np.random.default_rng(0).integers(0, 256, (B, RES, RES, 3),
                                           dtype=np.uint8)
    return (refiner, cr, vae), ports, trees, lr


def _noise(key, latent=LATENT):
    """The normals the JAX samplers draw from `key`."""
    k_lat, k_enc = jax.random.split(key)
    shape = (B, latent, latent, 4)
    return (np.array(jax.random.normal(k_lat, shape)),
            np.array(jax.random.normal(k_enc, shape, np.float32)))


def _images(lr_u8, io_uint8):
    return lr_u8 if io_uint8 else (lr_u8 / 255.0).astype(np.float32)


def _jax_sampler(cfg_kw, seams=(), ref=REF, vae=VAE, latent=LATENT):
    return jpipe.build_refiner_sampler_split(
        JRefiner(**ref), JCR(**CR), JVAE(**vae), J_SCHEDULE,
        jpipe.RefinerPipelineConfig(num_inference_steps=STEPS,
                                    latent_size=latent, **cfg_kw),
        tiny_enc=(jtiny.TinyEncoder(widths=TINY_ENC)
                  if "tiny_enc" in seams else None),
        tiny_dec=(jtiny.TinyDecoder(widths=TINY_DEC)
                  if "tiny_dec" in seams else None),
        tiny_cr=JTinyCR(**TINY_CR) if "tiny_cr" in seams else None)


def _jax_split(cfg_kw, trees, lr, key, seams=(), ref=REF, vae=VAE,
               latent=LATENT):
    """JAX's build_refiner_sampler_split, stage by stage: (final latents,
    images)."""
    st = _jax_sampler(cfg_kw, seams, ref, vae, latent).stages
    enc_p = trees["tiny_enc" if "tiny_enc" in seams else "vae"]
    dec_p = trees["tiny_dec" if "tiny_dec" in seams else "vae"]
    cr_p = trees["tiny_cr" if "tiny_cr" in seams else "cr"]
    rv = trees["refiner"]
    lat, priors, emb = st["prep"](cr_p, enc_p, rv, lr, key)
    final = st["scan"](rv, lat, priors, emb)
    return np.asarray(final), np.asarray(st["decode"](dec_p, final))


def _port_split(sample, lr, lat, post):
    """The port's stages, and the whole call, which must give the same
    images: (final latents NHWC, images)."""
    lr_t = torch.from_numpy(lr)
    noise = dict(latents_noise=torch.from_numpy(lat),
                 posterior_noise=torch.from_numpy(post))
    out = sample(lr_t, **noise)
    with torch.inference_mode():
        st = sample.stages
        post_t = noise["posterior_noise"] \
            if sample._inputs.needs_posterior else None
        final = st["scan"](*st["prep"](lr_t, post_t, noise["latents_noise"]))
        staged = st["decode"](final)
    assert torch.equal(out, staged)
    return nhwc(final), out.numpy()


def _assert_images(out, ref, io_uint8):
    if io_uint8:
        assert out.dtype == np.uint8 and out.shape == (B, RES, RES, 3)
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
        assert len(np.unique(out)) > 10   # not a saturated image
    else:
        assert out.dtype == np.float32 and out.shape == (B, RES, RES, 3)
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def _assert_latents(final, ref):
    np.testing.assert_allclose(final, ref, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))


PATHS = {
    "dpmpp": dict(sampler="dpmpp"),
    "cached_2": dict(cache_interval=2),
    "cached_2_not_hoisted": dict(cache_interval=2, hoist_invariants=False),
    "not_hoisted": dict(hoist_invariants=False),
    "posterior_mean": dict(sample_posterior=False),
    "float_io": dict(io_uint8=False),
    "clip_sample": dict(clip_sample=True, clip_sample_range=0.5),
}


# the options that change only the scan stage
SCAN_ONLY = {"sampler", "cache_interval", "hoist_invariants", "clip_sample",
             "clip_sample_range"}


@pytest.fixture(scope="module")
def jax_default(stack):
    """The JAX default sampler's prep outputs (key 3) and its decode stage,
    which the paths that change only the scan share (a JAX sampler's stages
    compile anew for every sampler)."""
    _, _, trees, lr = stack
    st = _jax_sampler({"io_uint8": True}).stages
    return (st["prep"](trees["cr"], trees["vae"], trees["refiner"], lr,
                       jax.random.PRNGKey(3)), st["decode"])


@pytest.mark.parametrize("path", sorted(PATHS))
def test_split_sampler_path_matches_jax(stack, jax_default, path):
    (refiner, cr, vae), _, trees, lr_u8 = stack
    kw = dict(PATHS[path])
    io_uint8 = kw.setdefault("io_uint8", True)
    lr = _images(lr_u8, io_uint8)
    key = jax.random.PRNGKey(3)
    lat, post = _noise(key)
    if set(PATHS[path]) <= SCAN_ONLY:
        prep, decode = jax_default
        final = _jax_sampler(kw).stages["scan"](trees["refiner"], *prep)
        ref_final = np.asarray(final)
        ref_img = np.asarray(decode(trees["vae"], final))
    else:
        ref_final, ref_img = _jax_split(kw, trees, lr, key)
    sample = build_refiner_sampler_split(
        refiner, cr, vae, RefinerPipelineConfig(
            num_inference_steps=STEPS, latent_size=LATENT, **kw),
        device="cpu")
    final, img = _port_split(sample, lr, lat, post)
    _assert_latents(final, ref_final)
    _assert_images(img, ref_img, io_uint8)


def test_cached_int8_fused_matches_jax(stack):
    """`cache_interval=2` on the int8 + fused configuration (the stack of
    test_torch_pipeline.py whose deepest blocks pass the fused block's
    gate): the JAX side on the quantized tree with the fused block forced
    on (its Pallas kernel in interpret mode), the port on the same int8
    bytes with `fuse_small_naf` and `fused_gn_silu`. The fused blocks run
    in both halves: enc3 and the middle block in the encode half, dec0 in
    the decode half."""
    _, _, _, lr = stack
    torch.manual_seed(0)
    cr, vae, refiner = (CoarseRestoration(**CR), AutoencoderKL(**VAE_F),
                        FacialRefiner(**REF_F))
    trees = {
        "cr": jax_weights(cr, lambda sd: ti.cr_params(sd, (1, 1), 1, (1, 1)),
                          convert.cr_state_dict, seed=1),
        "vae": jax_weights(vae, lambda sd: vae_params_from_torch(sd, 2, 1),
                           convert.vae_state_dict, seed=2)}
    rv = jax_weights(refiner, lambda sd: _refiner_import(sd, REF_F),
                     convert.refiner_state_dict, seed=3)
    key = jax.random.PRNGKey(8)
    lat, post = _noise(key, LATENT_F)
    fused_calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quant, "W8_MIN_WEIGHT_PARAMS", 0)
        mp.setattr(jquant, "W8_MIN_WEIGHT_PARAMS", 0)
        mp.setenv("HIFIDIFF_FORCE_FUSED_NAF", "1")
        mp.setattr(naf, "fused_cnaf_block_small",
                   lambda x, *a, **k: fused_calls.append(tuple(x.shape)) or
                   naf_block.fused_cnaf_block_small(x, *a, **k))
        trees["refiner"] = {
            "params": {**rv["params"], "denoiser": jquant.quantize_variables(
                rv["params"]["denoiser"])},
            "batch_stats": rv["batch_stats"]}
        quantize_denoiser_(refiner)
        refiner.load_state_dict(convert.refiner_state_dict(trees["refiner"]),
                                strict=True)
        kw = dict(cache_interval=2, io_uint8=True)
        ref_final, ref_img = _jax_split(kw, trees, lr, key, ref=REF_F,
                                        vae=VAE_F, latent=LATENT_F)
        sample = build_refiner_sampler_split(
            refiner, cr, vae, RefinerPipelineConfig(
                num_inference_steps=STEPS, latent_size=LATENT_F,
                fuse_small_naf=True, fused_gn_silu=True, **kw), device="cpu")
        final, img = _port_split(sample, lr, lat, post)
    _assert_latents(final, ref_final)
    _assert_images(img, ref_img, True)
    # steps 0 and 2 refresh (enc3, mid); every step decodes (dec0); two runs
    enc, dec = [(B, 128, 2, 2), (B, 256, 1, 1)], [(B, 128, 2, 2)]
    per_run = enc + dec + dec + enc + dec
    assert fused_calls == per_run * 2


def test_split_sampler_paths_differ(stack):
    """Each path computes something of its own: its final latents are far
    from the exact default's (so no option is silently ignored)."""
    (refiner, cr, vae), _, _, lr_u8 = stack
    lat, post = _noise(jax.random.PRNGKey(3))

    def final(**kw):
        s = build_refiner_sampler_split(
            refiner, cr, vae, RefinerPipelineConfig(
                num_inference_steps=STEPS, latent_size=LATENT, **kw),
            device="cpu")
        return _port_split(s, _images(lr_u8, kw.get("io_uint8", True)),
                           lat, post)[0]

    base = final()
    for name, kw in PATHS.items():
        diff = np.abs(final(**kw) - base).max()
        # the recomputed invariants and float I/O are the same math
        if name in ("not_hoisted", "float_io"):
            assert diff < 1e-4 * max(1.0, np.abs(base).max()), name
        else:
            assert diff > 1e-3, name


@pytest.mark.parametrize("seams", [("tiny_enc", "tiny_dec", "tiny_cr"),
                                   ("tiny_dec",)])
def test_tiny_seams_match_jax(stack, seams):
    (refiner, cr, vae), ports, trees, lr = stack
    key = jax.random.PRNGKey(4)
    lat, post = _noise(key)
    ref_final, ref_img = _jax_split({"io_uint8": True}, trees, lr, key, seams)
    sample = build_refiner_sampler_split(
        refiner, cr, vae, RefinerPipelineConfig(num_inference_steps=STEPS,
                                                latent_size=LATENT),
        device="cpu", **{name: ports[name] for name in seams})
    assert sample._inputs.needs_posterior == ("tiny_enc" not in seams)
    final, img = _port_split(sample, lr, lat, post)
    _assert_latents(final, ref_final)
    _assert_images(img, ref_img, True)


def test_tiny_cr_needs_no_cr(stack):
    (refiner, _, vae), ports, _, lr = stack
    sample = build_refiner_sampler_split(
        refiner, None, vae, RefinerPipelineConfig(num_inference_steps=1,
                                                  latent_size=LATENT),
        device="cpu", tiny_cr=ports["tiny_cr"])
    out = sample(torch.from_numpy(lr), generator=torch.Generator()
                 .manual_seed(0))
    assert out.shape == (B, RES, RES, 3)


@pytest.mark.parametrize("io_uint8", [True, False])
def test_monolithic_sampler_matches_jax_and_split(stack, io_uint8):
    (refiner, cr, vae), _, trees, lr_u8 = stack
    lr = _images(lr_u8, io_uint8)
    cfg = dict(num_inference_steps=STEPS, latent_size=LATENT,
               io_uint8=io_uint8)
    key = jax.random.PRNGKey(5)
    lat, post = _noise(key)
    jsample = jax.jit(jpipe.build_refiner_sampler(
        JRefiner(**REF), JCR(**CR), JVAE(**VAE), J_SCHEDULE,
        jpipe.RefinerPipelineConfig(**cfg)))
    ref = np.asarray(jsample({"refiner": trees["refiner"], "cr": trees["cr"],
                              "vae": trees["vae"]}, lr, key))
    noise = dict(latents_noise=torch.from_numpy(lat),
                 posterior_noise=torch.from_numpy(post))
    out = build_refiner_sampler(refiner, cr, vae, RefinerPipelineConfig(
        **cfg), device="cpu")(torch.from_numpy(lr), **noise)
    _assert_images(out.numpy(), ref, io_uint8)
    split = build_refiner_sampler_split(refiner, cr, vae,
                                        RefinerPipelineConfig(**cfg),
                                        device="cpu")
    assert torch.equal(out, split(torch.from_numpy(lr), **noise))


def test_unconditional_sampler_matches_jax():
    torch.manual_seed(0)
    den_kw = dict(width=16, enc_nums=(1, 1), mid_num=1, dec_nums=(1, 1))
    den, vae = Denoiser(**den_kw), AutoencoderKL(**VAE)
    jden = jax_weights(den, lambda sd: ti.denoiser_params(sd, (1, 1), 1,
                                                          (1, 1)),
                       convert.denoiser_state_dict, seed=7)
    jvae = jax_weights(vae, lambda sd: vae_params_from_torch(sd, 3, 1),
                       convert.vae_state_dict, seed=8)
    key, batch = jax.random.PRNGKey(6), 3
    ref = np.asarray(jax.jit(jpipe.build_unconditional_sampler(
        JDenoiser(**den_kw), JVAE(**VAE), J_SCHEDULE,
        num_inference_steps=STEPS, latent_size=LATENT, batch=batch))(
            jden, jvae, key))
    lat = np.array(jax.random.normal(key, (batch, LATENT, LATENT, 4)))
    sample = build_unconditional_sampler(den, vae, num_inference_steps=STEPS,
                                         latent_size=LATENT, batch=batch,
                                         device="cpu")
    out = sample(latents_noise=torch.from_numpy(lat)).numpy()
    assert out.dtype == np.float32 and out.shape == (batch, RES, RES, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    assert out.std() > 1e-3
    with pytest.raises(ValueError, match="latents_noise must be"):
        sample(latents_noise=torch.zeros(1, LATENT, LATENT, 4))
    drawn = [sample(generator=torch.Generator().manual_seed(1))
             for _ in range(2)]
    assert torch.equal(*drawn)


@pytest.mark.parametrize("kw", [dict(sampler="euler"),
                                dict(sampler="dpmpp", eta=0.5),
                                dict(sampler="dpmpp", cache_interval=2)])
def test_config_refusals_match_jax(kw):
    with pytest.raises(ValueError):
        jpipe.RefinerPipelineConfig(**kw)
    with pytest.raises(ValueError):
        RefinerPipelineConfig(**kw)


def test_reference_fault_eta_unreachable(stack):
    """The JAX refiner pipelines call `sample_ddim` with `eta` and no key,
    so `eta > 0` raises on every call; the port refuses it when the sampler
    is built."""
    (refiner, cr, vae), _, trees, lr = stack
    jcfg = jpipe.RefinerPipelineConfig(num_inference_steps=STEPS,
                                       latent_size=LATENT, eta=0.5)
    jsample = jax.jit(jpipe.build_refiner_sampler(
        JRefiner(**REF), JCR(**CR), JVAE(**VAE), J_SCHEDULE, jcfg))
    with pytest.raises(ValueError, match="PRNG key"):   # while tracing
        jsample({"refiner": trees["refiner"], "cr": trees["cr"],
                 "vae": trees["vae"]}, lr, jax.random.PRNGKey(0))
    cfg = RefinerPipelineConfig(num_inference_steps=STEPS, eta=0.5)
    for build in (build_refiner_sampler, build_refiner_sampler_split):
        with pytest.raises(ValueError, match="eta"):
            build(refiner, cr, vae, cfg, device="cpu")


def test_reference_fault_monolithic_ignores_cache_interval(stack):
    """JAX's monolithic pipeline runs the full network every step whatever
    `cache_interval` says (its program for interval 2 is the one for
    interval 1); the port's monolithic builder refuses it (the split
    sampler runs it)."""
    (refiner, cr, vae), _, trees, lr = stack
    variables = {"refiner": trees["refiner"], "cr": trees["cr"],
                 "vae": trees["vae"]}
    key = jax.random.PRNGKey(0)
    programs = [jax.jit(jpipe.build_refiner_sampler(
        JRefiner(**REF), JCR(**CR), JVAE(**VAE), J_SCHEDULE,
        jpipe.RefinerPipelineConfig(num_inference_steps=STEPS,
                                    latent_size=LATENT, cache_interval=k,
                                    io_uint8=True))).lower(
                                        variables, lr, key).as_text()
        for k in (1, 2)]
    assert programs[0] == programs[1]
    with pytest.raises(ValueError, match="cache_interval"):
        build_refiner_sampler(refiner, cr, vae, RefinerPipelineConfig(
            cache_interval=2), device="cpu")
