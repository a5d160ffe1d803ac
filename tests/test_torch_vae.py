"""The port's AutoencoderKL against the JAX VAE (float32, CPU, a narrow
3-block VAE): posterior moments, a posterior sample from given noise, and
decode. Weights: port init -> diffusers-named state dict -> the JAX
package's diffusers importer, and back through convert.py."""

import jax
import numpy as np
import torch

from hifidiff_tpu.vae import AutoencoderKL as JVAE
from hifidiff_tpu.vae.import_torch import vae_params_from_torch
from hifidiff_tpu_torch import convert
from hifidiff_tpu_torch.vae.model import AutoencoderKL
from torch_parity import assert_close, jax_weights, nchw, nhwc, normal

torch.set_num_threads(1)
CFG = dict(block_out=(32, 32, 32), layers_per_block=1)
# float32 convs and a 16-token softmax attention on both sides; summation
# order differs, values are O(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _pair():
    vae = AutoencoderKL(**CFG)
    p = jax_weights(vae, lambda sd: vae_params_from_torch(sd, 3, 1),
                    convert.vae_state_dict)
    return vae, JVAE(**CFG), {"params": p}


def test_moments_and_posterior_sample():
    vae, jvae, jv = _pair()
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    noise = normal(rng, 2, 4, 4, 4)
    mean, logvar = jax.jit(lambda v, x: jvae.apply(v, x, method=jvae.moments))(
        jv, x)
    with torch.inference_mode():
        m, lv = vae.moments(nchw(x))
        z = vae.encode(nchw(x), noise=nchw(noise))
    assert_close(nhwc(m), mean, **TOL)
    assert_close(nhwc(lv), logvar, **TOL)
    assert_close(nhwc(z), mean + np.exp(0.5 * np.asarray(logvar)) * noise,
                 **TOL)


def test_decode():
    vae, jvae, jv = _pair()
    z = normal(np.random.default_rng(1), 2, 4, 4, 4)
    ref = jax.jit(lambda v, z: jvae.apply(v, z, method=jvae.decode))(jv, z)
    with torch.inference_mode():
        out = vae.decode(nchw(z))
    assert out.shape == (2, 3, 16, 16)
    assert_close(nhwc(out), ref, **TOL)


def test_flax_default_init_draws_as_the_jax_vae():
    """`flax_default_init_` (what the training CLIs use where the JAX ones
    call `vae.init`) draws as the JAX VAE's flax init does: every conv and
    linear bias zero, every weight within two of its standard deviations (a
    truncated normal of variance 1 / fan_in), and each weight's spread
    within 10% of the JAX init's for the same tensor (the draws differ;
    torch's own default sits near 0.58 of it)."""
    from hifidiff_tpu_torch.vae.model import flax_default_init_

    torch.manual_seed(0)
    vae = flax_default_init_(AutoencoderKL(**CFG))
    ref = convert.vae_state_dict(jax.jit(JVAE(**CFG).init)(
        jax.random.PRNGKey(0), np.zeros((1, 16, 16, 3), np.float32))["params"])
    weights = 0
    for name, m in vae.named_modules():
        if not isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            continue
        w = m.weight.detach()
        std = (1.0 / w[0].numel()) ** 0.5 / .87962566103423978
        assert torch.count_nonzero(m.bias) == 0, name
        assert float(w.abs().max()) <= 2 * std * (1 + 1e-6), name
        assert torch.count_nonzero(ref[f"{name}.bias"]) == 0, name
        if w.numel() >= 1000:
            weights += 1
            ratio = float(w.std() / ref[f"{name}.weight"].std())
            assert abs(ratio - 1.0) < 0.1, (name, ratio)
    assert weights >= 10
