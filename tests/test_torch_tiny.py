"""The tiny seams (`vae/tiny.py`, `models/tiny_cr.py`) against the JAX
package's modules, float32 on the CPU. The JAX modules have no reference
checkpoint layout, so the weights go the other way from the other parity
tests: a flax init of the JAX module, through `convert.py` into the port's
module under a strict load, then the same numpy input through both.

Tolerance: float32 convolutions summed in another order, through 6-20
layers: 1e-4 of the values' scale (readings are a few 1e-6)."""

import jax
import numpy as np
import pytest
import torch

from hifidiff_tpu.models.tiny_cr import TinyCR as JTinyCR
from hifidiff_tpu.vae import tiny as jtiny
from hifidiff_tpu_torch import convert
from hifidiff_tpu_torch.models.tiny_cr import TinyCR
from hifidiff_tpu_torch.vae import tiny
from torch_parity import nchw, nhwc, normal

torch.set_num_threads(1)


def _close(actual, expected, rel=1e-4):
    expected = np.asarray(expected, np.float32)
    scale = max(1.0, float(np.abs(expected).max()))
    np.testing.assert_allclose(actual, expected, rtol=0, atol=rel * scale)


def _port_from_jax(jax_module, port_module, converter, x_nhwc, seed=0):
    """flax init of `jax_module` on `x_nhwc`, loaded into `port_module`
    through `converter` strictly; returns (port output NHWC, JAX output)."""
    params = jax.device_get(jax.jit(jax_module.init)(
        jax.random.PRNGKey(seed), x_nhwc)["params"])
    port_module.load_state_dict(converter(params), strict=True)
    port_module.eval()
    ref = jax.jit(jax_module.apply)({"params": params}, x_nhwc)
    with torch.inference_mode():
        out = port_module(nchw(x_nhwc))
    return nhwc(out), np.asarray(ref)


@pytest.mark.parametrize("widths,blocks", [((16, 8, 8), 2), ((8, 8), 1)])
def test_tiny_decoder(widths, blocks):
    z = normal(np.random.default_rng(0), 2, 4, 4, 4)
    out, ref = _port_from_jax(
        jtiny.TinyDecoder(widths=widths, blocks_per_stage=blocks),
        tiny.TinyDecoder(widths=widths, blocks_per_stage=blocks),
        convert.tiny_decoder_state_dict, z)
    side = 4 * 2 ** (len(widths) - 1)
    assert out.shape == ref.shape == (2, side, side, 3)
    _close(out, ref)


@pytest.mark.parametrize("widths,blocks", [((8, 8, 16), 2), ((8, 16), 1)])
def test_tiny_encoder(widths, blocks):
    x = normal(np.random.default_rng(1), 2, 16, 16, 3)
    out, ref = _port_from_jax(
        jtiny.TinyEncoder(widths=widths, blocks_per_stage=blocks),
        tiny.TinyEncoder(widths=widths, blocks_per_stage=blocks),
        convert.tiny_encoder_state_dict, x)
    side = 16 // 2 ** (len(widths) - 1)
    assert out.shape == ref.shape == (2, side, side, 4)
    _close(out, ref)


@pytest.mark.parametrize("down_factor", [2, 4])
def test_tiny_cr(down_factor):
    x = np.random.default_rng(2).uniform(0, 1, (2, 16, 16, 3)) \
        .astype(np.float32)
    kw = dict(width=8, blocks=2, down_factor=down_factor, up_width=4)
    out, ref = _port_from_jax(JTinyCR(**kw), TinyCR(**kw),
                              convert.tiny_cr_state_dict, x)
    assert out.shape == ref.shape == x.shape
    _close(out, ref)
    assert np.abs(out - x).max() > 1e-3   # the delta is not zero


@pytest.mark.parametrize("scale_factor", [8, 2])
def test_tiny_autoencoder_pair_defaults(scale_factor):
    """The pair at the JAX package's default widths: the same stage widths,
    and the same outputs on one small input."""
    assert tiny.tiny_widths_for(scale_factor) == \
        jtiny.tiny_widths_for(scale_factor)
    enc, dec = tiny.tiny_autoencoder_pair(scale_factor)
    jenc, jdec = jtiny.tiny_autoencoder_pair(scale_factor)
    side = 2 * scale_factor
    x = normal(np.random.default_rng(3), 1, side, side, 3)
    out, ref = _port_from_jax(jenc, enc, convert.tiny_encoder_state_dict, x)
    _close(out, ref)
    z = normal(np.random.default_rng(4), 1, 2, 2, 4)
    out, ref = _port_from_jax(jdec, dec, convert.tiny_decoder_state_dict, z)
    _close(out, ref)
    assert ref.shape == (1, side, side, 3)


def test_tiny_state_dict_names():
    """The port's own layout, documented in convert.py."""
    names = set(tiny.TinyDecoder(widths=(16, 8), blocks_per_stage=1)
                .state_dict())
    assert names == {"conv_in.weight", "conv_in.bias",
                     "stages.0.0.conv1.weight",
                     "stages.0.0.conv1.bias", "stages.0.0.conv2.weight",
                     "stages.0.0.conv2.bias", "stages.1.0.conv1.weight",
                     "stages.1.0.conv1.bias", "stages.1.0.conv2.weight",
                     "stages.1.0.conv2.bias", "ups.0.weight",
                     "conv_out.weight", "conv_out.bias"}
    assert "downs.0.weight" in tiny.TinyEncoder(widths=(8, 16)).state_dict()
    assert {"down.weight", "res.0.conv1.weight", "up_proj.weight",
            "conv_out.bias"} <= set(TinyCR().state_dict())
