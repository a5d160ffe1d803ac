"""Weight round trip: JAX variable trees of flax's own structure (from
`jax.eval_shape` of each model's init, filled with seeded numbers) ->
hifidiff_tpu_torch.convert -> strict load into the port model -> its
`state_dict()` -> the JAX package's importers -> the same tree, leaf for
leaf. Covers the tiny CR, FacialRefiner (params + batch_stats) and VAE, and
the refiner with an int8 denoiser subtree (`quantize_variables`)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hifidiff_tpu.models import CoarseRestoration as JCR
from hifidiff_tpu.models import FacialRefiner as JRefiner
from hifidiff_tpu.ops import quant as jquant
from hifidiff_tpu.utils import torch_import as ti
from hifidiff_tpu.vae import AutoencoderKL as JVAE
from hifidiff_tpu.vae.import_torch import vae_params_from_torch
from hifidiff_tpu_torch import convert
from hifidiff_tpu_torch.models.cr import CoarseRestoration
from hifidiff_tpu_torch.models.refiner import (FacialRefiner,
                                               quantize_denoiser_)
from hifidiff_tpu_torch.ops import quant
from hifidiff_tpu_torch.vae.model import AutoencoderKL
from torch_parity import state_numpy

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
CR = dict(width=8, resolution=32, enc_nums=(1, 1), mid_num=1, dec_nums=(1, 1))
REF = dict(latent_size=8, width=16, enc_nums=(1, 1), mid_num=1,
           dec_nums=(1, 1), idc_stage_sizes=(1, 1, 1, 1))
VAE = dict(block_out=(32, 32, 32), layers_per_block=1)


def _filled(init, *args, **kwargs):
    shapes = jax.eval_shape(lambda k: init(k, *args, **kwargs), KEY)
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _assert_same_tree(a, b):
    fa = dict(jax.tree_util.tree_flatten_with_path(a)[0])
    fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert set(fa) == set(fb)
    for path, leaf in fa.items():
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(fb[path]),
                                      err_msg=jax.tree_util.keystr(path))


def _port_state(module, state_dict):
    module.load_state_dict(state_dict, strict=True)
    return state_numpy(module)


def test_cr_round_trip():
    p = _filled(JCR(**CR).init, jnp.zeros((1, 32, 32, 3)))["params"]
    sd = _port_state(CoarseRestoration(**CR), convert.cr_state_dict(p))
    _assert_same_tree(ti.cr_params(sd, (1, 1), 1, (1, 1)), p)


def _refiner_tree():
    return _filled(JRefiner(**REF).init, jnp.zeros((1, 8, 8, 4)),
                   jnp.zeros((1,)), jnp.zeros((1, 32, 32, 3)),
                   jnp.zeros((1, 8, 8, 4)), train=False)


def _refiner_import(sd):
    parts = ti.split_by_prefix(sd)
    den_p, den_s = ti.fused_denoiser_params(parts["denoiser"], (1, 1), 1,
                                            (1, 1))
    idc_p, idc_s = ti.resnet50_params(parts["idc"], (1, 1, 1, 1))
    return {"params": {"idc": idc_p, "denoiser": den_p,
                       "fpg": ti.fpg_params(parts["fpg"], (1, 1))},
            "batch_stats": {"idc": idc_s, "denoiser": den_s}}


def test_refiner_round_trip():
    v = _refiner_tree()
    sd = _port_state(FacialRefiner(**REF), convert.refiner_state_dict(v))
    _assert_same_tree(_refiner_import(sd), v)


def test_quantized_refiner_round_trip(monkeypatch):
    """The denoiser subtree through `quantize_variables` (size threshold
    1024, so that the tree mixes int8 and float layers): its int8 bytes and
    scales load into a port model quantized the same way, and come back
    through the float importers (`split_quantized_state_dict`, then
    `merge_quantized_trees`) leaf for leaf."""
    monkeypatch.setattr(jquant, "W8_MIN_WEIGHT_PARAMS", 1024)
    monkeypatch.setattr(quant, "W8_MIN_WEIGHT_PARAMS", 1024)
    v = _refiner_tree()
    v = {"params": {**v["params"], "denoiser": jquant.quantize_variables(
        v["params"]["denoiser"])}, "batch_stats": v["batch_stats"]}
    flat = jax.tree_util.tree_flatten_with_path(v["params"]["denoiser"])[0]
    names = [p[-1].key for p, _ in flat]
    n_q = names.count("kernel_q")
    assert n_q > 10 and names.count("kernel") > 5
    refiner = FacialRefiner(**REF)
    assert quantize_denoiser_(refiner) == n_q
    sd = _port_state(refiner, convert.refiner_state_dict(v))
    q = {k: t for k, t in sd.items() if k.endswith(".weight_q")}
    assert len(q) == n_q and all(t.dtype == np.int8 for t in q.values())
    assert sd["denoiser.idc_conv.weight_q"].shape == (256, 2048, 1, 1)
    values, scales = convert.split_quantized_state_dict(
        {k: torch.from_numpy(t) for k, t in sd.items()})
    back = convert.merge_quantized_trees(
        _refiner_import({k: t.numpy() for k, t in values.items()}),
        _refiner_import({k: t.numpy() for k, t in scales.items()}))
    _assert_same_tree(back, v)


def test_vae_round_trip():
    p = _filled(JVAE(**VAE).init, jnp.zeros((1, 16, 16, 3)))["params"]
    sd = _port_state(AutoencoderKL(**VAE), convert.vae_state_dict(p))
    _assert_same_tree(vae_params_from_torch(sd, 3, 1), p)
