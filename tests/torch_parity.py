"""Helpers for the parity tests of hifidiff_tpu_torch against hifidiff_tpu.

Weights are made on the port's side: a port module's default init is
perturbed (`random_weights.perturb_`, so that no block is an identity) and
its `state_dict()` goes through the JAX package's own importers to a JAX
tree; `hifidiff_tpu_torch.convert` must turn that tree back into the same
state dict, loaded strictly. (A flax init would cost seconds of XLA compile
per module on the CPU; test_torch_convert.py covers trees of flax's own
structure.) Both sides then run on the same weights and the same numpy
inputs; NCHW outputs are compared with NHWC ones through a permute.
"""

from __future__ import annotations

import numpy as np
import torch

from hifidiff_tpu_torch.random_weights import perturb_


def state_numpy(module: torch.nn.Module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def jax_weights(module: torch.nn.Module, importer, converter, seed: int = 0):
    """Perturb `module` and put it in eval mode; returns `importer` of its
    state dict (the JAX tree, or (params, batch_stats)), after checking that
    `converter` maps that back to the same state dict under a strict load."""
    perturb_(module, torch.Generator().manual_seed(seed))
    module.eval()
    sd = state_numpy(module)
    tree = importer(sd)
    back = converter(*tree) if isinstance(tree, tuple) else converter(tree)
    module.load_state_dict(back, strict=True)
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    return tree


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2))))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def normal(rng: np.random.Generator, *shape, scale: float = 1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def assert_close(actual, expected, rtol: float, atol: float):
    np.testing.assert_allclose(np.asarray(actual, np.float32),
                               np.asarray(expected, np.float32),
                               rtol=rtol, atol=atol)


# The tiny stack of the CLI tests, as the CLIs' size flags: 32 px faces,
# latents 8x8 from a three-level VAE.
TINY_CLI = dict(size=32, width=16, enc_depths="1,1", mid_depth=1,
                dec_depths="1,1", idc_stages="1,1,1,1", cr_width=8,
                cr_enc_depths="1,1", cr_mid_depth=1, vae_blocks="32,32,32",
                vae_layers=1)


def cli_flags(**kw):
    """`--name value` flags for a CLI's argv."""
    return [a for k, v in kw.items()
            for a in (f"--{k.replace('_', '-')}", str(v))]


def refiner_tree(sd, enc=(1, 1), mid=1, dec=(1, 1), idc=(1, 1, 1, 1)):
    """The JAX FacialRefiner variables that the JAX package's importers make
    from a port refiner's state dict."""
    from hifidiff_tpu.utils import torch_import as ti

    parts = ti.split_by_prefix(sd)
    den_p, den_s = ti.fused_denoiser_params(parts["denoiser"], enc, mid, dec)
    idc_p, idc_s = ti.resnet50_params(parts["idc"], idc)
    return {"params": {"idc": idc_p, "denoiser": den_p,
                       "fpg": ti.fpg_params(parts["fpg"], enc)},
            "batch_stats": {"idc": idc_s, "denoiser": den_s}}


def write_tiny_checkpoints(directory, cfg):
    """Build the port's CR / VAE / refiner from `cfg`'s size knobs, perturb
    them (seeds 1, 2, 3), write their state dicts as reference-named torch
    files into `directory`; returns ({"cr", "vae", "refiner": path}, {the
    same: JAX tree made by the JAX package's own importers}, (cr, vae,
    refiner))."""
    from hifidiff_tpu.utils import torch_import as ti
    from hifidiff_tpu.vae.import_torch import vae_params_from_torch
    from hifidiff_tpu_torch import convert
    from hifidiff_tpu_torch.cli.common import build_refiner_models

    cr, vae, refiner, _ = build_refiner_models(cfg)
    enc = tuple(int(x) for x in cfg.cr_enc_depths.split(","))
    n_vae = len(cfg.vae_blocks.split(","))
    trees = {
        "cr": jax_weights(cr, lambda sd: ti.cr_params(
            sd, enc, cfg.cr_mid_depth, (2,) * len(enc)),
            convert.cr_state_dict, seed=1),
        "vae": jax_weights(vae, lambda sd: vae_params_from_torch(
            sd, n_vae, cfg.vae_layers), convert.vae_state_dict, seed=2),
        "refiner": jax_weights(refiner, refiner_tree,
                               convert.refiner_state_dict, seed=3)}
    paths = {}
    for name, m in (("cr", cr), ("vae", vae), ("refiner", refiner)):
        paths[name] = str(directory / f"{name}.pt")
        torch.save(m.state_dict(), paths[name])
    return paths, trees, (cr, vae, refiner)
