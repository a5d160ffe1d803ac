"""The split sampler's CUDA graphs (`RefinerSampler.warm_compile`). On the
CPU: what the captures are keyed on, and that `warm_compile` refuses to run
there. On the card (`cuda`-marked, skipped elsewhere): a replay gives the
eager call's bits, on the default path and on the int8 + fused one, and
the captures are dropped and made again after the models change.

No jax here: the `cuda` tests run on the GPU machine with
`python -m pytest --noconftest -m cuda tests/test_torch_graphs.py`."""

import pytest
import torch

from hifidiff_tpu_torch.models.cr import CoarseRestoration
from hifidiff_tpu_torch.models.refiner import (FacialRefiner,
                                               quantize_denoiser_)
from hifidiff_tpu_torch.ops import kernels, quant
from hifidiff_tpu_torch.pipeline import (RefinerPipelineConfig,
                                         build_refiner_sampler_split)
from hifidiff_tpu_torch.random_weights import perturb_
from hifidiff_tpu_torch.vae.model import AutoencoderKL

torch.set_num_threads(1)

# four levels at 16x16 latents: enc3 and dec0 at 2x2 x 128 channels and the
# middle block at 1x1 x 256 pass the fused block's gate
RES, LATENT = 32, 16
CR = dict(width=8, resolution=RES, enc_nums=(1, 1), mid_num=1,
          dec_nums=(1, 1))
REF = dict(latent_size=LATENT, width=16, enc_nums=(1, 1, 1, 1), mid_num=1,
           dec_nums=(1, 1, 1, 1), idc_stage_sizes=(1, 1, 1, 1))
VAE = dict(block_out=(32, 32), layers_per_block=1)


def _models():
    torch.manual_seed(0)
    models = (FacialRefiner(**REF), CoarseRestoration(**CR),
              AutoencoderKL(**VAE))
    g = torch.Generator().manual_seed(0)
    for m in models:
        perturb_(m, g)
    return models


def _sampler(models, device, steps=2, **kw):
    return build_refiner_sampler_split(
        *models, RefinerPipelineConfig(num_inference_steps=steps,
                                       latent_size=LATENT, **kw),
        device=device)


def _images(batch, device="cpu"):
    g = torch.Generator().manual_seed(batch)
    return torch.randint(0, 256, (batch, RES, RES, 3), generator=g,
                         dtype=torch.uint8).to(device)


def test_state_key_follows_the_models():
    """The key changes with every change that drops or moves what a graph
    bakes in: `.to()` and casts, `load_state_dict` (the fused packs),
    `quantize_denoiser_`, `clear_fused_packs`, a mode change; and not on a
    call that changes nothing. The image key changes with the batch."""
    models = _models()
    refiner = models[0]
    sample = _sampler(models, "cpu")
    key = sample._state_key()
    assert sample._state_key() == key
    assert sample._image_key(_images(2)) != sample._image_key(_images(3))
    assert sample._image_key(_images(2)) == sample._image_key(_images(2))

    def changed(what):
        nonlocal key
        new = sample._state_key()
        assert new != key, what
        key = new

    refiner.load_state_dict(refiner.state_dict())
    changed("load_state_dict")
    refiner.denoiser.blocks()[-1].clear_fused_packs()
    changed("clear_fused_packs")
    models[2].to(torch.float64)
    changed("a cast of the VAE")
    models[2].to(torch.float32)
    changed("a cast back")
    refiner.denoiser.train()
    changed("training mode")
    refiner.eval()
    changed("eval mode")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quant, "W8_MIN_WEIGHT_PARAMS", 0)
        quantize_denoiser_(refiner)
    changed("quantize_denoiser_")
    sample(_images(1), generator=torch.Generator().manual_seed(0))
    assert sample._state_key() == key


def test_stale_captures_are_dropped():
    """A call whose models changed since the capture empties the cache and
    runs eagerly (the captures are faked here: the CPU has no graphs)."""
    sample = _sampler(_models(), "cpu")
    lr = _images(2)
    sample._compiled[sample._image_key(lr)] = object()   # a stale capture
    sample._state = ("not", "the", "models'", "state")
    out = sample(lr, generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, RES, RES, 3) and not sample._compiled
    assert sample.replays == 0


def test_warm_compile_refuses_the_cpu():
    sample = _sampler(_models(), "cpu")
    with pytest.raises(RuntimeError, match="CUDA graphs"):
        sample.warm_compile(_images(2),
                            generator=torch.Generator().manual_seed(0))
    assert not sample._compiled


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs capture the card")
    return torch.device("cuda")


def _noise(batch, device):
    g = torch.Generator(device=device).manual_seed(1)
    return {k: torch.randn(batch, LATENT, LATENT, 4, generator=g,
                           device=device)
            for k in ("latents_noise", "posterior_noise")}


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["default", "int8+fused", "cached_2",
                                    "dpmpp"])
def test_replay_is_bit_equal_to_eager(cuda, config):
    models = _models()
    kw = {"int8+fused": dict(fuse_small_naf=True, fused_gn_silu=True),
          "cached_2": dict(cache_interval=2), "dpmpp": dict(
              sampler="dpmpp")}.get(config, {})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quant, "W8_MIN_WEIGHT_PARAMS", 0)
        if config == "int8+fused":
            quantize_denoiser_(models[0])
    models = [m.to(cuda, torch.bfloat16) for m in models]
    sample = _sampler(models, cuda, steps=3, **kw)
    lr, noise = _images(4, cuda), _noise(4, cuda)
    eager = sample(lr, **noise)
    kernels.reset_launches()
    sample.warm_compile(lr, **noise)
    captured = dict(kernels.LAUNCHES)
    assert captured["ln_film"] > 0
    assert (captured["cnaf_small"] > 0) == (config == "int8+fused")
    replays = [sample(lr, **noise) for _ in range(2)]
    assert sample.replays == 2 and kernels.LAUNCHES == captured
    for out in replays:
        assert torch.equal(out, eager)
    assert replays[0].data_ptr() != replays[1].data_ptr()   # fresh tensors
    # another batch is not warmed: it runs eagerly
    other = _images(2, cuda)
    sample(other, **_noise(2, cuda))
    assert sample.replays == 2


@pytest.mark.cuda
def test_captures_made_again_after_to(cuda):
    models = [m.to(cuda) for m in _models()]
    sample = _sampler(models, cuda)
    lr, noise = _images(2, cuda), _noise(2, cuda)
    sample.warm_compile(lr, **noise)
    assert torch.equal(sample(lr, **noise), sample.stages["decode"](
        sample.stages["scan"](*sample.stages["prep"](
            lr, noise["posterior_noise"], noise["latents_noise"]))))
    assert sample.replays == 1
    models[0].to(torch.bfloat16)
    eager = sample(lr, **noise)            # stale: dropped, run eagerly
    assert sample.replays == 1 and not sample._compiled
    sample.warm_compile(lr, **noise)
    assert torch.equal(sample(lr, **noise), eager)
    assert sample.replays == 2
    sample.clear_compiled()
    sample(lr, **noise)
    assert sample.replays == 2


# A child process: the int8 + fused sampler's stages captured before any
# kernel ran in the process (the warm-up inside warm_compile is the first
# use of the kernel library, of the fused blocks' packs, of the GEMM tile's
# launch attributes and of GroupNorm+SiLU's shared-memory opt-in); a replay
# against the eager call; then more than 16,384 distinct matmul_w8 products,
# which empty the GEMM tile's cache of TMA descriptors twice (glibc fills
# freed memory with a byte pattern, so a descriptor read after it was freed
# is garbage); then a replay again, which must give the same bits: the
# captured launches hold their descriptors by value.
_FIRST_USE_RUN = """
import sys
import torch
sys.path.insert(0, "tests")
import test_torch_graphs as t
from hifidiff_tpu_torch.models.refiner import quantize_denoiser_
from hifidiff_tpu_torch.ops import quant
dev = torch.device("cuda")
quant.W8_MIN_WEIGHT_PARAMS = 0
models = t._models()
quantize_denoiser_(models[0])
models = [m.to(dev, torch.bfloat16) for m in models]
sample = t._sampler(models, dev, steps=3, fuse_small_naf=True,
                    fused_gn_silu=True)
lr, noise = t._images(4, dev), t._noise(4, dev)
sample.warm_compile(lr, **noise)
first = sample(lr, **noise)
g = torch.Generator(device=dev).manual_seed(12)
n, K, N = 16500, 256, 128
xs = torch.randn(n + 64, K, generator=g, device=dev).bfloat16()
ws = torch.randint(-127, 128, (n, N, K), generator=g, device=dev,
                   dtype=torch.int8)
scale = 1e-2 * torch.rand(N, generator=g, device=dev) + 1e-3
with torch.inference_mode():
    for i in range(n):
        quant.matmul_w8(xs[i:i + 1 + i % 64], ws[i], scale)
del xs, ws
again = sample(lr, **noise)
sample.clear_compiled()
eager = sample(lr, **noise)
torch.cuda.synchronize()
print("replays", sample.replays, "equal", torch.equal(first, eager),
      torch.equal(again, eager))
sys.exit(0 if sample.replays == 2 and torch.equal(first, eager)
         and torch.equal(again, eager) else 1)
"""


@pytest.mark.cuda
def test_capture_first_in_process_and_past_descriptor_eviction(cuda):
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, MALLOC_PERTURB_="165",
               GLIBC_TUNABLES="glibc.malloc.tcache_count=0",
               PYTHONPATH=str(root))
    run = subprocess.run([sys.executable, "-c", _FIRST_USE_RUN], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
