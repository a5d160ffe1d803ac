"""Guards of the port's boundaries: it imports without jax, cv2 or PIL,
chip_smoke.py refuses to run without CUDA, the sampler, the train steps,
the server and every CLI target the card unless asked for the CPU and take
every dataset flag, the JPEG decoder refuses progressive, CMYK and
truncated files, the inference-only kernels raise where a gradient is
wanted, and a CUDA tensor reaching a kernel wrapper whose library cannot be
built raises rather than falling back."""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

BLOCKED_IMPORT = """
import importlib, pkgutil, sys
for name in sys.argv[1:]:
    sys.modules[name] = None  # any import of these now raises ImportError
import hifidiff_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hifidiff_tpu_torch.__path__,
                                               "hifidiff_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def _port_modules():
    import pkgutil

    import hifidiff_tpu_torch

    return {m.name for m in pkgutil.walk_packages(
        hifidiff_tpu_torch.__path__, "hifidiff_tpu_torch.")}


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_port_imports_with_jax_blocked():
    res = _run([sys.executable, "-c", BLOCKED_IMPORT, "jax", "jaxlib", "flax",
                "optax", "hifidiff_tpu"], REPO)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20
    assert {"hifidiff_tpu_torch.train.steps", "hifidiff_tpu_torch.vae.tiny",
            "hifidiff_tpu_torch.models.tiny_cr"} <= _port_modules()
    assert {f"hifidiff_tpu_torch.{m}" for m in (
        "cli.common", "cli.serve", "cli.test_refiner", "cli.serve_bench",
        "data.core", "data.procedural", "eval.metrics",
        "utils.logging")} <= _port_modules()
    assert {f"hifidiff_tpu_torch.cli.{m}" for m in TRAIN_CLIS} \
        <= _port_modules()
    assert {f"hifidiff_tpu_torch.{m}" for m in (
        "eval.vgg", "eval.lpips", "eval.niqe", "train.distill")} \
        <= _port_modules()
    assert {f"hifidiff_tpu_torch.{m}" for m in PNG_PATH} <= _port_modules()
    assert {f"hifidiff_tpu_torch.{m}" for m in JPEG_PATH} <= _port_modules()
    assert {f"hifidiff_tpu_torch.{m}" for m in WEBP_PATH} <= _port_modules()
    assert {f"hifidiff_tpu_torch.scripts.{m}" for m in QUALITY_SCRIPTS} \
        | {"hifidiff_tpu_torch.scripts.common"} <= _port_modules()


# the PNG data path: the port's own resizes and decoder in place of cv2 and
# PIL
PNG_PATH = ("data.resize", "data.image_io", "data.degradations",
            "data.multipie", "data.pretraining", "ops.resize", "cli.infer_cr")
# the JPEG codec slice: the host library's loader, the codec, the native
# data-path core and the K-Face datasets
JPEG_PATH = ("data.host", "data.jpeg", "data.native", "data.kface")
# the WebP reader and the cv2 sites' EXIF orientation
WEBP_PATH = ("data.webp", "data.orientation", "data.image_files")

WEBP_BLOCKED = """
import sys
for name in ("cv2", "PIL", "jax", "hifidiff_tpu"):
    sys.modules[name] = None
from hifidiff_tpu_torch.data import image_io, webp
root = "tests/fixtures/"
face = open(root + "webp/lossless_face_160x160.webp", "rb").read()
assert image_io.decode_image(face, reader="pil").shape == (160, 160, 3)
assert (webp.decode_webp_plain(face) == webp.decode_webp(face)).all()
turned = open(root + "orientation/exif_o6_7x5.webp", "rb").read()
assert image_io.decode_image(turned, reader="cv2").shape == (7, 5, 3)
import hashlib, json
golden = json.load(open(root + "webp/digests.json"))["decode"]
for name in ("anim_lossless_21x19.webp", "anim_lossy_alpha_face_160x160.webp"):
    data = open(root + "webp/" + name, "rb").read()
    rgb = webp.decode_webp(data)
    assert hashlib.sha256(rgb.tobytes()).hexdigest() == golden[name]["pil"][
        "sha256"], name
    print("animated", name, "read as PIL and cv2 read it")
assert (webp.decode_webp_plain(data := open(
    root + "webp/anim_lossless_21x19.webp", "rb").read())
    == webp.decode_webp(data)).all()
cmyk = open(root + "jpeg/pil_cmyk_16x16.jpg", "rb").read()
by_reader = json.load(open(root + "jpeg/digests.json"))["decode_by_reader"]
for how in ("pil", "cv2"):
    rgb = image_io.decode_image(cmyk, reader=how)
    assert hashlib.sha256(rgb.tobytes()).hexdigest() == by_reader[
        "pil_cmyk_16x16.jpg"][how]["sha256"], how
print("CMYK read by both readers")
for name in ("refused_anim_frame_past_canvas_34x36",
             "refused_truncated_45x37"):
    try:
        webp.decode_webp(open(root + "webp/" + name + ".webp", "rb").read())
        raise SystemExit(name + " decoded")
    except webp.WebPError as e:
        print(e)
"""


# the quality scripts (hifidiff_tpu_torch/scripts/)
QUALITY_SCRIPTS = ("cache_quality", "tae_quality", "tiny_cr_quality",
                   "tiny_dn_quality", "distill_quality", "turbo_quality",
                   "idc_hard_demo")


@pytest.mark.parametrize("name", QUALITY_SCRIPTS)
def test_quality_scripts_default_device_is_the_card(monkeypatch, tmp_path,
                                                    name):
    """Without `--device` each quality script targets the card and raises
    without one, before it trains, samples or writes anything."""
    import importlib

    module = importlib.import_module(f"hifidiff_tpu_torch.scripts.{name}")
    assert module.Config().device == "cuda"
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "record.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--out", str(out)])
    assert not any(tmp_path.iterdir())


def test_webp_reader_with_cv2_and_pil_blocked():
    """The WebP reader, the EXIF orientation and the CMYK JPEG readings
    run with cv2, PIL, jax and the JAX package blocked, as on the card's
    host: a fixture decoded by the library and the plain version alike,
    an orientation-6 file turned, two animations read to their digests
    (the lossless one by the plain version too), a CMYK file by each
    reader to its digest, a frame past its canvas and a truncated file
    refused by name."""
    res = _run([sys.executable, "-c", WEBP_BLOCKED], REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("read as PIL and cv2 read it") == 2
    assert "CMYK read by both readers" in res.stdout
    assert "past the 34 x 36 canvas" in res.stdout \
        and "truncated" in res.stdout


def test_port_imports_with_cv2_and_pil_blocked():
    """Every module of the port imports with cv2 and PIL blocked (and jax):
    the card's machine has neither."""
    res = _run([sys.executable, "-c", BLOCKED_IMPORT, "cv2", "PIL", "jax",
                "hifidiff_tpu"], REPO)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) == len(_port_modules())


def test_infer_cr_default_device_is_the_card(monkeypatch, tmp_path):
    """`infer_cr` targets the card: without one it raises before it writes
    anything, and runs on the CPU only when asked."""
    from hifidiff_tpu_torch.cli import infer_cr
    from hifidiff_tpu_torch.utils.logging import png_bytes

    monkeypatch.chdir(tmp_path)
    (tmp_path / "face.png").write_bytes(png_bytes(np.full((40, 36, 3), 90,
                                                          np.uint8)))
    argv = ["--image", "face.png", "--size", "32", "--width", "8",
            "--enc-depths", "1", "--mid-depth", "1", "--output", "out.png"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer_cr.main(argv)
    assert not (tmp_path / "out.png").exists()
    out = infer_cr.main(argv + ["--device", "cpu"])
    assert out.shape == (1, 32, 32, 3) and (tmp_path / "out.png").exists()


def test_chip_smoke_fails_without_cuda():
    res = _run([sys.executable, "chip_smoke.py"], REPO,
               {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run([sys.executable, "chip_smoke.py"], tmp_path,
               {"PYTHONPATH": "", "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


TINY = dict(
    cr=dict(width=8, resolution=32, enc_nums=(1,), mid_num=1, dec_nums=(1,)),
    refiner=dict(latent_size=8, width=16, enc_nums=(1,), mid_num=1,
                 dec_nums=(1,), idc_stage_sizes=(1, 1, 1, 1)),
    vae=dict(block_out=(32, 32, 32), layers_per_block=1))


def _tiny_models():
    from hifidiff_tpu_torch.models.cr import CoarseRestoration
    from hifidiff_tpu_torch.models.refiner import FacialRefiner
    from hifidiff_tpu_torch.vae.model import AutoencoderKL

    torch.manual_seed(0)
    return (FacialRefiner(**TINY["refiner"]), CoarseRestoration(**TINY["cr"]),
            AutoencoderKL(**TINY["vae"]))


def test_sampler_default_device_is_the_card(monkeypatch):
    """No `device` argument means CUDA: without a card the function raises
    and does not carry on on the CPU, whatever device the models are on."""
    from hifidiff_tpu_torch.pipeline import build_refiner_sampler_split

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_refiner_sampler_split(*_tiny_models())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_refiner_sampler_split(*_tiny_models(), device="cuda")


@pytest.mark.parametrize("builder", ["build_refiner_sampler",
                                     "build_unconditional_sampler"])
def test_other_samplers_default_device_is_the_card(monkeypatch, builder):
    """The monolithic and the unconditional sampler target the card too:
    without one they raise, and run on the CPU only when asked."""
    from hifidiff_tpu_torch import pipeline
    from hifidiff_tpu_torch.models.denoiser import Denoiser

    refiner, cr, vae = _tiny_models()
    args = (refiner, cr, vae) if builder == "build_refiner_sampler" else (
        Denoiser(width=16, enc_nums=(1,), mid_num=1, dec_nums=(1,)), vae)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(pipeline, builder)(*args)
    assert callable(getattr(pipeline, builder)(*args, device="cpu"))


def test_sampler_runs_on_the_cpu_when_asked():
    from hifidiff_tpu_torch.pipeline import (RefinerPipelineConfig,
                                             build_refiner_sampler_split)

    torch.set_num_threads(1)
    sample = build_refiner_sampler_split(
        *_tiny_models(),
        RefinerPipelineConfig(num_inference_steps=1, latent_size=8),
        device="cpu")
    faces = sample(torch.zeros((1, 32, 32, 3), dtype=torch.uint8),
                   generator=torch.Generator().manual_seed(0))
    assert faces.device.type == "cpu" and faces.dtype == torch.uint8
    assert faces.shape == (1, 32, 32, 3)


SERVE_TINY = dict(size=32, width=16, enc_depths="1", mid_depth=1,
                  dec_depths="1", idc_stages="1,1,1,1", cr_width=8,
                  cr_enc_depths="1", cr_mid_depth=1, vae_blocks="32,32,32",
                  vae_layers=1, num_inference_steps=1, dtype="f32")


def test_server_default_device_is_the_card(monkeypatch):
    """The server's Config targets the card: without one `create_server`
    raises, and builds its runner on the CPU only when asked."""
    from hifidiff_tpu_torch.cli import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.create_server(serve.Config(port=0, **SERVE_TINY))
    run, _, _ = serve.build_runner(serve.Config(device="cpu", **SERVE_TINY))
    assert run.device.type == "cpu"


def test_eval_cli_default_device_is_the_card(monkeypatch):
    from hifidiff_tpu_torch.cli import test_refiner

    flags = [a for k, v in dict(SERVE_TINY, synthetic=4, batch_size=4,
                                grid_every=0).items() if k != "dtype"
             for a in (f"--{k.replace('_', '-')}", str(v))]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_refiner.main(flags)
    out = test_refiner.main(flags + ["--device", "cpu"])
    assert set(out) == {"psnr", "ssim"}


TRAIN_CLIS = ["train_vae", "train_cr", "pretrain_idc", "test_idc",
              "pretrain_denoiser", "train_refiner", "convergence_demo",
              "train_tae", "train_tiny_cr", "train_tiny_dn", "distill"]
# the tiny stack's flags each training CLI takes
TRAIN_TINY = dict(size=32, vae_blocks="32,32,32", vae_layers=1, width=16,
                  enc_depths="1", mid_depth=1, dec_depths="1", cr_width=8,
                  cr_enc_depths="1", cr_mid_depth=1, idc_stages="1,1,1,1")


def _train_flags(name, **more):
    import dataclasses
    import importlib

    fields = {f.name for f in dataclasses.fields(importlib.import_module(
        f"hifidiff_tpu_torch.cli.{name}").Config)}
    kw = {k: v for k, v in TRAIN_TINY.items() if k in fields}
    if name == "train_cr":   # its own widths are the CR's
        kw.update(width=8, enc_depths="1", mid_depth=1)
    if name == "convergence_demo":
        kw = dict(n=8, batch_size=4, epochs_vae=1, epochs_cr=1,
                  epochs_idc=1, epochs_dn=1, epochs_refiner=1, check=0)
    else:
        kw.update(procedural=8, batch_size=4, num_epochs=1)
        kw = {k: v for k, v in kw.items() if k in fields}
    kw.update(more)
    return [a for k, v in kw.items()
            for a in (f"--{k.replace('_', '-')}", str(v))]


@pytest.mark.parametrize("name", TRAIN_CLIS)
def test_training_clis_default_device_is_the_card(monkeypatch, tmp_path,
                                                  name):
    """Without `--device` each training CLI targets the card and raises
    without one, before it trains or writes anything; the CPU takes it only
    when asked (the runs themselves: tests/test_torch_train_cli.py)."""
    import importlib

    main = importlib.import_module(f"hifidiff_tpu_torch.cli.{name}").main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_train_flags(name))
    assert not any(p.suffix in (".pt", ".jsonl", ".png")
                   for p in tmp_path.rglob("*"))


def _real_data_flags(name, **more):
    """`_train_flags` without `--procedural`: the CLI on its real data."""
    argv = _train_flags(name, **more)
    i = argv.index("--procedural")
    return argv[:i] + argv[i + 2:]


JPEG_DIR = "<a directory holding a JPEG>"


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("celeba_jpeg")
    (root / "00001.jpg").write_bytes(
        (FIXTURES / "pil_420_q75_80x96.jpg").read_bytes())
    return str(root)


@pytest.mark.parametrize("name, flags, item", [
    pytest.param("train_vae", dict(celeba_root=JPEG_DIR), "§A9.2",
                 id="train_vae-flags0-§A9.2"),
    pytest.param("pretrain_denoiser", dict(celeba_root=JPEG_DIR), "§A9.2",
                 id="pretrain_denoiser-flags1-§A9.2"),
    pytest.param("train_cr", dict(dataroot="/data/mp"), "§A9.2",
                 id="train_cr-flags2-§A9.2"),
    pytest.param("test_idc", dict(dataroot="/data/kface"), "§A9.2",
                 id="test_idc-flags4-§A9.2"),
    pytest.param("train_refiner", dict(dataroot="/data/mp"), "§A9.2",
                 id="train_refiner-flags5-§A9.2"),
    pytest.param("train_tae", dict(celeba_root=JPEG_DIR), "§A9.2",
                 id="train_tae-flags6-§A9.2"),
    pytest.param("train_tiny_cr", dict(dataroot="/data/mp"), "§A9.2",
                 id="train_tiny_cr-blind"),
    pytest.param("train_tiny_dn", dict(dataroot="/data/mp"), "§A9.2",
                 id="train_tiny_dn-blind"),
    pytest.param("distill", dict(dataroot="/data/mp"), "§A9.2",
                 id="distill-blind"),
])
def test_training_cli_refusals(monkeypatch, tmp_path, jpeg_dir, name, flags,
                               item):
    """Nothing is refused for want of JPEG: `--dataroot` of the CLIs whose
    Multi-PIE train split takes the blind branch, K-Face, and a CelebA-HQ
    directory holding a JPEG are accepted; without generated data the CLI
    goes on to look for the card and raises only for the want of one,
    before anything is written."""
    import importlib

    main = importlib.import_module(f"hifidiff_tpu_torch.cli.{name}").main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = {k: jpeg_dir if v == JPEG_DIR else v for k, v in flags.items()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_real_data_flags(name, **flags))
    assert not list(tmp_path.rglob("*"))


FIXTURES = REPO / "tests" / "fixtures" / "jpeg"


@pytest.mark.parametrize("name, cut, match", [
    ("pil_progressive_32x32.jpg", 0, "progressive JPEG"),
    ("pil_cmyk_16x16.jpg", 0, "CMYK"),
    ("pil_420_q75_80x96.jpg", 40, "truncated"),
])
def test_jpeg_decoder_refusals(name, cut, match):
    """No unsupported JPEG is decoded approximately: an incomplete
    progressive file (the progressive fixture, which decodes whole, cut
    after its first two scans: libjpeg would smooth it), a CMYK file read
    without naming the reader whose CMYK -> RGB it takes, and a file cut
    `cut` bytes short (tests/fixtures/jpeg) are each refused, naming what
    they are."""
    from hifidiff_tpu_torch.data.image_files import incomplete_progressive
    from hifidiff_tpu_torch.data.jpeg import JPEGError, decode_jpeg

    data = (FIXTURES / name).read_bytes()
    if "progressive" in name:
        data = incomplete_progressive(data, 2)
    with pytest.raises(JPEGError, match=match):
        decode_jpeg(data[:len(data) - cut])


@pytest.mark.parametrize("name, flags", [
    ("train_vae", dict(multipie_root="/data/mp", celeba_root="/data/c")),
    ("pretrain_denoiser", dict(multipie_root="/data/mp")),
    ("pretrain_idc", dict(dataroot="/data/mp")),
    ("train_tae", dict(celeba_root="/data/celeba")),
])
def test_png_dataset_flags_accepted(monkeypatch, tmp_path, name, flags):
    """The PNG datasets' flags are no longer refused: without generated data
    the CLI goes on to look for the card, and raises only for the want of
    one."""
    import importlib

    main = importlib.import_module(f"hifidiff_tpu_torch.cli.{name}").main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_real_data_flags(name, **flags))


STEP_FACTORIES = ["make_cr_train_step", "make_cr_eval_step",
                  "make_idc_train_step", "make_denoiser_train_step",
                  "make_denoiser_train_step_cached", "make_vae_train_step",
                  "make_refiner_train_step"]


@pytest.mark.parametrize("factory", STEP_FACTORIES)
def test_train_steps_default_device_is_the_card(monkeypatch, factory):
    """No `device` argument means CUDA: without a card every step factory
    raises, and builds its step on the CPU only when asked to."""
    from hifidiff_tpu_torch.train import steps

    refiner, cr, vae = _tiny_models()
    frozen = {"make_idc_train_step": (cr,), "make_denoiser_train_step": (vae,),
              "make_refiner_train_step": (cr, vae)}.get(factory, ())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(steps, factory)(*frozen)
    assert callable(getattr(steps, factory)(*frozen, device="cpu"))


DISTILL_FACTORIES = ["make_distill_train_step", "make_tiny_dn_train_step",
                     "make_tiny_cr_train_step", "make_tae_train_step"]


@pytest.mark.parametrize("factory", DISTILL_FACTORIES)
def test_distill_steps_default_device_is_the_card(monkeypatch, factory):
    """The distillation factories of `train/distill.py` as the steps'."""
    from hifidiff_tpu_torch.train import distill

    refiner, cr, vae = _tiny_models()
    frozen = {"make_distill_train_step": (cr, vae, 5),
              "make_tiny_dn_train_step": (cr, vae),
              "make_tiny_cr_train_step": (cr,),
              "make_tae_train_step": (vae,)}[factory]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(distill, factory)(*frozen)
    assert callable(getattr(distill, factory)(*frozen, device="cpu"))


@pytest.mark.parametrize("name, flags", [
    ("test_refiner", dict(vgg16_ckpt="vgg16.pt", lpips_ckpt="lpips.pt",
                          niqe_model="niqe.npz")),
    ("train_cr", dict(loss="composite", lambda_vgg=0.1,
                      vgg19_ckpt="vgg19.pt")),
])
def test_eval_flags_and_vgg_term_not_refused(monkeypatch, tmp_path, name,
                                             flags):
    """`test_refiner`'s three metric flags and `train_cr`'s VGG term are no
    longer refused: with the files in place the CLI goes on to look for the
    card, and raises only for the want of one."""
    import importlib

    main = importlib.import_module(f"hifidiff_tpu_torch.cli.{name}").main
    monkeypatch.chdir(tmp_path)
    for f in flags.values():
        if isinstance(f, str) and "." in f:
            (tmp_path / f).write_bytes(b"")
    argv = _train_flags(name, **flags) if name == "train_cr" else [
        a for k, v in dict(SERVE_TINY, synthetic=4, **flags).items()
        if k != "dtype" for a in (f"--{k.replace('_', '-')}", str(v))]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_train_state_default_device_is_the_card(monkeypatch):
    from hifidiff_tpu_torch.train import optim, steps

    _, cr, _ = _tiny_models()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.TrainState.create(cr, optim.adam)
    state = steps.TrainState.create(cr, optim.adam, device="cpu")
    assert state.device.type == "cpu" and state.step == 0


def test_inference_only_kernels_raise_under_grad():
    """`matmul_w8`, fused GroupNorm+SiLU and the fused small-map block have
    no backward: where a gradient is wanted they raise and do not fall back
    (`ln_film` and the warp have backward kernels and record themselves for
    autograd instead)."""
    from hifidiff_tpu_torch.nn.naf import ConditionalNAFBlock
    from hifidiff_tpu_torch.ops import kernels, norm, warp

    x = torch.randn(2, 128, 1, 1, requires_grad=True)
    for name in ("matmul_w8", "group_norm_silu", "cnaf_small"):
        with pytest.raises(RuntimeError, match="no backward"):
            kernels.check_launchable(name, x)
        with torch.no_grad():
            kernels.check_launchable(name, x)
    blk = ConditionalNAFBlock(128, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        blk(x, None, torch.zeros(1, 512), fuse_small=True)
    w = torch.ones(128, requires_grad=True)
    s = torch.zeros(2, 128, requires_grad=True)
    out = norm.ln_film(x, w, w, s, s)
    assert out.grad_fn.name() == "_LnFilmBackward"
    theta = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0]]]).repeat(2, 1, 1)
    assert warp.affine_warp(x, theta).grad_fn.name() == "_AffineWarpBackward"
    with torch.no_grad():
        assert norm.ln_film(x, w, w, s, s).grad_fn is None


@pytest.mark.cuda
def test_cuda_tensor_without_library_raises(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from hifidiff_tpu_torch.ops import kernels, norm

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    kernels.library.cache_clear()
    try:
        x = torch.randn(2, 8, 4, 4, device="cuda")
        w, s = torch.ones(8, device="cuda"), torch.zeros(1, 8, device="cuda")
        before = kernels.LAUNCHES["ln_film"]
        with torch.inference_mode(), pytest.raises(OSError):
            norm.ln_film(x, w, w, s, s)
        assert kernels.LAUNCHES["ln_film"] == before
    finally:
        kernels.library.cache_clear()


# the CLIs that run data-parallel under `torchrun`, as the JAX package's run
# under `jax.distributed` (the server's replicas are in one process)
DP_CLIS = ("train_vae", "train_cr", "pretrain_idc", "pretrain_denoiser",
           "train_refiner", "train_tae", "train_tiny_cr", "train_tiny_dn",
           "distill", "test_refiner")
PARALLEL = ("parallel.distributed", "parallel.mesh", "parallel.tp",
            "parallel.mp_dryrun", "utils.timing", "utils.checks")


def test_only_the_launcher_module_reads_the_environment():
    """torchrun's variables are read in `parallel/distributed.py` alone; no
    other module of the port reads the environment."""
    root = REPO / "hifidiff_tpu_torch"
    readers = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                     if any(w in p.read_text() for w in ("os.environ",
                                                         "os.getenv",
                                                         "getenv(")))
    assert readers == ["parallel/distributed.py"]


def test_parallel_modules_import_without_jax_cv2_pil():
    res = _run([sys.executable, "-c", BLOCKED_IMPORT, "jax", "jaxlib",
                "flax", "optax", "hifidiff_tpu", "cv2", "PIL"], REPO)
    assert res.returncode == 0, res.stderr
    assert {f"hifidiff_tpu_torch.{m}" for m in PARALLEL} <= _port_modules()


TORCHRUN_DEVICE = """
import importlib, sys, torch
mode = sys.argv[1]
torch.cuda.is_available = lambda: mode == "card"
current = {}
torch.cuda.set_device = lambda i: current.update(index=i)
torch.cuda.current_device = lambda: current["index"]
from hifidiff_tpu_torch.parallel import maybe_initialize
assert maybe_initialize(backend="gloo")     # the variables torchrun sets


class Stop(Exception):
    pass


for name in sys.argv[2:]:
    cli = importlib.import_module("hifidiff_tpu_torch.cli." + name)

    def spy(cfg, who, real=cli.data_parallel, name=name):
        device, group = real(cfg, who)
        print(name, device, group is not None)
        raise Stop

    cli.data_parallel = spy
    try:
        cli.main(["--synthetic", "4"]
                 + (["--device", "cpu"] if mode == "cpu" else []))
    except Stop:
        pass
    except RuntimeError as e:
        print(name, "raised" if "no CUDA device" in str(e) else e)
"""


@pytest.mark.parametrize("mode, want", [("card", "cuda:3 True"),
                                        ("none", "raised"),
                                        ("cpu", "cpu True")])
def test_clis_under_torchrun_target_the_ranks_card(mode, want):
    """Under torchrun's variables (one process, LOCAL_RANK 3, a world-1
    group on an ephemeral port) each data-parallel CLI's `data_parallel`
    starts from the group and resolves to `cuda:LOCAL_RANK` with a card
    (`torch.cuda` stubbed), raises without one, and takes the CPU with
    `--device cpu`."""
    res = _run([sys.executable, "-c", TORCHRUN_DEVICE, mode, *DP_CLIS], REPO,
               {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "3",
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "0"})
    assert res.returncode == 0, res.stderr
    lines = [ln for ln in res.stdout.splitlines()
             if ln.split(" ")[0] in DP_CLIS]
    assert lines == [f"{name} {want}" for name in DP_CLIS], res.stdout


# -- the host image library (csrc/host/image.cc) ------------------------------

PLAIN_HOMES = ("data/resize.py", "data/image_io.py", "data/degradations.py",
               "data/jpeg.py", "data/webp.py")


def test_plain_image_versions_named_only_in_their_modules():
    """The host image path's plain versions (every `*_plain` function that
    `data/resize.py`, `data/image_io.py`, `data/degradations.py`,
    `data/jpeg.py` and `data/webp.py` define) are named by no other module
    of the port: only tests and chip_smoke.py call them."""
    import re

    root = REPO / "hifidiff_tpu_torch"
    plain = {name for home in PLAIN_HOMES for name in re.findall(
        r"^def (\w+_plain)\(", (root / home).read_text(), re.M)}
    assert plain == {"resize_cv2_plain", "resize_pil_plain",
                     "decode_png_plain", "decode_bmp_plain", "filter2d_plain",
                     "coefficients_plain", "ycck_to_cmyk_plain",
                     "cmyk_to_rgb_plain", "decode_webp_plain",
                     "vp8_coefficients_plain", "decode_alpha_plain"}
    naming = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                    if any(re.search(rf"\b{n}\b", p.read_text())
                           for n in plain))
    assert naming == sorted(PLAIN_HOMES)


def test_host_library_is_a_cdll_and_image_cc_has_its_flags(monkeypatch,
                                                           tmp_path):
    """The host library loads as `ctypes.CDLL` (each call releases the GIL;
    `PyDLL` would hold it); `image.cc` and `webp.cc` compile with
    -ffp-contract=off, and `native.cc` and `jpeg.cc` with
    `native/build.sh`'s flags exactly; no source with -ffast-math or
    -Ofast."""
    import ctypes
    import shlex

    from hifidiff_tpu_torch.data import host

    lib = host.library()
    assert type(lib) is ctypes.CDLL and not isinstance(lib, ctypes.PyDLL)
    assert "PyDLL" not in (REPO / "hifidiff_tpu_torch/data/host.py").read_text()
    line = next(ln for ln in (REPO / "native/build.sh").read_text()
                .splitlines() if ln.strip().startswith("g++"))
    build_sh = [w for w in shlex.split(line.replace("\\", ""))
                if w.startswith("-") and w != "-o"]
    commands = []

    def capture(cmds):
        commands.extend(cmds)
        raise RuntimeError("captured")

    monkeypatch.setattr(host, "_run", capture)
    monkeypatch.setattr(host, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="captured"):
        host._build(tmp_path / "libx.so")
    by_source = {pathlib.Path(c[-1]).name: c for c in commands}
    assert set(by_source) == {"jpeg.cc", "native.cc", "image.cc", "webp.cc"}
    for name, cmd in by_source.items():
        flags = [w for w in cmd[1:] if w.startswith("-") and w not in (
            "-c", "-o")]
        extra = (["-ffp-contract=off"] if name in ("image.cc", "webp.cc")
                 else [])
        assert flags == build_sh + extra, name
        assert not {"-ffast-math", "-Ofast"} & set(cmd)


def _image_trees(root):
    """A two-pid Multi-PIE tree (an extreme angle and the frontal with its
    patch, 40 x 40 PNGs), a CelebA-HQ directory of two PNGs and a K-Face
    crop tree of two JPEGs."""
    from hifidiff_tpu_torch.data.jpeg import encode_jpeg
    from hifidiff_tpu_torch.utils.logging import png_bytes

    rng = np.random.default_rng(0)

    def put(path, data):
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)

    for pid in ("p1", "p2"):
        for angle in ("11_0", "05_1"):
            for name in ("00.png", "00_patch.png"):
                put(root / "mp" / "train" / pid / angle / name, png_bytes(
                    rng.integers(0, 256, (40, 40, 3), np.uint8)))
    for j in range(2):
        put(root / "celeba" / f"{j}.png",
            png_bytes(rng.integers(0, 256, (48, 48, 3), np.uint8)))
    base = root / "kf" / "train" / "k1" / "S001" / "L1" / "E01"
    for angle in (7, 1):
        put(base / f"C{angle}.jpg", encode_jpeg(
            rng.integers(0, 256, (48, 48, 3), np.uint8), 90))
    return root


def test_every_caller_reaches_the_host_image_library(monkeypatch, tmp_path):
    """The datasets, `blind_degrade`'s cv2 path and `infer_cr` decode,
    resize and blur through the host library (its `hi_*` calls counted),
    with the plain versions made to raise: no path falls back to them."""
    import collections

    from hifidiff_tpu_torch.cli import infer_cr
    from hifidiff_tpu_torch.data import (degradations, host, image_io, kface,
                                         multipie, pretraining, procedural,
                                         resize)

    for module, name in ((resize, "resize_cv2_plain"),
                         (resize, "resize_pil_plain"),
                         (image_io, "decode_png_plain"),
                         (degradations, "filter2d_plain")):
        monkeypatch.setattr(module, name, lambda *a, _n=name, **k: (
            _ for _ in ()).throw(AssertionError(f"{_n} called")))
    lib = host.library()
    calls = collections.Counter()

    class Counting:
        def __getattr__(self, name):
            fn = getattr(lib, name)
            if not name.startswith("hi_"):
                return fn

            def call(*args):
                calls[name] += 1
                return fn(*args)

            call.__name__ = name
            return call

    monkeypatch.setattr(host, "library", lambda: Counting())
    root = _image_trees(tmp_path)
    mp, png = str(root / "mp"), "hi_png_rgb"
    cv2_f32, cv2_u8, pil, blur = ("hi_resize_cv2_f32",
                                  "hi_resize_cv2_u8_cubic", "hi_resize_pil",
                                  "hi_filter2d")
    cases = {
        "MultiPIEDataset": (lambda: multipie.MultiPIEDataset(
            mp, size=32, use_blind=False, use_patch=True)[0],
            {png, cv2_f32, pil}),
        "MultiPIEDataset, blind": (lambda: multipie.MultiPIEDataset(
            mp, size=32)[0], {png, blur, cv2_f32}),
        "MultiPIEIDCDataset": (lambda: multipie.MultiPIEIDCDataset(
            mp, size=32)[0], {png, cv2_u8, cv2_f32}),
        "MultiPIEInferenceDataset": (lambda: multipie.MultiPIEInferenceDataset(
            mp, size=32)[0], {png, pil}),
        "MultiPIEHQDataset": (lambda: pretraining.MultiPIEHQDataset(
            mp, size=32)[0], {png, cv2_f32}),
        "CelebAHQDataset": (lambda: pretraining.CelebAHQDataset(
            str(root / "celeba"), size=32)[0], {png, pil}),
        "KFaceCropDataset": (lambda: kface.KFaceCropDataset(
            str(root / "kf"), size=32, include_patches=False)[0], {pil}),
        "ProceduralFaceDataset": (lambda: procedural.ProceduralFaceDataset(
            2, 32, keys=("lr",))[0], {cv2_f32}),
        "infer_cr": (lambda: infer_cr.main([
            "--image", str(root / "mp/train/p1/11_0/00.png"), "--size", "32",
            "--width", "8", "--enc-depths", "1", "--mid-depth", "1",
            "--output", str(tmp_path / "out.png"), "--device", "cpu"]),
            {png, pil}),
    }
    for label, (run, want) in cases.items():
        calls.clear()
        run()
        assert set(calls) == want, (label, dict(calls))
