"""The port's data, metric and CLI modules against the JAX package's, on the
CPU: `data/core` and `data/procedural` (bit for bit), `eval/metrics` (to
1e-5 absolute, and the pyiqa golden values that tests/test_pyiqa_golden.py
pins for JAX, at that file's tolerances), `cli/common` (the configs' fields
and flags, the checkpoint formats, the CR and VAE against the trees of the
JAX package's own loaders, bit for bit), `utils/logging` and
`cli/test_refiner` on the tiny stack (float32, 2 DDIM steps).
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifidiff_tpu.cli import common as jcommon
from hifidiff_tpu.cli import serve as jserve
from hifidiff_tpu.cli import test_refiner as jtest_refiner
from hifidiff_tpu.data import core as jcore
from hifidiff_tpu.data import procedural as jproc
from hifidiff_tpu.eval import metrics as jmetrics
from hifidiff_tpu.utils import torch_import as ti
from hifidiff_tpu.vae.import_torch import vae_params_from_torch
from hifidiff_tpu_torch import convert
from hifidiff_tpu_torch.cli import common, serve, test_refiner
from hifidiff_tpu_torch.data import core, procedural
from hifidiff_tpu_torch.eval import metrics
from hifidiff_tpu_torch.utils import logging as tlogging
from test_pyiqa_golden import np_psnr_pyiqa, np_rgb_to_y, np_ssim_pyiqa
from torch_parity import TINY_CLI, cli_flags, write_tiny_checkpoints

torch.set_num_threads(1)
# metrics, port vs JAX: float32 sums in another order
METRIC_ATOL = 1e-5


# -- data ------------------------------------------------------------------

def _batches(loader):
    return [{k: v.copy() for k, v in b.items()} for b in loader]


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=False),
    dict(batch_size=4, shuffle=False, drop_last=True),
    dict(batch_size=3, shuffle=True, seed=5),
    dict(batch_size=2, shuffle=True, seed=1, num_shards=3, shard_index=2),
])
def test_loader_matches_jax(kw):
    """Batches, their order and the seeded shuffles of two epochs equal the
    JAX package's loader's, exactly."""
    ds_j = jcommon.SyntheticFaceDataset(10, 8, keys=("lr", "gt"), seed=3)
    ds_p = common.SyntheticFaceDataset(10, 8, keys=("lr", "gt"), seed=3)
    lj, lp = jcore.Loader(ds_j, **kw), core.Loader(ds_p, **kw)
    assert len(lj) == len(lp)
    for _ in range(2):
        bj, bp = _batches(lj), _batches(lp)
        assert len(bj) == len(bp)
        for a, b in zip(bj, bp):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_concat_and_array_datasets_match_jax():
    parts = [(3, 1), (5, 2)]
    cj = jcore.ConcatDataset([jcommon.SyntheticFaceDataset(
        n, 4, keys=("image",), seed=s) for n, s in parts])
    cp = core.ConcatDataset([common.SyntheticFaceDataset(
        n, 4, keys=("image",), seed=s) for n, s in parts])
    assert len(cj) == len(cp) == 8
    for i in range(8):
        np.testing.assert_array_equal(cj[i]["image"], cp[i]["image"])
    arrays = {"a": np.arange(12.0).reshape(4, 3), "b": np.arange(4)}
    aj, ap = jcore.ArrayDataset(arrays), core.ArrayDataset(arrays)
    batch_j = next(iter(jcore.Loader(aj, 4, shuffle=True, seed=2)))
    batch_p = next(iter(core.Loader(ap, 4, shuffle=True, seed=2)))
    for k in arrays:
        np.testing.assert_array_equal(batch_j[k], batch_p[k])


KEYS = ("lr", "gt", "patches", "other", "pos", "image")


@pytest.mark.parametrize("family", [
    dict(),   # the legacy family
    dict(id_spread=0.3, light_jitter=0.2, detail=0.8, clutter=3),
], ids=["legacy", "hard"])
def test_procedural_samples_bit_equal(family):
    kw = dict(n=16, size=32, keys=KEYS, num_ids=8, seed=7, **family)
    dj = jproc.ProceduralFaceDataset(**kw)
    dp = procedural.ProceduralFaceDataset(**kw)
    for i in (0, 3, 9, 15):
        sj, sp = dj[i], dp[i]
        assert sj.keys() == sp.keys() == set(KEYS)
        for k in KEYS:
            assert sj[k].dtype == sp[k].dtype
            np.testing.assert_array_equal(sj[k], sp[k], err_msg=k)


# -- metrics ---------------------------------------------------------------

def _pair(rng, shape, noise):
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    return a, b


def _close(port, jax_out, atol=METRIC_ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(jax_out),
                               rtol=0, atol=atol)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    a, b = _pair(rng, (4, 32, 32, 3), 0.05)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), \
        jnp.asarray(a), jnp.asarray(b)
    for y in (False, True):
        _close(metrics.psnr_pyiqa(ta, tb, test_y_channel=y),
               jmetrics.psnr_pyiqa(ja, jb, test_y_channel=y))
    _close(metrics.ssim_pyiqa(ta, tb), jmetrics.ssim_pyiqa(ja, jb))
    _close(metrics.psnr(ta, tb), jmetrics.psnr(ja, jb))
    _close(metrics.rgb_to_y(ta), jmetrics.rgb_to_y(ja))
    _close(metrics._fspecial_gauss(11, 1.5),
           jmetrics._fspecial_gauss(11, 1.5))
    for per in (True, False):
        _close(metrics.min_max_normalize(ta * 3 - 1, per),
               jmetrics.min_max_normalize(ja * 3 - 1, per))
    # the eval convention end to end, on a prediction outside [0, 1]
    pred = a * 1.4 - 0.2
    m, pn, gn = metrics.reference_eval_metrics(torch.from_numpy(pred), tb)
    jm, jpn, jgn = jmetrics.reference_eval_metrics(jnp.asarray(pred), jb)
    _close(m["psnr"], jm["psnr"])
    _close(m["ssim"], jm["ssim"])
    _close(pn, jpn)
    _close(gn, jgn)
    e = rng.normal(size=(3, 4, 16)).astype(np.float32)
    te, je = torch.from_numpy(e), jnp.asarray(e)
    _close(metrics.identity_cosine(te[0], te[1]),
           jmetrics.identity_cosine(je[0], je[1]))
    _close(metrics.identity_verification_accuracy(*te),
           jmetrics.identity_verification_accuracy(*je))


def test_ssim_downsampling_matches_jax():
    """384^2: the official rule pools 2x2 first."""
    a, b = _pair(np.random.default_rng(1), (1, 384, 384, 3), 0.05)
    _close(metrics.ssim_pyiqa(torch.from_numpy(a), torch.from_numpy(b)),
           jmetrics.ssim_pyiqa(jnp.asarray(a), jnp.asarray(b)))


def test_pyiqa_golden_values():
    """The golden values and float64 oracles of tests/test_pyiqa_golden.py,
    at that file's tolerances."""
    rgb = torch.tensor([[[[1.0, 1.0, 1.0]]], [[[0.0, 0.0, 0.0]]],
                        [[[1.0, 0.0, 0.0]]], [[[0.0, 1.0, 0.0]]],
                        [[[0.0, 0.0, 1.0]]]])
    np.testing.assert_allclose(
        metrics.rgb_to_y(rgb)[..., 0].ravel().numpy(),
        [235.0, 16.0, 81.481, 144.553, 40.966], atol=1e-3)
    rng = np.random.default_rng(42)
    x = rng.uniform(0, 1, (3, 9, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(metrics.rgb_to_y(torch.from_numpy(x)),
                               np_rgb_to_y(x), rtol=1e-5, atol=1e-3)
    a, b = _pair(rng, (4, 16, 16, 3), 0.05)
    for y in (False, True):
        np.testing.assert_allclose(
            metrics.psnr_pyiqa(torch.from_numpy(a), torch.from_numpy(b),
                               test_y_channel=y),
            np_psnr_pyiqa(a, b, test_y_channel=y), rtol=1e-4, atol=1e-3)
    a, b = _pair(rng, (2, 128, 128, 3), 0.03)
    np.testing.assert_allclose(
        metrics.ssim_pyiqa(torch.from_numpy(a), torch.from_numpy(b)),
        np_ssim_pyiqa(a, b), rtol=1e-4, atol=2e-4)
    same = torch.from_numpy(a)
    np.testing.assert_allclose(metrics.ssim_pyiqa(same, same), 1.0,
                               atol=1e-4)
    x = rng.uniform(-1, 2, (3, 4, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        metrics.min_max_normalize(torch.from_numpy(x), per_sample=False),
        (x - x.min()) / (x.max() - x.min()), rtol=1e-6, atol=1e-6)


# -- configs and flags -----------------------------------------------------

def _defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("port, ref, renamed, extra", [
    (serve.Config, jserve.Config, {"platform": "device"}, set()),
    (test_refiner.Config, jtest_refiner.Config, {}, {"device"}),
], ids=["serve", "test_refiner"])
def test_config_fields_match_jax(port, ref, renamed, extra):
    """Every field of the JAX Config has a counterpart with an equal default
    (`mesh_devices` 0, every local card, in both); the deliberate
    difference is only `platform` -> `device`."""
    p, j = _defaults(port), _defaults(ref)
    for name, default in j.items():
        if name in renamed:
            assert renamed[name] in p
        elif name in extra:
            assert name in p and p[name] != default
        else:
            assert name in p and p[name] == default, name
    assert set(p) - set(j) == set(renamed.values()) | (extra - set(j))
    assert p.get("device") == "cuda"


def test_parse_config_matches_jax():
    flags = cli_flags(**TINY_CLI, batch=8, buckets="1,2", max_wait_ms=12.5,
                      num_inference_steps=7, sampler="dpmpp", seed=3,
                      dtype="f32", refiner_ckpt="r.pt")
    p = dataclasses.asdict(common.parse_config(serve.Config, flags))
    j = dataclasses.asdict(jcommon.parse_config(jserve.Config, flags))
    for name in set(j) - {"platform", "mesh_devices"}:
        assert p[name] == j[name], name
    assert common.parse_ints("2,2,4,8") == jcommon.parse_ints("2,2,4,8")
    flags = cli_flags(procedural=8, proc_id_spread=0.5, grid_every=0)
    assert dataclasses.asdict(common.parse_config(
        test_refiner.Config, flags)) == {
        **dataclasses.asdict(jcommon.parse_config(jtest_refiner.Config,
                                                  flags)), "device": "cuda"}


def test_smoke_datasets_match_jax():
    for kw in (dict(synthetic=8, procedural=0), dict(
            synthetic=0, procedural=8, proc_id_spread=0.5,
            proc_light_jitter=0.0, proc_detail=0.5, proc_clutter=2)):
        cfg = common.parse_config(test_refiner.Config,
                                  cli_flags(size=32, **kw))
        pj = jcommon.smoke_datasets(cfg, ("lr", "gt", "patches"))
        pp = common.smoke_datasets(cfg, ("lr", "gt", "patches"))
        for dj, dp in zip(pj, pp):
            assert len(dj) == len(dp)
            for k in ("lr", "gt", "patches"):
                np.testing.assert_array_equal(dj[1][k], dp[1][k])
    assert common.smoke_datasets(test_refiner.Config(), ("lr",)) is None


def test_seeded_generator_streams():
    """One stream per (seed, counter): equal for equal pairs, different for
    the next counter or seed."""
    def draw(seed, n):
        return torch.randn(8, generator=common.seeded_generator(seed, n,
                                                                "cpu"))

    assert torch.equal(draw(0, 3), draw(0, 3))
    assert not torch.equal(draw(0, 3), draw(0, 4))
    assert not torch.equal(draw(0, 3), draw(1, 3))
    assert not torch.equal(draw(1, 2), draw(2, 1))


# -- checkpoints -----------------------------------------------------------

@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    cfg = serve.Config(**TINY_CLI, device="cpu", dtype="f32")
    return write_tiny_checkpoints(tmp_path_factory.mktemp("ckpt"), cfg)


def _cfg(paths, **kw):
    return serve.Config(**TINY_CLI, refiner_ckpt=paths["refiner"],
                        cr_ckpt=paths["cr"], vae_ckpt=paths["vae"],
                        device="cpu", dtype="f32", **kw)


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_load_refiner_stack_bit_exact(ckpts):
    """The files written from the tiny stack's perturbed weights read back
    bit for bit; the CR and VAE also equal the trees of the JAX package's
    own loaders (`ti.cr_params`, `vae_params_from_torch` of
    `ti.load_torch_file`) through convert.py."""
    paths, _, originals = ckpts
    cr, vae, refiner, latent = common.load_refiner_stack(_cfg(paths), "cpu")
    assert latent == 8
    for got, want in zip((cr, vae, refiner), originals):
        _assert_same_state(got, want)
        assert not got.training
    jcr = ti.cr_params(ti.load_torch_file(paths["cr"]), (1, 1), 1, (2, 2))
    jvae = vae_params_from_torch(ti.load_torch_file(paths["vae"]), 3, 1)
    for module, tree, conv in ((cr, jcr, convert.cr_state_dict),
                               (vae, jvae, convert.vae_state_dict)):
        sd = conv(tree)
        own = module.state_dict()
        assert sd.keys() == own.keys()
        for k in sd:
            assert torch.equal(sd[k], own[k]), k


def test_load_other_formats(ckpts, tmp_path):
    """The reference's `model_state_dict` wrapper, the port's own
    `save_state` file, `.safetensors`, and a stage-3 denoiser composed into
    the refiner read as the plain files do; bf16 casts every float."""
    from safetensors.torch import save_file

    from hifidiff_tpu_torch.train import checkpoint, optim, steps

    paths, _, (cr0, vae0, ref0) = ckpts
    torch.save({"model_state_dict": cr0.state_dict(), "epoch": 3},
               tmp_path / "cr_wrapped.pt")
    state = steps.TrainState.create(
        common.build_refiner_models(_cfg(paths))[1], optim.adam,
        device="cpu")
    state.module.load_state_dict(vae0.state_dict())
    checkpoint.save_state(str(tmp_path / "vae_state.pt"), state)
    save_file({k: v.contiguous() for k, v in ref0.state_dict().items()},
              str(tmp_path / "refiner.safetensors"))
    cfg = _cfg(dict(cr=str(tmp_path / "cr_wrapped.pt"),
                    vae=str(tmp_path / "vae_state.pt"),
                    refiner=str(tmp_path / "refiner.safetensors")))
    for got, want in zip(common.load_refiner_stack(cfg, "cpu")[:3],
                         (cr0, vae0, ref0)):
        _assert_same_state(got, want)
    torch.save({k[len("denoiser."):]: v
                for k, v in ref0.state_dict().items()
                if k.startswith("denoiser.")}, tmp_path / "den.pt")
    _, _, refiner, _ = common.load_refiner_stack(
        dataclasses.replace(cfg, refiner_ckpt=str(tmp_path / "den.pt")),
        "cpu", torch.bfloat16)
    for k, v in refiner.denoiser.state_dict().items():
        want = ref0.denoiser.state_dict()[k]
        assert torch.equal(v, want.to(v.dtype)), k
        assert v.dtype == (torch.bfloat16 if want.is_floating_point()
                           else want.dtype)


def test_refused_checkpoints(ckpts, tmp_path):
    """An orbax directory is refused and the accepted formats named; a file
    that does not fit the configured model raises."""
    paths, _, _ = ckpts
    orbax = tmp_path / "refiner_orbax"
    (orbax / "state").mkdir(parents=True)
    (orbax / "state" / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match=r"orbax.*\.pt"):
        common.load_refiner_stack(_cfg(dict(paths, refiner=str(orbax))),
                                  "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        common.load_refiner_stack(_cfg(dict(paths, cr=paths["vae"])), "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        common.load_refiner_stack(dataclasses.replace(
            _cfg(paths), mid_depth=2), "cpu")
    with pytest.raises(FileNotFoundError):
        common.load_refiner_stack(_cfg(dict(paths, vae="missing.pt")), "cpu")
    with pytest.raises(ValueError, match="dtype"):
        common.model_dtype("fp16")


def test_tiny_seam_checkpoints(ckpts, tmp_path):
    """`tae_ckpt` (the tiny autoencoder's state dict, `enc.` / `dec.` names)
    and `tiny_cr_ckpt` load strictly into the seams the config asks for, and
    the split sampler runs with them; a wrong file or mode raises."""
    from hifidiff_tpu_torch.cli.serve import build_runner
    from hifidiff_tpu_torch.models.tiny_cr import TinyCR
    from hifidiff_tpu_torch.random_weights import perturb_
    from hifidiff_tpu_torch.vae.tiny import tiny_autoencoder_pair

    paths, _, _ = ckpts
    enc, dec = tiny_autoencoder_pair(4)
    pair = perturb_(torch.nn.ModuleDict({"enc": enc, "dec": dec}),
                    torch.Generator().manual_seed(4))
    tiny_cr = TinyCR(width=8, blocks=1, down_factor=2)
    torch.save(pair.state_dict(), tmp_path / "tae.pt")
    torch.save(tiny_cr.state_dict(), tmp_path / "tiny_cr.pt")
    seam_kw = dict(tae_ckpt=str(tmp_path / "tae.pt"),
                   tiny_cr_ckpt=str(tmp_path / "tiny_cr.pt"),
                   tiny_cr_width=8, tiny_cr_blocks=1)
    for mode, names in (("both", {"tiny_enc", "tiny_dec", "tiny_cr"}),
                        ("decode", {"tiny_dec", "tiny_cr"})):
        cfg = _cfg(paths, num_inference_steps=1, tae_mode=mode, **seam_kw)
        seams = common.load_tiny_seams(cfg, 8, "cpu")
        assert {k for k, v in seams.items() if v is not None} == names
        _assert_same_state(seams["tiny_dec"], dec)
        _assert_same_state(seams["tiny_cr"], tiny_cr)
        run, _, _ = build_runner(cfg)
        assert set(run.sampler._tiny) == names
        faces = run(np.zeros((1, 32, 32, 3), np.uint8))
        assert faces.shape == (1, 32, 32, 3) and faces.dtype == np.uint8
    with pytest.raises(ValueError, match="does not fit"):
        common.load_tiny_seams(_cfg(paths, tae_ckpt=paths["cr"]), 8, "cpu")
    with pytest.raises(ValueError, match="tae_mode"):
        common.load_tiny_seams(_cfg(paths, tae_mode="encode", **seam_kw), 8,
                               "cpu")


# -- logging and test_refiner ------------------------------------------------

def test_logging_utilities(tmp_path):
    log = tlogging.MetricsLogger(str(tmp_path), "proj", stdout_every=0)
    log.log({"loss": torch.tensor(0.5)}, step=1)
    log.close()
    rec = json.loads((tmp_path / "proj.run.jsonl").read_text())
    assert rec["step"] == 1 and rec["loss"] == 0.5
    imgs = np.random.default_rng(0).uniform(0, 1, (3, 8, 8, 3))
    tlogging.save_image_grid(tlogging.side_by_side(imgs, imgs),
                             str(tmp_path / "g" / "grid.png"))
    assert (tmp_path / "g" / "grid.png").stat().st_size > 0
    timer = tlogging.StepTimer(window=2)
    assert timer.tick() is None
    assert timer.tick() >= 0 and timer.mean >= 0
    with tlogging.profile_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").exists()


def test_save_image_grid_without_pil(monkeypatch, tmp_path):
    """The grid PNG is written without PIL; decoded with PIL afterwards it
    holds the JAX writer's grid bit for bit (RGB and grey)."""
    import sys

    from PIL import Image

    from hifidiff_tpu.utils import logging as jlogging

    rng = np.random.default_rng(0)
    for c in (3, 1):
        imgs = rng.uniform(-0.1, 1.1, (5, 7, 9, c)).astype(np.float32)
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "PIL", None)
            tlogging.save_image_grid(imgs, str(tmp_path / "p" / "x.png"))
        jlogging.save_image_grid(imgs, str(tmp_path / "j.png"))
        port = Image.open(tmp_path / "p" / "x.png")
        ref = Image.open(tmp_path / "j.png")
        assert port.mode == ref.mode == ("RGB" if c == 3 else "L")
        np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))
        # five 7x9 tiles in rows of three, 2 pixels apart and around
        assert np.asarray(port).shape == ((20, 35, 3) if c == 3 else (20, 35))


def test_test_refiner_synthetic(ckpts, tmp_path):
    paths, _, _ = ckpts
    out = test_refiner.main(cli_flags(
        **TINY_CLI, refiner_ckpt=paths["refiner"], cr_ckpt=paths["cr"],
        vae_ckpt=paths["vae"], synthetic=16, batch_size=2,
        num_inference_steps=2, grid_every=1, out_dir=tmp_path,
        device="cpu"))
    assert set(out) == {"psnr", "ssim"}
    assert all(np.isfinite(v) for v in out.values())
    assert sorted(os.listdir(tmp_path)) == ["batch_0.png", "batch_1.png"]


def test_test_refiner_procedural():
    out = test_refiner.main(cli_flags(
        **TINY_CLI, procedural=8, proc_detail=0.5, batch_size=4,
        num_inference_steps=2, grid_every=0, device="cpu"))
    assert all(np.isfinite(v) for v in out.values())


@pytest.mark.parametrize("flags, match", [
    pytest.param(dict(TINY_CLI, dataroot="/data/kface"), "/data/kface/val",
                 id="flags0-§A9"),
    (dict(niqe_model="niqe.npz", synthetic=4), "no file at niqe.npz"),
    (dict(vgg16_ckpt="vgg.pt", lpips_ckpt="lpips.pt", synthetic=4),
     "no file at vgg.pt"),
    (dict(), "--synthetic"),
])
def test_test_refiner_refusals(flags, match):
    """`--dataroot` reads the K-Face val split (here one that is not
    there, named in the error); metric files that do not exist are refused
    (the JAX CLI skips NIQE silently then); without data the CLI asks for
    it."""
    with pytest.raises((NotImplementedError, ValueError, FileNotFoundError),
                       match=match):
        test_refiner.main(cli_flags(device="cpu", **flags))
