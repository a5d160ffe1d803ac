"""The training CLIs that read the PNG datasets (`pretrain_idc --dataroot`,
`pretrain_denoiser --multipie-root --celeba-root`) against the JAX CLIs,
one step each on a tiny tree, on the CPU.

Both CLIs start from the JAX CLI's first parameters (through convert.py)
and the denoiser's steps take the draws the JAX step makes from
`fold_in(PRNGKey(seed), step)`, as in tests/test_torch_train_cli.py. cv2's
IPP is off (cv2's own resize, which `data/resize.resize_cv2` reproduces bit
for bit). Tolerances, those of tests/test_torch_train_cli.py: the batch each
CLI hands its first step bit-equal; the logged values to 1e-4 relative
(1e-6 absolute); the denoiser's rate against optax's to 1e-4 and its
checkpoint after the step to 1e-4 absolute outside the tensors whose
gradient is rounding noise on both sides (`_noise_tensors`). The IDC's
float32 gradient in the JAX package is ill-conditioned (ROADMAP §C2), and
so is its float32 loss through the CR's anchor: the IDC step's loss is held
to a float64 witness of the port's modules on the same batch and weights
(the port to 1e-4 relative; the JAX CLI to 1e-3: in one run of this test
with an unseeded CR it read 4.2e-4, the port 3.0e-5), and the val loss
after the step to the JAX CLI's at 1e-4.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hifidiff_tpu.cli import pretrain_denoiser as jpretrain_denoiser  # noqa: E402
from hifidiff_tpu.cli import pretrain_idc as jpretrain_idc  # noqa: E402
from hifidiff_tpu_torch import convert  # noqa: E402
from hifidiff_tpu_torch.cli import pretrain_denoiser, pretrain_idc  # noqa: E402
from hifidiff_tpu_torch.train import checkpoint  # noqa: E402
from test_torch_train_cli import (_jax_stage, _nchw_normal,  # noqa: E402
                                  _noise_tensors, _optax_lrs, _port_stage,
                                  _rows)
from torch_parity import cli_flags  # noqa: E402

torch.set_num_threads(1)

ANGLES = ["11_0", "12_0", "09_0", "19_1", "08_1", "20_0", "01_0", "24_0",
          "08_0", "13_0", "14_0", "05_0", "04_1", "19_0", "05_1"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Multi-PIE train and test splits of two pids each, light 00, 40 x 40
    PNGs written by PIL; two 48 x 48 CelebA-HQ PNGs."""
    root = tmp_path_factory.mktemp("mp")
    rng = np.random.default_rng(0)
    for split, pids in (("train", ("a", "b")), ("test", ("c", "d"))):
        for pid in pids:
            for angle in ANGLES:
                path = root / split / pid / angle / "00.png"
                path.parent.mkdir(parents=True)
                Image.fromarray(rng.integers(0, 256, (40, 40, 3),
                                             np.uint8)).save(path)
    (root / "celeba").mkdir()
    for j in range(2):
        Image.fromarray(rng.integers(0, 256, (48, 48, 3), np.uint8)).save(
            root / "celeba" / f"{j}.png")
    return root


@pytest.fixture(autouse=True)
def cv2_own(monkeypatch):
    """cv2's own resize for the JAX package's calls: IPP off in the thread
    of each call (the switch is per thread, and the loaders resize in
    theirs)."""
    real, was = cv2.resize, cv2.ipp.useIPP()

    def resize(*a, **k):
        cv2.ipp.setUseIPP(False)
        return real(*a, **k)

    monkeypatch.setattr(cv2, "resize", resize)
    yield
    cv2.ipp.setUseIPP(was)   # this thread's switch, as it was


def _first_batches(mp, module, seen, key):
    """Patch `module.Loader` to keep the first batch its shuffled loader
    yields under `seen[key]`."""
    real = module.Loader

    class Recording(real):
        def __iter__(self):
            for batch in super().__iter__():
                if self.shuffle and key not in seen:
                    seen[key] = {k: np.array(v) for k, v in batch.items()}
                yield batch

    mp.setattr(module, "Loader", Recording)


def _same_rows(log_root, project):
    rows = {pkg: _rows(log_root / pkg, project) for pkg in ("jax", "port")}
    assert len(rows["jax"]) == len(rows["port"]) > 0
    for jrow, trow in zip(rows["jax"], rows["port"]):
        assert set(jrow) == set(trow)
        for k in set(jrow) - {"time", "step_time"}:
            np.testing.assert_allclose(trow[k], jrow[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_pretrain_idc_dataroot_against_jax(tree, tmp_path, monkeypatch):
    from hifidiff_tpu.utils import torch_import as ti
    from hifidiff_tpu_torch.cli.common import build_cr, seeded
    from hifidiff_tpu_torch.random_weights import perturb_
    from hifidiff_tpu_torch.train.losses import triplet_margin_loss

    monkeypatch.chdir(tmp_path)
    with seeded(0):
        cr = build_cr(8, 32, "1,1", 1)
    perturb_(cr, torch.Generator().manual_seed(0))
    torch.save(cr.state_dict(), tmp_path / "cr.pt")
    sd = {k: v.numpy() for k, v in cr.state_dict().items()}
    flags = dict(dataroot=tree, size=32, cr_width=8, cr_enc_depths="1,1",
                 cr_mid_depth=1, idc_stages="1,1,1,1", batch_size=28,
                 num_epochs=1, seed=0, name="t", cr_ckpt=tmp_path / "cr.pt")
    seen, inits = {}, []
    real_state = jpretrain_idc.TrainState

    class Shim:
        @staticmethod
        def create(params, tx, batch_stats=None, **kw):
            inits.append(jax.device_get((params, batch_stats)))
            return real_state.create(params, tx, batch_stats=batch_stats,
                                     **kw)

    with pytest.MonkeyPatch.context() as mp:
        # the JAX CLI's own `.pt` reader takes the default depths only
        mp.setattr(jpretrain_idc, "load_cr_params",
                   lambda cfg, model, key: ti.cr_params(sd, (1, 1), 1, (2, 2)))
        mp.setattr(jpretrain_idc, "TrainState", Shim)
        _first_batches(mp, jpretrain_idc, seen, "jax")
        jpretrain_idc.main(cli_flags(**flags, log_dir=tmp_path / "jax",
                                     ckpt_dir=tmp_path / "ck_jax"))

    class Net(pretrain_idc.IDCEncoder):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.load_state_dict(convert.resnet50_state_dict(*inits[0]),
                                 strict=True)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pretrain_idc, "IDCEncoder", Net)
        _first_batches(mp, pretrain_idc, seen, "port")
        pretrain_idc.main(cli_flags(**flags, log_dir=tmp_path / "port",
                                    ckpt_dir=tmp_path / "ck_port",
                                    device="cpu"))
    assert set(seen["port"]) == set(seen["jax"]) == {"lr", "gt", "other"}
    for k, v in seen["jax"].items():
        np.testing.assert_array_equal(seen["port"][k], v, err_msg=k)
    # the step's loss against a float64 witness on the same batch and
    # weights (the port's modules in double, training mode)
    idc = Net(stage_sizes=(1, 1, 1, 1)).double().train()
    cr64 = cr.double().eval()
    b = {k: torch.from_numpy(v).permute(0, 3, 1, 2).double()
         for k, v in seen["port"].items()}
    with torch.no_grad():
        witness = float(triplet_margin_loss(idc(cr64(b["lr"])), idc(b["gt"]),
                                            idc(b["other"])))
    rows = {pkg: _rows(tmp_path / pkg, "hifi_idc") for pkg in ("jax", "port")}
    (jtrain, jval), (train, val) = (
        [r[k] for r in rows[pkg] for k in ("train_loss", "val_loss") if k in r]
        for pkg in ("jax", "port"))
    assert abs(train - witness) <= 1e-4 * witness
    assert abs(jtrain - witness) <= 1e-3 * witness
    np.testing.assert_allclose(val, jval, rtol=1e-4)


def test_pretrain_denoiser_png_roots_against_jax(tree, tmp_path):
    """`--multipie-root` (14 images) and `--celeba-root` (2) at batch 16:
    one step."""
    from hifidiff_tpu.models import Denoiser as JDenoiser
    from hifidiff_tpu.train.checkpoint import restore_state
    from hifidiff_tpu.vae import AutoencoderKL as JVAE

    key = jax.random.PRNGKey(0)
    vae_init = jax.device_get(jax.jit(JVAE(
        block_out=(32, 32), layers_per_block=1).init)(
        key, jnp.zeros((1, 32, 32, 3)))["params"])
    jden = JDenoiser(width=32, enc_nums=(1, 1), mid_num=1, dec_nums=(1, 1))
    den_init = jax.device_get(jax.jit(lambda k: jden.init(
        k, jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,))))(key)["params"])
    flags = dict(multipie_root=tree, celeba_root=tree / "celeba", size=32,
                 batch_size=16, num_epochs=1, seed=0, name="t", lr=5e-4,
                 warmup_steps=2, sample_size=1, vae_blocks="32,32",
                 vae_layers=1, width=32, enc_depths="1,1", mid_depth=1,
                 dec_depths="1,1")

    def argv(pkg, **more):
        return cli_flags(**flags, log_dir=tmp_path / pkg,
                         ckpt_dir=tmp_path / f"ck_{pkg}",
                         out_dir=tmp_path / f"img_{pkg}", **more)

    def draws(step):
        k_enc, k_noise, k_t = jax.random.split(
            jax.random.fold_in(key, step), 3)
        return (_nchw_normal(k_enc, (16, 16, 16, 4)),
                _nchw_normal(k_noise, (16, 16, 16, 4)),
                torch.from_numpy(np.array(jax.random.randint(
                    k_t, (16,), 0, 1000))))

    class Denoiser(pretrain_denoiser.Denoiser):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.load_state_dict(convert.denoiser_state_dict(den_init),
                                 strict=True)

    def vae_init_(vae):
        vae.load_state_dict(convert.vae_state_dict(vae_init), strict=True)
        return vae

    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        _first_batches(mp, jpretrain_denoiser, seen, "jax")
        jgrads, (args, _) = _jax_stage(mp, jpretrain_denoiser,
                                       "make_denoiser_train_step",
                                       argv("jax"))
    with pytest.MonkeyPatch.context() as mp:
        from hifidiff_tpu_torch.vae import model as vae_model

        mp.setattr(vae_model, "flax_default_init_", vae_init_)
        _first_batches(mp, pretrain_denoiser, seen, "port")
        stepped = _port_stage(mp, pretrain_denoiser,
                              "make_denoiser_train_step", draws,
                              ("Denoiser", Denoiser),
                              argv("port", device="cpu"))
    np.testing.assert_array_equal(seen["port"]["image"],
                                  seen["jax"]["image"])
    assert seen["jax"]["image"].shape == (16, 32, 32, 3)
    assert len(stepped) == len(jgrads) == 1
    np.testing.assert_allclose([lr for lr, _ in stepped],
                               _optax_lrs(*args, n=1), rtol=1e-4, atol=1e-10)
    _same_rows(tmp_path, "hifi_denoiser")
    noise = _noise_tensors([g for _, g in stepped], jgrads,
                           convert.denoiser_state_dict)
    assert len(noise) <= len(stepped[0][1]) / 4, sorted(noise)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ck_port" / "t"),
                                       create=False)
    want = convert.denoiser_state_dict(restore_state(
        str(tmp_path / "ck_jax" / "t"), 1)["state"]["params"])
    got = torch.load(mgr.path(1), weights_only=True)["state"]["module"]
    assert set(got) == set(want)
    for n, v in got.items():
        if n not in noise:
            np.testing.assert_allclose(v.numpy(), want[n].numpy(), rtol=0,
                                       atol=1e-4, err_msg=n)
