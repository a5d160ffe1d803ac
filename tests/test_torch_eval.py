"""The port's perceptual evaluation (`eval/vgg.py`, `eval/lpips.py`,
`eval/niqe.py`), the VGG term of `train_cr` and the three metric flags of
`test_refiner` against the JAX package, on the CPU at small sizes.

Weights are drawn on the port's side under torchvision's and lpips' names
(kaiming-normal convolutions, so that activations keep their scale through
the trunks) and go through the JAX package's own importers. Tolerances:
  * trunk features and LPIPS: 1e-5 of the largest value (float32 sums in
    another order);
  * NIQE's stages (numpy float64 on both sides, the same code): 1e-6; the
    committed golden vector of tests/test_niqe_golden.py at that file's
    5e-4;
  * the CR loss with the VGG term: 1e-5 relative; its gradient against the
    loss without the term: equal bits;
  * `test_refiner` with `--vgg16-ckpt --lpips-ckpt --niqe-model` against the
    JAX CLI on the same weights and the normals JAX draws: PSNR, SSIM and
    LPIPS to 1e-4, NIQE to 1e-3 relative (it rounds luma to integers and
    fits on a 0.001 grid, so float32 noise in a prediction can move it by a
    grid step).
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifidiff_tpu.cli import common as jcommon
from hifidiff_tpu.cli import test_refiner as jtest_refiner
from hifidiff_tpu.eval import lpips as jlpips
from hifidiff_tpu.eval import niqe as jniqe
from hifidiff_tpu.eval import vgg as jvgg
from hifidiff_tpu.train import losses as jlosses
from hifidiff_tpu_torch.cli import common, test_refiner, train_cr
from hifidiff_tpu_torch.data import procedural
from hifidiff_tpu_torch.eval import lpips, niqe, vgg
from hifidiff_tpu_torch.train import losses
from hifidiff_tpu_torch.train.checkpoint import CheckpointManager
from test_niqe_golden import GOLDEN_PATCH0_SCALE1, _test_image
from torch_parity import TINY_CLI, cli_flags, nchw, nhwc, write_tiny_checkpoints

torch.set_num_threads(1)

REL = 1e-5


def rel_err(actual, expected):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    return float(np.abs(actual - expected).max()
                 / max(float(np.abs(expected).max()), 1e-30))


def torchvision_state_dict(features, seed, classifier=True):
    """A state dict under torchvision's names for a `features` Sequential:
    kaiming-normal weights, small biases (and a classifier head that the
    loaders must leave out)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for i, m in enumerate(features):
        if isinstance(m, torch.nn.Conv2d):
            fan_in = m.weight[0].numel()
            sd[f"features.{i}.weight"] = torch.randn(
                m.weight.shape, generator=g) * math.sqrt(2.0 / fan_in)
            sd[f"features.{i}.bias"] = 0.05 * torch.randn(
                m.bias.shape, generator=g)
    if classifier:
        sd["classifier.0.weight"] = torch.randn(8, 4, generator=g)
    return sd


def lpips_heads(channels, seed):
    g = torch.Generator().manual_seed(seed)
    return {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=g)
            for i, c in enumerate(channels)}


def numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def vgg19_sd(seed=0):
    full = vgg.vgg_features(((64, 2), (128, 2), (256, 4), (512, 4),
                             (512, 4)), pool_after_last=True)
    return torchvision_state_dict(full, seed)


def images(rng, b, size):
    return rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)


# -- VGG19 ------------------------------------------------------------------

def test_vgg19_features22_matches_jax():
    """`make_vgg_features_fn` on a whole torchvision vgg19 state dict (the
    later layers and the classifier left out by name) against the JAX
    trunk through `vgg19_params_from_torch`."""
    sd = vgg19_sd()
    x = images(np.random.default_rng(0), 2, 32)
    net = vgg.make_vgg_features_fn(sd, "cpu")
    assert not any(p.requires_grad for p in net.parameters())
    assert sorted(net.state_dict()) == sorted(
        vgg.vgg19_state_dict_from_torch(sd))
    assert len(net.state_dict()) == 20     # ten convolutions
    ref = jvgg.make_vgg_features_fn(jvgg.vgg19_params_from_torch(
        numpy_sd(sd)))(jnp.asarray(x))
    with torch.no_grad():
        out = net(nchw(x))
    assert out.shape == (2, 512, 4, 4)
    assert rel_err(nhwc(out), ref) <= REL
    with pytest.raises(KeyError, match="vgg19"):
        vgg.vgg19_state_dict_from_torch({"features.0.weight": sd[
            "features.0.weight"]})


# -- LPIPS ------------------------------------------------------------------

@pytest.mark.parametrize("net", ["vgg16", "alex"])
def test_lpips_trunks_and_distance_match_jax(net):
    """The five taps of each trunk and `lpips_distance` (input scaling, unit
    normalization, heads) against the JAX package's on the same weights."""
    rng = np.random.default_rng(1)
    size = 32 if net == "vgg16" else 64
    x, y = images(rng, 2, size), images(rng, 2, size)
    if net == "vgg16":
        trunk = lpips.VGG16Features()
        sd = torchvision_state_dict(lpips.vgg_features(
            lpips.VGG16_STAGES, pool_after_last=True), 2)
        heads = lpips_heads((64, 128, 256, 512, 512), 3)
        port = lpips.load_lpips_params(sd, heads)
        jp, jlins = jlpips.load_lpips_params(numpy_sd(sd), numpy_sd(heads))
        jtrunk = jlpips.VGG16Features()
    else:
        trunk = lpips.AlexNetFeatures()
        sd = torchvision_state_dict(trunk.features, 4)
        heads = lpips_heads((64, 192, 384, 256, 256), 5)
        port = lpips.load_lpips_alex_params(sd, heads)
        jp, jlins = jlpips.load_lpips_alex_params(numpy_sd(sd),
                                                  numpy_sd(heads))
        jtrunk = jlpips.AlexNetFeatures()
    model, lins = port
    with torch.no_grad():
        taps = model(nchw(x))
        dist = lpips.lpips_distance(model, lins, nchw(x), nchw(y))
    ref_taps = jtrunk.apply({"params": jp}, jnp.asarray(x))
    assert len(taps) == len(ref_taps) == 5
    for i, (t, r) in enumerate(zip(taps, ref_taps)):
        assert nhwc(t).shape == r.shape, i
        assert rel_err(nhwc(t), r) <= REL, i
    ref = jlpips.lpips_distance(jp, jlins, jnp.asarray(x), jnp.asarray(y),
                                net=net)
    assert dist.shape == (2,) and float(dist.min()) > 0
    assert rel_err(dist, ref) <= REL
    with torch.no_grad():
        same = lpips.lpips_distance(model, lins, nchw(x), nchw(x))
    assert float(same.abs().max()) == 0.0


def test_lpips_available(tmp_path):
    a, b = tmp_path / "a.pt", tmp_path / "b.pt"
    a.write_bytes(b"x")
    assert not lpips.lpips_available(str(a), str(b))
    b.write_bytes(b"x")
    assert lpips.lpips_available(str(a), str(b))
    assert lpips.lpips_available(str(a), str(b)) == \
        jlpips.lpips_available(str(a), str(b))
    assert not lpips.lpips_available(None, str(b))


# -- NIQE -------------------------------------------------------------------

def test_niqe_stages_match_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (40, 56))
    np.testing.assert_allclose(niqe.mscn(img), jniqe.mscn(img), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(niqe.imresize_half(img / 255.0),
                               jniqe.imresize_half(img / 255.0), rtol=1e-6,
                               atol=1e-9)
    face = niqe.rgb_to_luma(_test_image()).round()
    np.testing.assert_array_equal(face, jniqe.rgb_to_luma(_test_image())
                                  .round())
    np.testing.assert_allclose(niqe.niqe_features(face),
                               jniqe.niqe_features(face), rtol=1e-6,
                               atol=1e-9)
    x = rng.standard_normal(4000)
    assert np.allclose(niqe.fit_ggd(x), jniqe.fit_ggd(x), rtol=1e-6)
    assert np.allclose(niqe.fit_aggd(x), jniqe.fit_aggd(x), rtol=1e-6)


def test_niqe_golden_vector():
    """The golden input drawn through the port's own procedural renderer
    (bit-equal to the JAX package's), and the port's NIQE features of it
    against the vector tests/test_niqe_golden.py commits."""
    img = procedural.render_face(procedural._identity_params(7, 3), 0.3, 192)
    img = np.clip(img + np.random.default_rng(123).normal(0, 0.02, img.shape),
                  0.0, 1.0).astype(np.float32)
    np.testing.assert_array_equal(img, _test_image())
    feats = niqe.niqe_features(niqe.rgb_to_luma(img).round())
    assert feats.shape == (4, 36)
    np.testing.assert_allclose(feats[0, :18], GOLDEN_PATCH0_SCALE1,
                               rtol=5e-4, atol=5e-4)


def test_niqe_model_and_score_match_jax():
    faces = [procedural.render_face(procedural._identity_params(1, i), p, 96)
             for i in range(4) for p in (-0.3, 0.3)]
    mu, cov = niqe.fit_niqe_model(faces)
    jmu, jcov = jniqe.fit_niqe_model(faces)
    np.testing.assert_allclose(mu, jmu, rtol=1e-9)
    np.testing.assert_allclose(cov, jcov, rtol=1e-9, atol=1e-12)
    test = _test_image()
    score = niqe.niqe(test, mu, cov)
    assert math.isfinite(score) and score > 0
    assert score == pytest.approx(jniqe.niqe(test, jmu, jcov), rel=1e-9)


# -- the VGG term of train_cr --------------------------------------------------

def _cr_inputs(rng, b=2, size=32):
    pred, gt = images(rng, b, size), images(rng, b, size)
    patches = np.zeros((b, 2, size, size, 3), np.float32)
    patches[:, 0, 4:12, 4:12] = gt[:, 4:12, 4:12]
    return pred, gt, patches


def test_composite_loss_vgg_term_matches_jax_and_has_no_gradient():
    """The CRLoss with the VGG term equals the JAX package's; the term adds
    to the loss and nothing to the gradient (both feature maps taken without
    gradient, as in the reference and the JAX package): the CR's gradients
    with and without it are equal bits, in both packages."""
    rng = np.random.default_rng(3)
    sd = vgg19_sd(6)
    fn = vgg.make_vgg_features_fn(sd, "cpu")
    jfn = jvgg.make_vgg_features_fn(jvgg.vgg19_params_from_torch(
        numpy_sd(sd)))
    _, gt, patches = _cr_inputs(rng)
    tpatch = torch.from_numpy(np.ascontiguousarray(
        patches.transpose(0, 1, 4, 2, 3)))
    cr = common.build_cr(8, 32, "1,1", 1)
    lr_img = nchw(images(rng, 2, 32))

    def port(lam):
        cr.zero_grad()
        loss = losses.composite_cr_loss(cr(lr_img), nchw(gt), tpatch,
                                        lambda_ssim=0.1, lambda_vgg=lam,
                                        vgg_features_fn=fn)
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone()
                             for n, p in cr.named_parameters()}

    with_vgg, without = port(0.1), port(0.0)
    assert with_vgg[0] > without[0] + 1e-4
    for n, g in with_vgg[1].items():
        assert torch.equal(g, without[1][n]), n
    assert any(float(g.abs().max()) > 0 for g in without[1].values())

    pred = nhwc(cr(lr_img))

    def jloss(p, lam):
        return jlosses.composite_cr_loss(p, jnp.asarray(gt),
                                         jnp.asarray(patches),
                                         lambda_ssim=0.1, lambda_vgg=lam,
                                         vgg_features_fn=jfn)

    assert float(jloss(jnp.asarray(pred), 0.1)) == pytest.approx(
        with_vgg[0], rel=REL)
    gj = [np.asarray(jax.grad(jloss)(jnp.asarray(pred), lam))
          for lam in (0.1, 0.0)]
    np.testing.assert_array_equal(gj[0], gj[1])


def _train_cr(root, **kw):
    train_cr.main(cli_flags(
        procedural=8, batch_size=4, size=32, device="cpu", name="t",
        log_dir=root, ckpt_dir=root / "ck", out_dir=root, width=8,
        enc_depths="1,1", mid_depth=1, num_epochs=1, loss="composite",
        dump_every=0, **kw))
    with open(root / "hifi_cr.t.jsonl") as f:
        rows = [json.loads(line) for line in f if line.strip()]
    mgr = CheckpointManager(str(root / "ck" / "t"), create=False)
    state = torch.load(mgr.path(mgr.latest_step()), weights_only=True)
    return ([r["train_loss"] for r in rows if "train_loss" in r],
            state["state"]["module"])


@pytest.mark.parametrize("fmt", ["pt", "safetensors"])
def test_train_cr_cli_vgg_term(tmp_path, fmt):
    """`train_cr --loss composite --lambda-vgg 0.1 --vgg19-ckpt FILE` (a
    torchvision-named torch file or `.safetensors`): every logged loss above
    the run without the term, and the trained CR equal bit for bit to that
    run's, since the term adds no gradient."""
    sd = vgg19_sd(7)
    path = tmp_path / f"vgg19.{fmt}"
    if fmt == "pt":
        torch.save(sd, path)
    else:
        safetensors = pytest.importorskip("safetensors.torch")
        safetensors.save_file({k: v.contiguous() for k, v in sd.items()},
                              str(path))
    vgg_losses, vgg_state = _train_cr(tmp_path / "vgg", lambda_vgg=0.1,
                                      vgg19_ckpt=path)
    plain_losses, plain_state = _train_cr(tmp_path / "plain",
                                          lambda_vgg=0.0)
    assert len(vgg_losses) == len(plain_losses) == 2
    assert all(a > b for a, b in zip(vgg_losses, plain_losses))
    for k, v in plain_state.items():
        assert torch.equal(vgg_state[k], v), k


# -- test_refiner's metric flags -------------------------------------------------

SIZE = 96     # NIQE needs one 96x96 patch


def _jax_normals(key, batch, latent):
    k_lat, k_enc = jax.random.split(key)
    shape = (batch, latent, latent, 4)
    return (torch.from_numpy(np.array(jax.random.normal(k_lat, shape))),
            torch.from_numpy(np.array(jax.random.normal(k_enc, shape,
                                                        np.float32))))


def _metric_files(tmp_path):
    """A torchvision-named VGG16, lpips heads and a NIQE model fitted on
    procedural faces at SIZE, written to `tmp_path`."""
    vgg16 = tmp_path / "vgg16.pt"
    torch.save(torchvision_state_dict(lpips.vgg_features(
        lpips.VGG16_STAGES, pool_after_last=True), 8), vgg16)
    heads = tmp_path / "lpips_vgg.pt"
    torch.save(lpips_heads((64, 128, 256, 512, 512), 9), heads)
    model = tmp_path / "niqe.npz"
    faces = [procedural.render_face(procedural._identity_params(2, i), p,
                                    SIZE) for i in range(4)
             for p in (-0.4, 0.0, 0.4)]
    mu, cov = niqe.fit_niqe_model(faces)
    np.savez(model, mu=mu, cov=cov)
    return vgg16, heads, model


@pytest.fixture(scope="module")
def metric_run(tmp_path_factory):
    """The tiny stack at 96 px with its weight files and the metric files;
    the JAX CLI's run on them with the LPIPS flags (the JAX CLI reads the
    tiny stack's trees through a patched `load_refiner_stack`: it reads
    torch files only at the default depths, ROADMAP §C), and the
    normalized predictions it scored."""
    tmp = tmp_path_factory.mktemp("metrics")
    sizes = dict(TINY_CLI, size=SIZE)
    paths, trees, _ = write_tiny_checkpoints(
        tmp, test_refiner.Config(**sizes, device="cpu"))
    vgg16, heads, model = _metric_files(tmp)
    flags = cli_flags(**sizes, procedural=32, batch_size=8,
                      num_inference_steps=2, grid_every=0,
                      vgg16_ckpt=vgg16, lpips_ckpt=heads)

    def stack(jcfg, key):
        cr, vae, refiner, schedule, latent = \
            jcommon.build_refiner_models(jcfg)
        return cr, vae, refiner, schedule, {
            "refiner": trees["refiner"], "cr": trees["cr"],
            "vae": trees["vae"]}, latent

    scored = []
    real = jtest_refiner.reference_eval_metrics

    def spy(pred, gt):
        out = real(pred, gt)
        scored.extend(np.asarray(out[1]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcommon, "load_refiner_stack", stack)
        mp.setattr(jtest_refiner, "reference_eval_metrics", spy)
        want = jtest_refiner.main(flags)
    return dict(flags=flags, paths=paths, model=model, want=want,
                scored=scored)


def _jax_normals(key, batch, latent):
    k_lat, k_enc = jax.random.split(key)
    shape = (batch, latent, latent, 4)
    return (torch.from_numpy(np.array(jax.random.normal(k_lat, shape))),
            torch.from_numpy(np.array(jax.random.normal(k_enc, shape,
                                                        np.float32))))


def test_test_refiner_metrics_match_jax_cli(metric_run, monkeypatch):
    """`test_refiner --vgg16-ckpt --lpips-ckpt --niqe-model` on the tiny
    stack at 96 px, fed the normals the JAX CLI draws from
    `fold_in(PRNGKey(seed), i)`: PSNR, SSIM and LPIPS against the JAX CLI's
    on the same weights; NIQE against the JAX package's `niqe` over the
    predictions the JAX CLI scored, the number its `--niqe-model` would
    print (it raises instead: `test_jax_test_refiner_niqe_flag_raises`)."""
    real = test_refiner.build_refiner_sampler_split

    def with_jax_noise(*a, **k):
        sampler, calls = real(*a, **k), [0]

        def run(lr, generator=None):
            lat, post = _jax_normals(jax.random.fold_in(
                jax.random.PRNGKey(0), calls[0]), lr.shape[0], SIZE // 4)
            calls[0] += 1
            return sampler(lr, latents_noise=lat, posterior_noise=post)
        return run

    monkeypatch.setattr(test_refiner, "build_refiner_sampler_split",
                        with_jax_noise)
    paths, want = metric_run["paths"], metric_run["want"]
    got = test_refiner.main(metric_run["flags"] + cli_flags(
        refiner_ckpt=paths["refiner"], cr_ckpt=paths["cr"],
        vae_ckpt=paths["vae"], niqe_model=metric_run["model"],
        device="cpu"))
    assert set(want) == {"psnr", "ssim", "lpips"}
    assert set(got) == {"psnr", "ssim", "lpips", "niqe"}
    assert all(math.isfinite(v) for v in got.values())
    for k in ("psnr", "ssim", "lpips"):
        assert got[k] == pytest.approx(want[k], abs=1e-4), k
    m = np.load(metric_run["model"])
    assert len(metric_run["scored"]) == 8
    jax_niqe = float(np.mean([jniqe.niqe(p, m["mu"], m["cov"])
                              for p in metric_run["scored"]]))
    assert got["niqe"] == pytest.approx(jax_niqe, rel=1e-3)


def test_jax_test_refiner_niqe_flag_raises(tmp_path, monkeypatch):
    """A fault of the JAX CLI (ROADMAP §C): its NIQE closure reads the name
    `m`, which the loop rebinds to the metrics dict before the first call
    (`hifidiff_tpu/cli/test_refiner.py:131-134, 162`), so `--niqe-model`
    raises KeyError whatever the model file holds. The port binds the
    model's arrays (`test_test_refiner_metrics_match_jax_cli`). The JAX
    CLI's stack and sampler are stubbed (the sampler returns its input):
    the fault lies in the loop around them."""
    model = tmp_path / "niqe.npz"
    np.savez(model, mu=np.zeros(36), cov=np.eye(36))
    monkeypatch.setattr(jcommon, "load_refiner_stack",
                        lambda cfg, key: (None, None, None, None, {}, 8))
    monkeypatch.setattr(jtest_refiner, "build_refiner_sampler_split",
                        lambda *a, **k: lambda v, lr, key: lr)
    flags = cli_flags(**TINY_CLI, synthetic=4, batch_size=4, grid_every=0)
    assert set(jtest_refiner.main(flags)) == {"psnr", "ssim"}
    with pytest.raises(KeyError, match="mu"):
        jtest_refiner.main(flags + cli_flags(niqe_model=model))


def test_test_refiner_metric_flags_need_their_files(tmp_path):
    base = cli_flags(**TINY_CLI, synthetic=4, device="cpu")
    with pytest.raises(ValueError, match="both"):
        test_refiner.main(base + cli_flags(vgg16_ckpt=tmp_path / "v.pt"))
    with pytest.raises(FileNotFoundError, match="no file"):
        test_refiner.main(base + cli_flags(niqe_model=tmp_path / "n.npz"))
    assert dataclasses.asdict(test_refiner.Config())["niqe_model"] == ""
