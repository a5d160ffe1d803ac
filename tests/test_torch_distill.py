"""The port's distillation (`train/distill.py`) and its four CLIs
(`cli/train_tae`, `train_tiny_cr`, `train_tiny_dn`, `distill`) against the
JAX package's, on the CPU at tiny widths.

The steps are held to the JAX steps over three optimizer steps as
tests/test_torch_train.py holds the stage steps (its helpers and
tolerances): the JAX step under jit with a TrainState that hands the
gradients out, the port's step fed the draws the JAX step makes from its key.
Weights: the refiner stack from the port's side through the JAX importers;
the tiny modules from flax inits through `convert.py` (they have no
reference layout). Tables: the float64 tables rounded to float32 equal the
JAX package's bit for bit; `ddim_step` and `distill_eps_target` to 1e-6.
The CLIs: their configs field for field against the JAX dataclasses, a
chain from the stage CLIs into each trainer with the JAX CLIs' logged
keys, the trained seams and students through `test_refiner`, and runs
killed after their first checkpoint and resumed, bit for bit against
uninterrupted ones.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifidiff_tpu.cli import distill as jdistill_cli
from hifidiff_tpu.cli import train_tae as jtrain_tae
from hifidiff_tpu.cli import train_tiny_cr as jtrain_tiny_cr
from hifidiff_tpu.cli import train_tiny_dn as jtrain_tiny_dn
from hifidiff_tpu.models import CoarseRestoration as JCR
from hifidiff_tpu.models import FacialRefiner as JRefiner
from hifidiff_tpu.models.tiny_cr import TinyCR as JTinyCR
from hifidiff_tpu.train import distill as jdistill
from hifidiff_tpu.train import optim as joptim
from hifidiff_tpu.train import steps as jsteps
from hifidiff_tpu.utils import torch_import as ti
from hifidiff_tpu.vae import AutoencoderKL as JVAE
from hifidiff_tpu.vae import tiny as jtiny
from hifidiff_tpu.vae.import_torch import vae_params_from_torch
from hifidiff_tpu_torch import convert
from hifidiff_tpu_torch.cli import (common, distill, pretrain_denoiser,
                                    test_refiner, train_cr, train_refiner,
                                    train_tae, train_tiny_cr, train_tiny_dn,
                                    train_vae)
from hifidiff_tpu_torch.diffusion.sampling import ddim_timesteps
from hifidiff_tpu_torch.models.cr import CoarseRestoration
from hifidiff_tpu_torch.models.refiner import FacialRefiner
from hifidiff_tpu_torch.models.tiny_cr import TinyCR
from hifidiff_tpu_torch.train import checkpoint, optim
from hifidiff_tpu_torch.train import distill as tdistill
from hifidiff_tpu_torch.vae import tiny
from hifidiff_tpu_torch.vae.model import AutoencoderKL
from test_torch_train import (B, CR, GRAD_FLOOR, J_SCHEDULE, LATENT,
                              LOOSE_SHARE, PARAM_LR_FRACTION, REF, RES,
                              STATS_REL, STEP_GRAD_REL, VAE, SpyState,
                              _check_step, _draw_nchw, _draw_t, _jit_step,
                              _only_noise, _refiner_import, _spy, rel_err)
from test_torch_train_cli import (_assert_same_run, _final_state,
                                  _jax_logged_keys, _rows)
from torch_parity import TINY_CLI, cli_flags, jax_weights, nchw

torch.set_num_threads(1)

N_STUDENT = 5
STUDENT = dict(REF, width=8)
LAT = (B, 4, LATENT, LATENT)


@pytest.fixture(autouse=True)
def seeded_init():
    """The modules' initial weights (which `jax_weights` perturbs from a
    seed of its own) drawn from one seed in every test, as
    tests/test_torch_train.py draws them: without it they came from
    whatever the tests before left in torch's global generator, and the
    steps' comparisons ran on other weights in every order of the run.
    At some other seeds the two refiner steps' comparisons fail at the
    HCA's one-channel BatchNorm: there the JAX float32 gradient of its
    weight is the one far from a float64 step, and its running mean follows
    the +-lr steps Adam takes on the rounding noise of the bias in front of
    it (`tools/distill_init_probe.py`)."""
    torch.manual_seed(0)


# -- tables and DDIM algebra ---------------------------------------------------

@pytest.mark.parametrize("n, k", [(25, 2), (10, 5), (5, 2), (50, 1)])
def test_student_step_tables_equal_jax(n, k):
    port = tdistill.student_step_tables(n, k)
    ref = jdistill.student_step_tables(J_SCHEDULE, n, k)
    assert set(port) == set(ref)
    for name, table in port.items():
        assert table.dtype == np.float64, name
        np.testing.assert_array_equal(table.astype(np.float32),
                                      np.asarray(ref[name]), err_msg=name)
    assert port["alpha_sub"][-1, -1] == 1.0


def test_student_step_tables_refuse_what_jax_refuses():
    for n, k in ((8, 2), (25, 3)):
        with pytest.raises(ValueError, match="divisible"):
            tdistill.student_step_tables(n, k)
        with pytest.raises(ValueError, match="divisible"):
            jdistill.student_step_tables(J_SCHEDULE, n, k)


@pytest.mark.parametrize("clip", [False, True])
def test_ddim_step_and_eps_target_equal_jax(clip):
    rng = np.random.default_rng(0)
    x, eps = (rng.standard_normal((4, 5, 5, 3)).astype(np.float32) * 2
              for _ in range(2))
    tab = tdistill.student_step_tables(10, 5)["alpha_sub"].astype(np.float32)
    a_t, a_p = tab[[0, 3, 6, 9], 0], tab[[0, 3, 6, 9], -1]
    got = tdistill.ddim_step(nchw(x), nchw(eps), torch.from_numpy(a_t),
                             torch.from_numpy(a_p), clip, 1.5)
    want = jdistill.ddim_step(jnp.asarray(x), jnp.asarray(eps),
                              jnp.asarray(a_t), jnp.asarray(a_p), clip, 1.5)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    two = tdistill.ddim_step(nchw(x), nchw(eps), torch.from_numpy(a_t),
                             torch.from_numpy(a_p))
    target = tdistill.distill_eps_target(nchw(x), two, torch.from_numpy(a_t),
                                         torch.from_numpy(a_p))
    ref = jdistill.distill_eps_target(
        jnp.asarray(x), jnp.asarray(two.permute(0, 2, 3, 1).numpy()),
        jnp.asarray(a_t), jnp.asarray(a_p))
    np.testing.assert_allclose(target.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-5, atol=1e-5)
    # the solve inverts the step
    np.testing.assert_allclose(target.numpy(), nchw(eps).numpy(), atol=2e-3)


# -- the four steps against the JAX steps ----------------------------------------

def _stack(seed):
    cr, vae, refiner = (CoarseRestoration(**CR), AutoencoderKL(**VAE),
                        FacialRefiner(**REF))
    cr_p = jax_weights(cr, lambda sd: ti.cr_params(sd, (1, 1), 1, (1, 1)),
                       convert.cr_state_dict, seed=6 + seed)
    vae_p = jax_weights(vae, lambda sd: vae_params_from_torch(sd, 3, 1),
                        convert.vae_state_dict, seed=7 + seed)
    rv = jax_weights(refiner, _refiner_import, convert.refiner_state_dict,
                     seed=8 + seed)
    return (cr, vae, refiner), {"cr": cr_p, "vae": vae_p}, rv


def _refiner_sd(p, s):
    return convert.refiner_state_dict({"params": p, "batch_stats": s})


def _check_refiner_step(i, tstate, jstate, tm, jm, tgrads, lr, applied,
                        left_out):
    """`_check_step` for a refiner whose every parameter trains. The biases
    in front of the HCA's BatchNorms have a true gradient of zero; both
    frameworks compute rounding noise there (1e-8 of the largest gradient),
    which passes the gradient comparison against its floor, and Adam turns
    noise of either sign into +-lr. So every tensor whose gradients on both
    sides stay under GRAD_FLOOR of the largest (`_only_noise`) joins
    `left_out` for this step and the later ones, and its value is not
    compared (an eighth of the tensors at most); every other rule and
    tolerance is `_check_step`'s."""
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), float(v), rtol=1e-5,
                                   err_msg=f"step {i} {k}")
    stats = jstate.batch_stats
    jgrads = _refiner_sd(SpyState.grads, stats)
    top = max(float(g.abs().max()) for g in tgrads.values())
    assert tgrads and top > 0
    for name, g in tgrads.items():
        if _only_noise(g, jgrads[name], top):
            left_out.add(name)
            continue
        err = rel_err(g.numpy(), jgrads[name].numpy(), GRAD_FLOOR * top)
        assert err <= STEP_GRAD_REL, f"step {i} grad {name}: {err:.2e}"
    assert len(left_out) <= len(tgrads) / 8, sorted(left_out)
    want = _refiner_sd(jstate.params, stats)
    one = lr * max(applied, 1)
    loose = total = 0
    for name, p in tstate.module.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith(("running_mean", "running_var")):
            err = rel_err(p.numpy(), want[name].numpy())
            assert err <= STATS_REL, f"step {i} {name}: {err:.2e}"
        elif name not in left_out:
            diff = np.abs(p.numpy() - want[name].numpy())
            assert float(diff.max()) <= one, f"step {i} param {name}"
            loose += int((diff > PARAM_LR_FRACTION * one).sum())
            total += diff.size
    assert loose <= LOOSE_SHARE * total, (i, loose, total)


def _lr_gt(rng):
    return [rng.uniform(0, 1, (B, RES, RES, 3)).astype(np.float32)
            for _ in range(2)]


def test_distill_step_vs_jax():
    """The student (a copy of the teacher, every parameter trained) over
    three AdamW steps: the teacher's two sub-steps with clipping as the CLI
    runs them, the eps target, the truncated-SNR x0 loss, the student steps
    JAX draws (the stratified draw: `test_stratified_sampler_fault_in_both_
    packages`)."""
    (cr, vae, teacher), frozen, rv = _stack(0)
    student = copy.deepcopy(teacher)
    jstate = SpyState.create(rv["params"], joptim.adamw_cosine(1e-4, 1, 100),
                             batch_stats=rv["batch_stats"])
    tstate = steps_state(student)
    tgrads = _spy(tstate)
    jstep = jax.jit(lambda s, t, f, b, k: _jit_step(
        jdistill.make_distill_train_step(
            JRefiner(**REF), JCR(**CR), JVAE(**VAE), J_SCHEDULE, N_STUDENT,
            substeps=2, clip_sample=True, clip_sample_range=3.0), s, t, f,
        b, k))
    tstep = tdistill.make_distill_train_step(
        cr, vae, N_STUDENT, substeps=2, clip_sample=True,
        clip_sample_range=3.0, device="cpu")
    rng = np.random.default_rng(20)
    left_out = set()
    for i in range(3):
        lr_img, gt = _lr_gt(rng)
        key = jax.random.PRNGKey(60 + i)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        idx = jax.random.randint(k3, (B,), 0, N_STUDENT)
        jstate, jm, SpyState.grads = jstep(jstate, rv, frozen,
                                             {"lr": lr_img, "gt": gt}, key)
        _, tm = tstep(tstate, teacher, {"lr": nchw(lr_img), "gt": nchw(gt)},
                      _draw_nchw(k1, LAT), _draw_nchw(k2, LAT),
                      torch.from_numpy(np.array(idx)), _draw_nchw(k4, LAT))
        _check_refiner_step(i, tstate, jstate, tm, jm, tgrads, 1e-4, i,
                            left_out)
    assert not teacher.training and "idc.conv1.weight" in tgrads


def steps_state(module, **kw):
    from hifidiff_tpu_torch.train.steps import TrainState

    return TrainState.create(
        module, functools.partial(optim.adamw_cosine, warmup_steps=1,
                                  total_steps=100, **kw), device="cpu")


def test_tiny_dn_step_vs_jax():
    """A width-8 student of the width-16 teacher over three AdamW steps: the
    teacher's two-step rollout from the drawn latents, the forward-diffused
    term at the drawn timesteps, both student calls in training mode. Then
    `update=False` (the CLI's validation) gives the step's metrics and
    leaves the student and its statistics as they were."""
    (cr, vae, teacher), frozen, rv = _stack(1)
    student = FacialRefiner(**STUDENT)
    sv = jax_weights(student, _refiner_import, convert.refiner_state_dict,
                     seed=12)
    jstate = SpyState.create(sv["params"], joptim.adamw_cosine(1e-4, 1, 100),
                             batch_stats=sv["batch_stats"])
    tstate = steps_state(student)
    tgrads = _spy(tstate)
    jstep = jax.jit(lambda s, t, f, b, k: _jit_step(
        jdistill.make_tiny_dn_train_step(
            JRefiner(**REF), JRefiner(**STUDENT), JCR(**CR), JVAE(**VAE),
            J_SCHEDULE, rollout_steps=2, fwd_weight=0.5), s, t, f, b, k))
    tstep = tdistill.make_tiny_dn_train_step(cr, vae, rollout_steps=2,
                                             fwd_weight=0.5, device="cpu")
    rng = np.random.default_rng(21)

    def draws(key):
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        return (_draw_nchw(k1, LAT), _draw_nchw(k2, LAT),
                _draw_nchw(k3, LAT), _draw_t(k4, B), _draw_nchw(k5, LAT))

    for i in range(3):
        lr_img, gt = _lr_gt(rng)
        key = jax.random.PRNGKey(70 + i)
        jstate, jm, SpyState.grads = jstep(jstate, rv, frozen,
                                             {"lr": lr_img, "gt": gt}, key)
        _, tm = tstep(tstate, teacher, {"lr": nchw(lr_img), "gt": nchw(gt)},
                      *draws(key))
        assert set(tm) == {"loss", "onpolicy_loss", "fwd_loss"}
        _check_step(i, tstate, jstate, tm, jm, tgrads, _refiner_sd, 1e-4, i)
    before = {k: v.clone() for k, v in student.state_dict().items()}
    lr_img, gt = _lr_gt(rng)
    key = jax.random.PRNGKey(80)
    _, jm, _ = jstep(jstate, rv, frozen, {"lr": lr_img, "gt": gt}, key)
    _, tm = tstep(tstate, teacher, {"lr": nchw(lr_img), "gt": nchw(gt)},
                  *draws(key), update=False)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    for k, v in student.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert tstate.step == 3


def _flax_into(jmodule, module, converter, x, seed):
    params = jax.device_get(jax.jit(jmodule.init)(jax.random.PRNGKey(seed),
                                                  x)["params"])
    module.load_state_dict(converter(params), strict=True)
    return params


def test_tiny_cr_step_vs_jax():
    """TinyCR against the frozen CR with the ground-truth term, three AdamW
    steps, no draws."""
    (cr, _, _), frozen, _ = _stack(2)
    kw = dict(width=8, blocks=1, down_factor=2, up_width=4)
    tiny_cr = TinyCR(**kw)
    jp = _flax_into(JTinyCR(**kw), tiny_cr, convert.tiny_cr_state_dict,
                    np.zeros((1, RES, RES, 3), np.float32), 3)
    jstate = SpyState.create(jp, joptim.adamw_cosine(3e-4, 1, 100))
    tstate = steps_state(tiny_cr, base_lr=3e-4)
    tgrads = _spy(tstate)
    jstep = jax.jit(lambda s, c, b: _jit_step(
        jdistill.make_tiny_cr_train_step(JCR(**CR), JTinyCR(**kw),
                                         gt_weight=0.3), s, c, b))
    tstep = tdistill.make_tiny_cr_train_step(cr, gt_weight=0.3,
                                             device="cpu")
    rng = np.random.default_rng(22)
    for i in range(3):
        lr_img, gt = _lr_gt(rng)
        jstate, jm, SpyState.grads = jstep(jstate, frozen["cr"],
                                             {"lr": lr_img, "gt": gt})
        _, tm = tstep(tstate, {"lr": nchw(lr_img), "gt": nchw(gt)})
        _check_step(i, tstate, jstate, tm, jm, tgrads,
                    lambda p, s: convert.tiny_cr_state_dict(p), 3e-4, i)
    _, tm = tstep(tstate, {"lr": nchw(lr_img)})
    assert float(tm["gt_loss"]) == 0.0


def _tae_sd(p, s=None):
    return {**{"enc." + k: v for k, v in
               convert.tiny_encoder_state_dict(p["enc"]).items()},
            **{"dec." + k: v for k, v in
               convert.tiny_decoder_state_dict(p["dec"]).items()}}


def test_tae_step_vs_jax():
    """The tiny pair against the frozen VAE over three AdamW steps, the
    posterior noise JAX draws from the step's key; the last step with the
    on-policy `extra_z` term."""
    (_, vae, _), frozen, _ = _stack(3)
    widths = (8, 8, 8)
    enc = tiny.TinyEncoder(widths=widths, blocks_per_stage=1)
    dec = tiny.TinyDecoder(widths=widths, blocks_per_stage=1)
    jenc = jtiny.TinyEncoder(widths=widths, blocks_per_stage=1)
    jdec = jtiny.TinyDecoder(widths=widths, blocks_per_stage=1)
    side = 16
    z0 = np.zeros((1, side // 4, side // 4, 4), np.float32)
    jp = {"enc": _flax_into(jenc, enc, convert.tiny_encoder_state_dict,
                            np.zeros((1, side, side, 3), np.float32), 4),
          "dec": _flax_into(jdec, dec, convert.tiny_decoder_state_dict, z0,
                            5)}
    pair = torch.nn.ModuleDict({"enc": enc, "dec": dec})
    jstate = SpyState.create(jp, joptim.adamw_cosine(3e-4, 1, 100))
    tstate = steps_state(pair, base_lr=3e-4)
    tgrads = _spy(tstate)
    jstep = jax.jit(lambda s, v, b, k: _jit_step(
        jdistill.make_tae_train_step(JVAE(**VAE), jenc, jdec, gt_weight=0.3),
        s, v, b, k))
    tstep = tdistill.make_tae_train_step(vae, gt_weight=0.3, device="cpu")
    rng = np.random.default_rng(23)
    for i in range(3):
        image = rng.uniform(0, 1, (B, side, side, 3)).astype(np.float32)
        jb, tb = {"image": image}, {"image": nchw(image)}
        if i == 2:
            extra = rng.standard_normal((3, side // 4, side // 4, 4)) \
                .astype(np.float32)
            jb["extra_z"], tb["extra_z"] = extra, nchw(extra)
        key = jax.random.PRNGKey(90 + i)
        jstate, jm, SpyState.grads = jstep(jstate, frozen["vae"], jb, key)
        _, tm = tstep(tstate, tb, _draw_nchw(key, (B, 4, side // 4,
                                                   side // 4)))
        assert set(tm) == {"loss", "dec_loss", "enc_loss"}
        _check_step(i, tstate, jstate, tm, jm, tgrads, _tae_sd, 3e-4, i)


# -- the stratified sampler's fault, in both packages -----------------------------

class _FakeEps(torch.nn.Module):
    """A stand-in refiner recording the timesteps it sees in training mode
    (the student's call)."""

    def __init__(self, seen):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))
        self.seen = seen

    def forward(self, x, t, cr_face, cr_latent):
        if self.training:
            self.seen.extend(int(v) for v in t)
        return x * self.w


class _FakeVAE(torch.nn.Module):
    def moments(self, images):
        z = torch.zeros(images.shape[0], 4, 4, 4)
        return z, z


def _student_timesteps_port(stratified, draws):
    seen = []
    student = _FakeEps(seen)
    step = tdistill.make_distill_train_step(
        torch.nn.Identity(), _FakeVAE(), N_STUDENT, substeps=2,
        stratified=stratified, device="cpu")
    state = steps_state(student)
    batch = {"lr": torch.rand(B, 3, 16, 16), "gt": torch.rand(B, 3, 16, 16)}
    for n in range(draws):
        step(state, _FakeEps([]).eval(), batch,
             generator=common.seeded_generator(0, n, "cpu"))
    return set(seen)


def _student_timesteps_jax(stratified, draws):
    seen = []

    class Fake:
        def apply(self, variables, x, t=None, *a, train=None, mutable=None,
                  method=None, **k):
            if method is not None:          # the VAE's encode
                return jnp.zeros((x.shape[0], 4, 4, 4))
            if t is None:                   # the CR
                return x
            if train:
                seen.extend(int(v) for v in np.asarray(t))
                return x * variables["params"]["w"], {"batch_stats": {}}
            return x * 0.0

        encode = "encode"

    fake = Fake()
    step = jdistill.make_distill_train_step(
        fake, fake, fake, J_SCHEDULE, N_STUDENT, substeps=2,
        stratified=stratified)
    state = jsteps.TrainState.create({"w": jnp.zeros(())},
                                     joptim.adam(0.0))
    batch = {"lr": np.zeros((B, 16, 16, 3), np.float32),
             "gt": np.zeros((B, 16, 16, 3), np.float32)}
    for n in range(draws):
        step(state, {"params": {"w": jnp.zeros(())}}, {"cr": {}, "vae": {}},
             batch, jax.random.PRNGKey(n))
    return set(seen)


def test_stratified_sampler_fault_in_both_packages():
    """ROADMAP §C: with a batch B below the student's N steps, the
    stratified draw is a permutation of arange(B) % N, so the steps >= B
    (here the timesteps 400, 200 and 0 of five) are never trained, in the
    JAX package and, bug-compatible, in the port; the uniform draw reaches
    all five."""
    ts = [int(t) for t in ddim_timesteps(N_STUDENT)]
    for who in (_student_timesteps_port, _student_timesteps_jax):
        assert who(True, 24) == set(ts[:B]), who.__name__
        assert who(False, 24) == set(ts), who.__name__


# -- the CLIs ----------------------------------------------------------------------

PAIRS = {"train_tae": (train_tae, jtrain_tae),
         "train_tiny_cr": (train_tiny_cr, jtrain_tiny_cr),
         "train_tiny_dn": (train_tiny_dn, jtrain_tiny_dn),
         "distill": (distill, jdistill_cli)}
PROJECTS = {"train_tae": "hifi_tae", "train_tiny_cr": "hifi_tiny_cr",
            "train_tiny_dn": "hifi_tiny_dn", "distill": "hifi_distill"}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_config_fields_match_jax(name):
    """Every field of the JAX Config with its default, and the same parsed
    flags; the JAX `platform` switch (a jax.config update) is replaced by
    `device`, the card by default; `cuda_graphs` (off by default) is the
    port's own."""
    port, ref = (m.Config for m in PAIRS[name])
    p = {f.name: f.default for f in dataclasses.fields(port)}
    j = {f.name: f.default for f in dataclasses.fields(ref)}
    port_only = {"device", "cuda_graphs"}
    assert set(j) - {"platform"} == set(p) - port_only
    for k in set(j) - {"platform"}:
        assert p[k] == j[k], k
    assert p["device"] == "cuda" and p["cuda_graphs"] is False
    flags = cli_flags(**{k: v for k, v in j.items() if k != "platform"})
    from hifidiff_tpu.cli import common as jcommon
    got = dataclasses.asdict(common.parse_config(port, flags))
    want = dataclasses.asdict(jcommon.parse_config(ref, flags))
    assert {k: v for k, v in got.items() if k not in port_only} == \
        {k: v for k, v in want.items() if k != "platform"}


T = TINY_CLI
SIZES = {k: v for k, v in T.items() if k != "size"}
CR_FLAGS = dict(cr_width=T["cr_width"], cr_enc_depths=T["cr_enc_depths"],
                cr_mid_depth=T["cr_mid_depth"])
VAE_FLAGS = dict(vae_blocks=T["vae_blocks"], vae_layers=T["vae_layers"])
UNET_FLAGS = dict(width=T["width"], enc_depths=T["enc_depths"],
                  mid_depth=T["mid_depth"], dec_depths=T["dec_depths"])
DATA = dict(procedural=16, batch_size=4, size=T["size"], device="cpu")
TINY_CR = dict(tiny_width=8, tiny_blocks=1)
TINY_DN = dict(tiny_width=8, rollout_steps=2)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The stage CLIs (`train_vae`, `train_cr`, `pretrain_denoiser`,
    `train_refiner`) on `--procedural 16 --batch-size 4 --num-epochs 1
    --device cpu`, then each distillation CLI on their checkpoint
    directories."""
    d = tmp_path_factory.mktemp("distill_chain")
    base = dict(DATA, num_epochs=1, name="t", log_dir=d / "logs")
    ck = {k: d / "ckpt" / k for k in ("vae", "cr", "dn", "ref", "tae", "tcr",
                                      "tdn", "dist")}
    train_vae.main(cli_flags(**base, **VAE_FLAGS, ckpt_dir=ck["vae"],
                             out_dir=d / "img"))
    train_cr.main(cli_flags(**base, width=T["cr_width"],
                            enc_depths=T["cr_enc_depths"],
                            mid_depth=T["cr_mid_depth"], dump_every=0,
                            ckpt_dir=ck["cr"], out_dir=d / "img"))
    pretrain_denoiser.main(cli_flags(**base, **UNET_FLAGS, **VAE_FLAGS,
                                     vae_ckpt=ck["vae"] / "t",
                                     ckpt_dir=ck["dn"], out_dir=d / "img",
                                     sample_size=2))
    stack = dict(vae_ckpt=ck["vae"] / "t", cr_ckpt=ck["cr"] / "t")
    train_refiner.main(cli_flags(**base, **SIZES, **stack,
                                 denoiser_ckpt=ck["dn"] / "t",
                                 num_inference_steps=2, ckpt_dir=ck["ref"],
                                 out_dir=d / "img"))
    stack["refiner_ckpt"] = ck["ref"] / "t"
    train_tae.main(cli_flags(**base, **VAE_FLAGS, vae_ckpt=ck["vae"] / "t",
                             ckpt_dir=ck["tae"], out_dir=d / "img"))
    train_tiny_cr.main(cli_flags(**base, **CR_FLAGS, **TINY_CR,
                                 cr_ckpt=ck["cr"] / "t", ckpt_dir=ck["tcr"],
                                 out_dir=d / "img"))
    train_tiny_dn.main(cli_flags(**base, **SIZES, **stack, **TINY_DN,
                                 ckpt_dir=ck["tdn"]))
    results = distill.main(cli_flags(
        **{k: v for k, v in base.items() if k != "num_epochs"}, **SIZES,
        **stack, teacher_steps=10, student_steps="5,1", steps_per_round=3,
        eval_batch=4, ckpt_dir=ck["dist"]))
    return {"dir": d, "ckpt": ck, "stack": stack, "distill": results}


@pytest.mark.parametrize("name", sorted(PROJECTS))
def test_chain_logs_carry_jax_keys(chain, name):
    rows = _rows(chain["dir"] / "logs", PROJECTS[name])
    assert {frozenset(r) - {"step", "time"} for r in rows} == \
        _jax_logged_keys(PAIRS[name][1])
    assert all(np.isfinite(v) for r in rows for v in r.values())


def test_chain_distill_rounds(chain):
    """Two rounds, 10 -> 5 -> 1, each checkpointed under round<r>_s<steps>
    as a whole FacialRefiner at the run's step; the results dict has the
    JAX CLI's keys, every number finite."""
    res = chain["distill"]
    assert set(res) == {"teacher_steps", "exact_gt_psnr", "rounds"}
    assert [(r["teacher_steps"], r["student_steps"], r["substeps"])
            for r in res["rounds"]] == [(10, 5, 2), (5, 1, 5)]
    assert all(np.isfinite(v) for r in res["rounds"] for v in r.values())
    # the first round's naive baseline is the original weights'
    r0 = res["rounds"][0]
    assert r0["naive_gt_psnr"] == r0["orig_naive_gt_psnr"]
    for rnd, (steps, at) in enumerate(((5, 3), (1, 6))):
        step, state = _final_state(chain["ckpt"]["dist"] / "t",
                                   f"round{rnd}_s{steps}")
        assert step == at and state["step"] == 3
        assert any(k.startswith("idc.") for k in state["module"])


def test_chain_students_and_seams_load_into_the_sampler(chain):
    """The distilled student through `--refiner-ckpt`, the tiny denoiser at
    its width, and the tiny autoencoder and tiny CR through `--tae-ckpt` /
    `--tiny-cr-ckpt` (the split sampler's tiny_enc / tiny_dec / tiny_cr
    seams): `test_refiner` runs each, every metric finite."""
    ck, stack = chain["ckpt"], chain["stack"]
    base = dict(DATA, **SIZES, **stack, grid_every=0)
    runs = [
        dict(refiner_ckpt=ck["dist"] / "t" / "round0_s5",
             num_inference_steps=5),
        dict(refiner_ckpt=ck["tdn"] / "t", width=8, num_inference_steps=2),
        dict(num_inference_steps=2, tae_ckpt=ck["tae"] / "t",
             tae_mode="both", tiny_cr_ckpt=ck["tcr"] / "t",
             tiny_cr_width=8, tiny_cr_blocks=1)]
    for run in runs:
        out = test_refiner.main(cli_flags(**dict(base, **run)))
        assert set(out) == {"psnr", "ssim"}
        assert all(np.isfinite(v) for v in out.values()), run


class _Killed(Exception):
    pass


RESUMABLE = {"train_tae": (train_tae, dict(**VAE_FLAGS)),
             "train_tiny_cr": (train_tiny_cr, dict(**CR_FLAGS, **TINY_CR)),
             "train_tiny_dn": (train_tiny_dn, dict(**SIZES, **TINY_DN))}


@pytest.mark.parametrize("name", sorted(RESUMABLE))
def test_resumed_run_equals_uninterrupted(chain, tmp_path, monkeypatch,
                                          name):
    """Two epochs, a checkpoint after each; a run of the same flags killed
    right after its first checkpoint and started again with `--resume`
    reaches the uninterrupted run's parameters, AdamW state and schedule bit
    for bit."""
    cli, sizes = RESUMABLE[name]
    stack = {k: v for k, v in chain["stack"].items()
             if k in {f.name for f in dataclasses.fields(cli.Config)}}

    def run(root, **kw):
        cli.main(cli_flags(**DATA, **sizes, **stack, name="t", log_dir=root,
                           ckpt_dir=root / "ck", out_dir=root, num_epochs=2,
                           save_model_epoch=1, **kw))
        return _final_state(root / "ck")

    whole = run(tmp_path / "whole")
    real = checkpoint.CheckpointManager.save

    def save_and_die(self, step, state, extra=None):
        real(self, step, state, extra)
        raise _Killed

    with monkeypatch.context() as mp:
        mp.setattr(checkpoint.CheckpointManager, "save", save_and_die)
        with pytest.raises(_Killed):
            run(tmp_path / "split")
    assert _final_state(tmp_path / "split" / "ck")[0] == whole[0] // 2
    resumed = run(tmp_path / "split", resume=1)
    _assert_same_run(resumed, whole)
    assert resumed[1]["scheduler"] == whole[1]["scheduler"]
