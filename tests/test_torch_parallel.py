"""The port's data and tensor parallelism (hifidiff_tpu_torch/parallel/,
the process group of `train/steps.TrainState`) on the CPU over gloo, tiny
widths; the ranks are child processes (`tests/torch_dist_worker.py`) that
rendezvous through a `file://` store in `tmp_path`, each with its own
timeout.

  * `wrap_pad_leading` bit-equal to the JAX package's on
    tests/test_parallel.py's cases; `tp_spec_for`'s eligible set equal to
    JAX's by parameter name through convert.py;
  * the IDC and refiner steps on 2 ranks (BatchNorm in training mode)
    against the JAX steps jitted over a ("data",) mesh of 2 of conftest's 8
    virtual devices, over three optimizer steps, on the same weights and
    the JAX draws (each rank takes its rows), with test_torch_train.py's
    limits: the refiner's loss 1e-5 relative, gradients 5e-4 of the
    tensor's largest (GRAD_FLOOR for tensors of rounding noise),
    parameters and EMA 5e-2 of a learning rate per update (at most 1e-3 of
    them looser, none a whole rate), running statistics 1e-3; the IDC (its
    float32 gradient is ill-conditioned, test_torch_train's
    `test_idc_float32_gradient_conditioning`) by the loss (1e-4), the
    first step's gradient by cosine (0.99) and its parameters within two
    learning rates of JAX's, which they are then set to (ROADMAP §C2). The
    controls, BatchNorm without the reduction and each rank drawing the
    local shape (every rank the same rows), fail those limits;
  * every stage's step on 2 ranks against the port's own 1-rank run on the
    concatenated batch, gradient accumulation 2 and the draws from a
    generator, to the same limits, the ranks' parameters equal bit for bit;
    the same two controls fail;
  * the denoiser with its 64-channel-and-wider layers split over a (data 2,
    model 2) mesh of 4 processes: forward and every gradient equal to the
    unsharded denoiser's (2e-5 + 1e-5 relative, JAX's test_parallel
    limits), its forward against the JAX package's `shard_params_tp` one;
    without the input gradient's all-reduce the input gradient is wrong;
  * `mp_dryrun.run(2)`; `test_refiner` on 2 ranks against 1 (1e-5
    relative); the `train_refiner` CLI on 2 ranks against one process on the
    concatenated batches (limits in its test); a step on local batches of
    unequal size raises; a float64 BatchNorm on 2 ranks within 1e-10 of
    one process.
"""

import json
import os
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_dist_worker as W
from hifidiff_tpu.models import CoarseRestoration as JCR
from hifidiff_tpu.models import FacialRefiner as JRefiner
from hifidiff_tpu.nn.resnet import ResNet50 as JResNet
from hifidiff_tpu.train import optim as joptim
from hifidiff_tpu.train import steps as jsteps
from hifidiff_tpu.utils import torch_import as ti
from hifidiff_tpu.vae import AutoencoderKL as JVAE
from hifidiff_tpu.vae.import_torch import vae_params_from_torch
from hifidiff_tpu_torch import convert
from hifidiff_tpu_torch.parallel import mesh as tmesh
from hifidiff_tpu_torch.parallel import tp as ttp
from test_torch_train import (GRAD_FLOOR, J_SCHEDULE, LOOSE_SHARE, LOSS_REL,
                              PARAM_LR_FRACTION, STATS_REL, STEP_GRAD_REL,
                              SpyState, _cosine, _jit_step, _only_noise,
                              rel_err)
from torch_parity import TINY_CLI, cli_flags, nchw, state_numpy

TIMEOUT = 120
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dist_worker.py")


# -- processes ----------------------------------------------------------------

def spawn(case, world, work):
    return [subprocess.Popen(
        [sys.executable, WORKER, case, str(r), str(world), str(work)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=W.REPO) for r in range(world)]


def collect(procs, case, work):
    """Each rank's results; fails if a rank fails or outlives TIMEOUT."""
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{case} rank {r}:\n{out}"
    return [torch.load(os.path.join(work, f"{case}.rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


# -- comparisons --------------------------------------------------------------

def check_run(got, want, lr, applied0=1, what=""):
    """A run's mini-step losses, and per optimizer step its gradients,
    parameters, running statistics and EMA, against `want` (same layout:
    `torch_dist_worker.run`'s) to test_torch_train.py's limits."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_REL,
                               err_msg=f"{what} losses")
    assert len(got["steps"]) == len(want["steps"]) > 0
    for k, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        assert g["grads"] and set(g["grads"]) <= set(w["grads"]), what
        top = max(float(w["grads"][n].abs().max()) for n in g["grads"])
        # a tensor that fails passes all the same where both gradients are
        # rounding noise (a bias in front of a BatchNorm, whose true
        # gradient is zero and which Adam moves by +-lr), and its value is
        # then left out (test_torch_train.py's rule); at most an eighth
        noise = set()

        def only_noise(name):
            return name in g["grads"] and _only_noise(
                g["grads"][name], w["grads"][name], top)

        for name, t in g["grads"].items():
            err = rel_err(t, w["grads"][name], GRAD_FLOOR * top)
            if err > STEP_GRAD_REL and only_noise(name):
                noise.add(name)
                continue
            assert err <= STEP_GRAD_REL, f"{what} step {k} grad {name}: " \
                f"{err:.2e}"
        one = lr * max(applied0 + k, 1)
        loose = total = 0
        for name, p in g["state"].items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith(("running_mean", "running_var")):
                err = rel_err(p, w["state"][name])
                assert err <= STATS_REL, f"{what} step {k} {name}: {err:.2e}"
                continue
            if name in noise:
                continue
            pairs = [(p, w["state"][name])]
            if w["ema"] is not None and name in w["ema"]:
                pairs.append((g["ema"][name], w["ema"][name]))
            diffs = [(a - b).abs() for a, b in pairs]
            if any(float(d.max()) > one for d in diffs) and only_noise(name):
                noise.add(name)
                continue
            for diff in diffs:
                assert float(diff.max()) <= one, f"{what} step {k} {name}"
                loose += int((diff > PARAM_LR_FRACTION * one).sum())
                total += diff.numel()
        assert len(noise) <= len(g["grads"]) / 8, (what, sorted(noise))
        assert loose <= LOOSE_SHARE * total, (what, k, loose, total)


def same_bits(a, b):
    return all(torch.equal(a[k], b[k]) for k in a) and set(a) == set(b)


# -- the JAX side -------------------------------------------------------------

def jax_mesh():
    return Mesh(np.array(jax.devices()[:2]), ("data",))


def on_mesh(mesh, state, batch):
    return (jax.device_put(state, NamedSharding(mesh, P())),
            jax.device_put(batch, NamedSharding(mesh, P("data"))))


def jax_trajectory(run, to_state_dict):
    """{"losses", "steps": [{"grads", "state", "ema"}]} of JAX steps under
    the port's names; `run` yields (state, metrics, grads) per step."""
    out = {"losses": [], "steps": []}
    for jstate, jm, grads in run:
        stats = jstate.batch_stats
        out["losses"].append(float(jm["loss"]))
        out["steps"].append({
            "grads": to_state_dict(grads, stats),
            "state": to_state_dict(jstate.params, stats),
            "ema": None if jstate.ema_params is None else
            to_state_dict(jstate.ema_params, stats)})
    return out


def refiner_trees():
    cr, vae = W.frozen_stack()
    ref = W.refiner()
    cr_p = ti.cr_params(state_numpy(cr), (1, 1), 1, (1, 1))
    vae_p = vae_params_from_torch(state_numpy(vae), 3, 1)
    parts = ti.split_by_prefix(state_numpy(ref))
    den_p, den_s = ti.fused_denoiser_params(parts["denoiser"], (1, 1), 1,
                                            (1, 1))
    idc_p, idc_s = ti.resnet50_params(parts["idc"], W.STAGES)
    rv = {"params": {"idc": idc_p, "denoiser": den_p,
                     "fpg": ti.fpg_params(parts["fpg"], (1, 1))},
          "batch_stats": {"idc": idc_s, "denoiser": den_s}}
    return cr_p, vae_p, rv


def refiner_draws():
    """The refiner step's draws for three steps, as the JAX step makes them
    from its key, global batch, NCHW: the step's keyword arguments."""
    b, lat = W.GLOBAL_B, (W.GLOBAL_B, W.LATENT, W.LATENT, 4)
    out = []
    for i in range(3):
        k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(50 + i), 4)
        out.append({
            "hf_posterior_noise": nchw(jax.random.normal(k1, lat)),
            "cr_posterior_noise": nchw(jax.random.normal(k2, lat)),
            "noise": nchw(jax.random.normal(k3, lat)),
            "timesteps": torch.from_numpy(np.array(jax.random.randint(
                k4, (b,), 0, J_SCHEDULE.num_train_timesteps)))})
    return out


def idc_jax_run(mesh):
    cr, _ = W.frozen_stack()
    cr_p = ti.cr_params(state_numpy(cr), (1, 1), 1, (1, 1))
    jp, js = ti.resnet50_params(state_numpy(W.idc()), W.STAGES)
    jstate = SpyState.create(jp, joptim.adam(W.IDC_JAX_LR), batch_stats=js)
    jstep = jax.jit(lambda s, b: _jit_step(jsteps.make_idc_train_step(
        JResNet(W.STAGES), JCR(**W.CR), cr_p), s, b, None))
    for i in range(3):
        jstate, batch = on_mesh(mesh, jstate, W.inputs("idc_jax", i))
        jstate, jm, grads = jstep(jstate, batch)
        yield jstate, jm, grads


def refiner_jax_run(mesh):
    cr_p, vae_p, rv = refiner_trees()
    tx = joptim.masked(joptim.adamw_cosine(1e-4, 1, 100),
                       joptim.refiner_freeze_mask(rv["params"]))
    jstate = SpyState.create(rv["params"], tx, batch_stats=rv["batch_stats"],
                             ema_decay=0.9)
    jstep = jax.jit(lambda s, f, b, k: _jit_step(
        jsteps.make_refiner_train_step(JRefiner(**W.REF), JCR(**W.CR),
                                       JVAE(**W.VAE), J_SCHEDULE), s, f, b,
        k))
    frozen = jax.device_put({"cr": cr_p, "vae": vae_p},
                            NamedSharding(mesh, P()))
    for i in range(3):
        jstate, batch = on_mesh(mesh, jstate, W.inputs("refiner", i))
        jstate, jm, grads = jstep(jstate, frozen, batch,
                                  jax.random.PRNGKey(50 + i))
        yield jstate, jm, grads


def _idc_names(p, s):
    return convert.resnet50_state_dict(p, s)


def _refiner_names(p, s):
    return convert.refiner_state_dict({"params": p, "batch_stats": s})


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    """The 2-rank runs (children), with the JAX trajectories and the 1-rank
    test_refiner run computed here while they run."""
    work = tmp_path_factory.mktemp("dp2")
    argv = cli_flags(**TINY_CLI, procedural=8, num_inference_steps=2,
                     grid_every=0, device="cpu")
    torch.save({"refiner_draws": refiner_draws(), "test_refiner_argv": argv,
                "train_refiner_argv": train_refiner_argv(work / "cli2")},
               work / "setup.pt")
    procs = spawn("dp2", 2, work)
    mesh = jax_mesh()
    idc = jax_trajectory(idc_jax_run(mesh), _idc_names)
    resets = [{k: v for k, v in s["state"].items()
               if not k.endswith("num_batches_tracked")}
              for s in idc["steps"]]
    torch.save(resets, work / "idc_jax.tmp")
    os.replace(work / "idc_jax.tmp", work / "idc_jax.pt")
    refiner = jax_trajectory(refiner_jax_run(mesh), _refiner_names)
    from hifidiff_tpu_torch.cli import test_refiner, train_refiner
    one = test_refiner.main(argv + ["--batch-size", "2"])
    with mock.patch.object(train_refiner, "Loader", W.ConcatShards):
        train_refiner.main(train_refiner_argv(work / "cli1")
                           + ["--batch-size", "4"])
    ranks = collect(procs, "dp2", work)
    for rank in ranks[1:]:      # each stage's 1-rank run, whoever made it
        ranks[0]["one"].update(rank["one"])
    return {"ranks": ranks, "jax_idc": idc, "jax_refiner": refiner,
            "test_refiner_one": one, "work": work}


def train_refiner_argv(root):
    """`train_refiner` at the tiny widths on 8 synthetic samples, one epoch
    (two steps at a global batch of 4; validation on 4 samples), writing
    into `root`."""
    return cli_flags(**TINY_CLI, synthetic=8, num_epochs=1, warmup_steps=0,
                     lr=W.LR, ema_decay=0.9, num_inference_steps=2,
                     name="dp", log_dir=root, ckpt_dir=root / "ck",
                     out_dir=root, device="cpu")


# -- no processes -------------------------------------------------------------

def test_wrap_pad_leading_bit_equal_to_jax():
    from hifidiff_tpu.parallel.mesh import wrap_pad_leading as jwrap

    x = np.arange(3 * 2, dtype=np.float32).reshape(3, 2)
    for xa, multiple in ((x, 3), (x, 4), (x[:1], 4), (x[:2], 6), (x, 1),
                         (np.float32(2.0), 4)):
        got, want = tmesh.wrap_pad_leading(np.asarray(xa), multiple), \
            jwrap(np.asarray(xa), multiple)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_tp_spec_eligible_set_equals_jax():
    """The rule on the port's layouts (output features first) shards the
    same parameters, by name, as the JAX rule on the JAX layouts (output
    features last), at two widths of the rule."""
    from hifidiff_tpu.parallel.tp import tp_spec_for as jspec
    from hifidiff_tpu_torch.models.denoiser import Denoiser

    den = Denoiser(width=32, enc_nums=(1, 1), mid_num=1, dec_nums=(1, 1))
    jp = ti.denoiser_params(state_numpy(den), (1, 1), 1, (1, 1))
    for min_features in (64, 128):
        marked = jax.tree_util.tree_map(
            lambda x: np.full(np.shape(x), float(
                "model" in [s for s in jspec(x, 2, min_features) if s])),
            jp)
        want = {n for n, v in convert.denoiser_state_dict(marked).items()
                if float(v.max()) == 1.0}
        got = {n for n, spec in ttp.tp_specs(den, 2, min_features).items()
               if "model" in spec}
        assert got == want and got


def test_single_process_mesh_and_batches():
    """Alone, a mesh is one process on every axis; `shard_batch` and
    `device_prefetch` give `to_device`'s layout, in order, wrap-padded to
    the multiple asked for."""
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"data": 1} and mesh.data_group is None
    assert tmesh.make_mesh(1, ("data", "model")).shape == \
        {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="one process per card"):
        tmesh.make_mesh(4, ("data", "model"), (2, 2))
    rng = np.random.default_rng(31)
    batches = [{"x": rng.uniform(0, 1, (3, 4, 4, 2)).astype(np.float32)}
               for _ in range(5)]
    out = list(tmesh.device_prefetch(iter(batches), "cpu", depth=2,
                                     multiple=4))
    assert len(out) == 5
    for a, b in zip(out, batches):
        want = np.concatenate([b["x"], b["x"][:1]]).transpose(0, 3, 1, 2)
        np.testing.assert_array_equal(a["x"].numpy(), want)


def test_mp_dryrun():
    from hifidiff_tpu_torch.parallel import mp_dryrun

    got = mp_dryrun.run(2, timeout=TIMEOUT)
    assert len(got["loss"]) == 2 and len(got["val"]) == 2
    assert all(np.isfinite(float(v)) for v in got["loss"] + got["val"])
    assert got["tp"][0].startswith("swapped=") and got["tp"][0] != \
        "swapped=0"


# -- 2 ranks against JAX's 2-device mesh --------------------------------------

def test_refiner_step_on_two_ranks_vs_jax_mesh(dp2):
    want = dp2["jax_refiner"]
    for r, rank in enumerate(dp2["ranks"]):
        check_run(rank["refiner_jax"], want, 1e-4, applied0=0,
                  what=f"rank {r}")
    a, b = (rank["refiner_jax"]["steps"] for rank in dp2["ranks"])
    assert all(same_bits(x["state"], y["state"]) for x, y in zip(a, b))


def test_idc_step_on_two_ranks_vs_jax_mesh(dp2):
    want = dp2["jax_idc"]
    for r, rank in enumerate(dp2["ranks"]):
        got = rank["idc_jax"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        assert _cosine({n: g.double() for n, g in
                        got["steps"][0]["grads"].items()},
                       {n: g.double() for n, g in
                        want["steps"][0]["grads"].items()}) >= 0.99
        for k, (g, w) in enumerate(zip(got["steps"], want["steps"])):
            for name, p in g["state"].items():
                if name.endswith(("running_mean", "running_var")):
                    assert rel_err(p, w["state"][name]) <= STATS_REL, \
                        (r, k, name)
                elif not name.endswith("num_batches_tracked"):
                    assert float((p - w["state"][name]).abs().max()) \
                        <= 2 * W.IDC_JAX_LR + 1e-6, (r, k, name)


@pytest.mark.parametrize("control", ["unsynced BN", "local draws"])
def test_controls_fail_vs_jax_mesh(dp2, control):
    rank = dp2["ranks"][0]
    with pytest.raises(AssertionError):
        check_run(rank[f"refiner_jax {control}"], dp2["jax_refiner"], 1e-4,
                  applied0=0)


# -- N ranks against the port's 1-rank run ------------------------------------

def check_idc_run(got, want, lr, what=""):
    """The IDC's float32 gradient is ill-conditioned and Adam's first
    updates are sign-like (test_torch_train.py's IDC step): the run was set
    to `want`'s parameters after each update. Losses 1e-4 relative; each
    update's gradient with a cosine of 1 - 1e-6 to `want`'s and within 2e-2
    of each tensor's largest (the bound of test_torch_train's float64
    witness); parameters within two learning rates before they were set;
    running statistics STATS_REL."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4,
                               err_msg=what)
    for k, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        assert set(g["grads"]) == set(w["grads"]), what
        assert _cosine({n: t.double() for n, t in g["grads"].items()},
                       {n: t.double() for n, t in w["grads"].items()}) \
            >= 1 - 1e-6, (what, k)
        top = max(float(t.abs().max()) for t in w["grads"].values())
        for name, t in g["grads"].items():
            assert rel_err(t, w["grads"][name], GRAD_FLOOR * top) <= 2e-2, \
                (what, k, name)
        for name, p in g["state"].items():
            if name.endswith(("running_mean", "running_var")):
                assert rel_err(p, w["state"][name]) <= STATS_REL, \
                    (what, k, name)
            elif not name.endswith("num_batches_tracked"):
                assert float((p - w["state"][name]).abs().max()) \
                    <= 2 * lr + 1e-6, (what, k, name)


@pytest.mark.parametrize("kind", W.KINDS)
def test_two_ranks_equal_one_rank(dp2, kind):
    one = dp2["ranks"][0]["one"][kind]
    a, b = (rank["ranks"][kind] for rank in dp2["ranks"])
    for r, got in enumerate((a, b)):
        if kind == "idc":
            check_idc_run(got, one, W.LR, what=f"rank {r}")
            continue
        check_run(got, one, W.LR, what=f"{kind} rank {r}")
        assert all(set(x["grads"]) == set(y["grads"])
                   for x, y in zip(got["steps"], one["steps"]))
    for x, y in zip(a["steps"], b["steps"]):
        assert same_bits(x["state"], y["state"]), kind
        assert x["ema"] is None or same_bits(x["ema"], y["ema"]), kind


@pytest.mark.parametrize("control", ["unsynced BN", "local draws"])
def test_controls_fail_vs_one_rank(dp2, control):
    rank = dp2["ranks"][0]
    with pytest.raises(AssertionError):
        check_run(rank["ranks"][f"refiner {control}"], rank["one"]["refiner"],
                  W.LR)


def test_local_batch_to_global(dp2):
    """Every rank holds the global batch, rank 0's rows first, numpy as
    numpy and tensors as tensors."""
    for rank in dp2["ranks"]:
        got = rank["gathered"]
        np.testing.assert_array_equal(
            got["x"], np.repeat(np.arange(2, dtype=np.float32), 2)[:, None]
            * np.ones((1, 3), np.float32))
        assert torch.equal(got["t"], torch.tensor([0, 1, 10, 11]))


def test_unequal_local_batches_raise(dp2):
    """A step whose processes hold local batches of unequal size raises on
    every process before the optimizer step, naming the sizes."""
    for rank in dp2["ranks"]:
        got = rank["unequal rows"]
        assert got["raised"] and "unequal" in got["raised"], got
        assert got["kept"]


def test_batch_norm_float64_two_ranks_vs_one(dp2):
    """In float64 BatchNorm's global statistics stay float64: outputs,
    input gradients and running statistics within 1e-10 of one process on
    the 4 rows (float32 statistics would miss by 1e-6 and more)."""
    for rank in dp2["ranks"]:
        got = rank["bn float64"]
        assert max(got.values()) <= 1e-10, got


def test_test_refiner_two_ranks_vs_one(dp2):
    """Batch 1 a rank: each global batch is the 1-rank run's batch of 2 in
    its order, with the same noise rows; PSNR and SSIM over the whole set."""
    one = dp2["test_refiner_one"]
    for rank in dp2["ranks"]:
        got = rank["test_refiner"]
        assert set(got) == set(one)
        for k in one:
            np.testing.assert_allclose(got[k], one[k], rtol=1e-5, err_msg=k)


def cli_run(root, project):
    """A training CLI's logged rows (JSONL) and its latest checkpoint's
    state."""
    from hifidiff_tpu_torch.train.checkpoint import CheckpointManager

    with open(root / f"{project}.dp.jsonl") as f:
        rows = [json.loads(line) for line in f]
    ckpt = CheckpointManager(str(root / "ck" / "dp"), create=False)
    state = torch.load(ckpt.path(ckpt.latest_step()),
                       weights_only=False)["state"]
    return rows, state


def test_train_refiner_cli_two_ranks_vs_one(dp2):
    """`train_refiner` on 2 ranks (batch 2 each; the sharded Loaders,
    `device_prefetch`, validation through `sampler_noise` and the global
    metrics, the checkpoint written by rank 0) against one process at batch
    4 whose Loaders yield the two ranks' batches concatenated
    (`torch_dist_worker.ConcatShards`): the logged train losses LOSS_REL
    relative, val PSNR and SSIM 1e-5; the checkpoint's step count equal, its
    parameters and EMA at most LOOSE_SHARE of the entries more than
    PARAM_LR_FRACTION of a learning rate per update apart (no gradients are
    at hand to set the tensors of rounding noise aside, whose Adam updates
    are +-lr: none more than two rates a update), its running statistics
    STATS_REL."""
    got_rows, got = cli_run(dp2["work"] / "cli2", "hifi_refiner")
    want_rows, want = cli_run(dp2["work"] / "cli1", "hifi_refiner")

    def logged(rows, key):
        return [r[key] for r in rows if key in r]

    assert len(logged(got_rows, "train_loss")) == 2
    np.testing.assert_allclose(logged(got_rows, "train_loss"),
                               logged(want_rows, "train_loss"),
                               rtol=LOSS_REL)
    for key in ("val_psnr", "val_ssim"):
        assert len(logged(got_rows, key)) == 1
        np.testing.assert_allclose(logged(got_rows, key),
                                   logged(want_rows, key), rtol=1e-5,
                                   err_msg=key)
    assert got["step"] == want["step"] == 2
    loose = total = 0
    for name, w in want["module"].items():
        g = got["module"][name]
        if name.endswith(("running_mean", "running_var")):
            assert rel_err(g, w) <= STATS_REL, name
        elif w.is_floating_point():
            pairs = [(g, w)]
            if name in want["ema_params"]:
                pairs.append((got["ema_params"][name],
                              want["ema_params"][name]))
            for a, b in pairs:
                diff = (a - b).abs() / (W.LR * got["step"])
                assert float(diff.max()) <= 2.0, name
                loose += int((diff > PARAM_LR_FRACTION).sum())
                total += diff.numel()
    assert loose <= LOOSE_SHARE * total, (loose, total)


# -- tensor parallelism on a (data 2, model 2) mesh ---------------------------

@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    from hifidiff_tpu_torch.models.denoiser import Denoiser

    work = tmp_path_factory.mktemp("tp4")
    torch.manual_seed(0)
    den = W._perturbed(Denoiser(width=32, enc_nums=(1, 1), mid_num=1,
                                dec_nums=(1, 1)), 8)
    g = torch.Generator().manual_seed(9)
    setup = {"tp_state": den.state_dict(),
             "tp_latents": torch.randn(4, 4, 8, 8, generator=g),
             "tp_t": torch.full((4,), 100.0),
             "tp_weight": torch.randn(4, 4, 8, 8, generator=g)}
    torch.save(setup, work / "setup.pt")
    procs = spawn("tp4", 4, work)
    ranks = collect(procs, "tp4", work)
    return setup, den, ranks


def test_tp_denoiser_forward_and_gradients(tp4):
    _, _, ranks = tp4
    for r, rank in enumerate(ranks):
        got = rank["tp"]
        assert rank["tp swapped"] > 0
        for what in ("y", "dx"):
            np.testing.assert_allclose(*(t.numpy() for t in got[what][::-1]),
                                       atol=2e-5, rtol=1e-5,
                                       err_msg=f"rank {r} {what}")
        for name, (plain, shard) in got["grads"].items():
            np.testing.assert_allclose(shard.numpy(), plain.numpy(),
                                       atol=2e-5, rtol=1e-5,
                                       err_msg=f"rank {r} {name}")


def test_tp_without_input_all_reduce_is_wrong(tp4):
    _, _, ranks = tp4
    for rank in ranks:
        plain, shard = rank["tp no input all-reduce"]["dx"]
        assert float((plain - shard).abs().max()) > 1e-3 * float(
            plain.abs().max())


def test_tp_denoiser_forward_vs_jax_shard_params_tp(tp4):
    from hifidiff_tpu.models import Denoiser as JDenoiser
    from hifidiff_tpu.parallel import shard_params_tp as jshard

    setup, den, ranks = tp4
    jp = ti.denoiser_params(state_numpy(den), (1, 1), 1, (1, 1))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    model = JDenoiser(width=32, enc_nums=(1, 1), mid_num=1, dec_nums=(1, 1))
    lat = jax.device_put(
        np.ascontiguousarray(setup["tp_latents"].permute(0, 2, 3, 1).numpy()),
        NamedSharding(mesh, P("data")))
    out = jax.jit(lambda p, x, t: model.apply({"params": p}, x, t))(
        jshard(jp, mesh, min_features=64), lat, setup["tp_t"].numpy())
    want = np.asarray(out).transpose(0, 3, 1, 2)
    for rank in ranks:
        d = rank["tp"]["data"]
        np.testing.assert_allclose(rank["tp"]["y"][1].numpy(),
                                   want[2 * d:2 * d + 2], atol=2e-5,
                                   rtol=1e-5)
