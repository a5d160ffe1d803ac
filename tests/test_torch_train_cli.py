"""The port's training entry points (`cli/train_vae`, `train_cr`,
`pretrain_idc`, `test_idc`, `pretrain_denoiser`, `train_refiner`,
`convergence_demo`) and the models' `remat` against the JAX package's, on
the CPU at tiny widths.

Tolerances: configs, argv and the freeze mask equal; `remat` against the
plain forward 0 (loss, gradients, parameters and BatchNorm statistics after a
step, bit for bit: the recompute runs the same operations on the same
inputs); the composed refiner and its frozen parts after training bit for
bit against the stage files; resumed runs bit for bit against the
uninterrupted ones; the learning rate against optax's to 1e-6 relative
(optax computes it in float32); the cached-latent run's losses against the
image run's to 1e-5 relative (the encoder sees other batches).
"""

import ast
import dataclasses
import inspect
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifidiff_tpu.cli import common as jcommon
from hifidiff_tpu.cli import convergence_demo as jdemo
from hifidiff_tpu.cli import pretrain_denoiser as jpretrain_denoiser
from hifidiff_tpu.cli import pretrain_idc as jpretrain_idc
from hifidiff_tpu.cli import test_idc as jtest_idc
from hifidiff_tpu.cli import test_refiner as jtest_refiner
from hifidiff_tpu.cli import train_cr as jtrain_cr
from hifidiff_tpu.cli import train_refiner as jtrain_refiner
from hifidiff_tpu.cli import train_vae as jtrain_vae
from hifidiff_tpu.data import core as jcore
from hifidiff_tpu.train import optim as joptim
from hifidiff_tpu_torch import convert
from hifidiff_tpu_torch.cli import (common, convergence_demo,
                                    pretrain_denoiser, pretrain_idc,
                                    test_idc, test_refiner, train_cr,
                                    train_refiner, train_vae)
from hifidiff_tpu_torch.train import checkpoint, optim, steps
from torch_parity import TINY_CLI, cli_flags, refiner_tree

torch.set_num_threads(1)

PAIRS = {"train_vae": (train_vae, jtrain_vae),
         "train_cr": (train_cr, jtrain_cr),
         "pretrain_idc": (pretrain_idc, jpretrain_idc),
         "test_idc": (test_idc, jtest_idc),
         "pretrain_denoiser": (pretrain_denoiser, jpretrain_denoiser),
         "train_refiner": (train_refiner, jtrain_refiner),
         "convergence_demo": (convergence_demo, jdemo)}
PROJECTS = {"train_vae": "hifi_vae", "train_cr": "hifi_cr",
            "pretrain_idc": "hifi_idc", "pretrain_denoiser": "hifi_denoiser",
            "train_refiner": "hifi_refiner"}
T = TINY_CLI
SIZES = {k: v for k, v in T.items() if k != "size"}
CR_FLAGS = dict(cr_width=T["cr_width"], cr_enc_depths=T["cr_enc_depths"],
                cr_mid_depth=T["cr_mid_depth"])
VAE_FLAGS = dict(vae_blocks=T["vae_blocks"], vae_layers=T["vae_layers"])
UNET_FLAGS = dict(width=T["width"], enc_depths=T["enc_depths"],
                  mid_depth=T["mid_depth"], dec_depths=T["dec_depths"])
DATA = dict(procedural=16, batch_size=4, size=T["size"], device="cpu")


def _defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PAIRS))
def test_config_fields_match_jax(name):
    """Every field of the JAX Config, with its default, plus `device` (the
    card by default) and, in the training CLIs, `cuda_graphs` (off by
    default); the demo's `platform` (a jax.config switch) is replaced by
    `device`."""
    port, ref = (m.Config for m in PAIRS[name])
    p, j = _defaults(port), _defaults(ref)
    replaced = {"platform"} if name == "convergence_demo" else set()
    port_only = {"device"} | ({"cuda_graphs"} if name in PROJECTS else set())
    assert set(j) - replaced == set(p) - port_only
    for k in set(j) - replaced:
        assert p[k] == j[k], k
    assert p["device"] == "cuda" and p.get("cuda_graphs", False) is False
    flags = cli_flags(**{k: v for k, v in j.items() if k not in replaced})
    assert {k: v for k, v in dataclasses.asdict(common.parse_config(
        port, flags)).items() if k not in port_only} == {
        k: v for k, v in dataclasses.asdict(jcommon.parse_config(
            ref, flags)).items() if k not in replaced}


TRAINING_CLIS = ("train_vae", "train_cr", "pretrain_idc", "pretrain_denoiser",
                 "train_refiner", "train_tae", "train_tiny_cr",
                 "train_tiny_dn", "distill")


@pytest.mark.parametrize("name", TRAINING_CLIS)
def test_cuda_graphs_refused_on_the_cpu(name):
    """`--cuda-graphs` captures the train step on the card: a two-step run
    on the CPU raises by name before it builds anything."""
    import importlib

    cli = importlib.import_module(f"hifidiff_tpu_torch.cli.{name}")
    argv = cli_flags(**DATA) + ["--cuda-graphs", "true"]
    assert common.parse_config(cli.Config, argv).cuda_graphs is True
    with pytest.raises(ValueError, match="--cuda-graphs captures the train "
                       "step as CUDA graphs, which needs the card"):
        cli.main(argv)


# -- remat ----------------------------------------------------------------------

def _denoiser(remat):
    from hifidiff_tpu_torch.models.denoiser import Denoiser

    with common.seeded(0):
        return Denoiser(width=16, enc_nums=(1, 1), mid_num=1,
                        dec_nums=(1, 1), remat=remat)


def _refiner(remat):
    cfg = types.SimpleNamespace(**T, seed=0, remat=remat)
    return common.build_refiner_models(cfg)


def _count_forwards(module):
    """Count the calls of every ConditionalNAFBlock's `forward` (the
    checkpoint's recompute calls it without the module hooks); returns the
    counter and a function that takes the counting off."""
    from hifidiff_tpu_torch.nn.naf import ConditionalNAFBlock

    runs = [0]
    blocks = [b for b in module.modules()
              if isinstance(b, ConditionalNAFBlock)]
    for b in blocks:
        def forward(*a, _real=b.forward, **k):
            runs[0] += 1
            return _real(*a, **k)
        b.forward = forward

    def undo():
        for b in blocks:
            del b.forward
    return runs, undo


def _one_step(kind, remat):
    """One train step through the step factory: (loss, gradients, module,
    how many block forwards ran)."""
    from hifidiff_tpu_torch.random_weights import perturb_

    rng = np.random.default_rng(0)
    if kind == "denoiser":
        module = _denoiser(remat)
        vae = common.build_refiner_models(types.SimpleNamespace(
            **T, seed=0))[1]
        step = steps.make_denoiser_train_step(vae, device="cpu")
        args = (torch.from_numpy(rng.uniform(0, 1, (2, 3, 32, 32))
                                 .astype(np.float32)),)
    else:
        cr, vae, module, _ = _refiner(remat)
        optim.apply_freeze_mask_(module, optim.refiner_freeze_mask(module))
        step = steps.make_refiner_train_step(cr, vae, device="cpu")
        args = ({k: torch.from_numpy(rng.uniform(0, 1, (2, 3, 32, 32))
                                     .astype(np.float32))
                 for k in ("lr", "gt")},)
    perturb_(module, torch.Generator().manual_seed(1))
    runs, undo = _count_forwards(module)
    state = steps.TrainState.create(module, optim.adam, device="cpu")
    grads = {}
    apply = state.apply_gradients

    def spy():
        grads.update({n: p.grad.clone() for n, p in
                      module.named_parameters() if p.grad is not None})
        apply()

    state.apply_gradients = spy
    _, metrics = step(state, *args,
                      generator=torch.Generator().manual_seed(2))
    undo()
    return float(metrics["loss"]), grads, module, runs[0]


@pytest.mark.parametrize("kind", ["denoiser", "refiner"])
def test_remat_matches_plain_training(kind):
    """`remat=True` keeps the state-dict names and gives the plain step's
    loss, gradients, parameters and HCA BatchNorm statistics bit for bit,
    running each block's forward twice in training; in eval mode and
    without a gradient each block runs once."""
    loss0, g0, m0, runs0 = _one_step(kind, False)
    loss1, g1, m1, runs1 = _one_step(kind, True)
    assert list(m0.state_dict()) == list(m1.state_dict())
    assert loss0 == loss1
    assert g0.keys() == g1.keys() and g0
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    s0, s1 = m0.state_dict(), m1.state_dict()
    for n in s0:   # parameters after the step, running statistics
        assert torch.equal(s0[n], s1[n]), n
    if kind == "refiner":
        assert any("hcas" in n and n.endswith("running_var") for n in s0)
    assert runs1 == 2 * runs0
    blocks = runs0   # one forward in the plain step
    for train, grad in ((False, True), (True, False)):
        m1.train(train)
        with torch.set_grad_enabled(grad):
            assert _forward_runs(kind, m1) == blocks


def _forward_runs(kind, module):
    """How many block forwards one forward (and its backward, where a
    gradient is wanted) of `module` runs."""
    runs, undo = _count_forwards(module)
    lat, t = torch.randn(2, 4, 8, 8), torch.tensor([3.0, 700.0])
    if kind == "denoiser":
        out = module(lat, t)
    else:
        out = module(lat, t, torch.rand(2, 3, 32, 32),
                     torch.randn(2, 4, 8, 8))
    if out.requires_grad:
        out.sum().backward()
    undo()
    return runs[0]


def test_fresh_vaes_are_drawn_as_the_jax_clis_draw_them(tmp_path):
    """Where the JAX CLIs call `vae.init` (stage 0, and a frozen VAE without
    `--vae-ckpt`), the port's draw flax-style from the seed: zero biases,
    the same draw for the same seed, another for another seed."""
    from hifidiff_tpu_torch.vae.model import AutoencoderKL

    def fresh(seed):
        vae = AutoencoderKL(block_out=(32, 32), layers_per_block=1)
        return common.load_vae(vae, "", seed).state_dict()

    a, b, c = fresh(0), fresh(0), fresh(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.conv_in.weight"],
                            c["encoder.conv_in.weight"])
    assert all(torch.count_nonzero(v) == 0 for k, v in a.items()
               if k.endswith("bias") and "norm" not in k)
    train_vae.main(cli_flags(**DATA, **VAE_FLAGS, num_epochs=1,
                             warmup_steps=1, lr=0.0, name="t",
                             log_dir=tmp_path, ckpt_dir=tmp_path,
                             out_dir=tmp_path))
    _, state = _final_state(tmp_path)
    assert all(torch.count_nonzero(v) == 0 for k, v in
               state["module"].items() if k.endswith("bias")
               and "norm" not in k)


# -- the five stages chained --------------------------------------------------

def _rows(log_dir, project, name="t"):
    with open(log_dir / f"{project}.{name}.jsonl") as f:
        return [json.loads(line) for line in f if line.strip()]


def _final_state(ckpt_dir, name="t"):
    mgr = checkpoint.CheckpointManager(str(ckpt_dir / name), create=False)
    step = mgr.latest_step()
    return step, torch.load(mgr.path(step), weights_only=True)["state"]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Stages 0-4 chained through their checkpoint directories on
    `--procedural 16 --batch-size 4 --num-epochs 1 --device cpu`, with
    `test_idc` on the stage files and a second denoiser run on cached
    latents. Records the refiner as `train_refiner` composed it."""
    d = tmp_path_factory.mktemp("chain")
    base = dict(DATA, num_epochs=1, name="t", log_dir=d / "logs")
    ck = {k: d / "ckpt" / k for k in ("vae", "cr", "idc", "dn", "dnc",
                                      "ref")}
    composed = {}
    real_compose = train_refiner.compose

    def spy(cfg, refiner):
        loaded = real_compose(cfg, refiner)
        composed.update({k: v.clone()
                         for k, v in refiner.state_dict().items()})
        return loaded

    out = {"dir": d, "ckpt": ck, "composed": composed}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_refiner, "compose", spy)
        train_vae.main(cli_flags(**base, **VAE_FLAGS, ckpt_dir=ck["vae"],
                                 out_dir=d / "img"))
        train_cr.main(cli_flags(**base, width=T["cr_width"],
                                enc_depths=T["cr_enc_depths"],
                                mid_depth=T["cr_mid_depth"], dump_every=2,
                                ckpt_dir=ck["cr"], out_dir=d / "img"))
        pretrain_idc.main(cli_flags(**base, **CR_FLAGS,
                                    idc_stages=T["idc_stages"],
                                    cr_ckpt=ck["cr"] / "t",
                                    ckpt_dir=ck["idc"]))
        out["test_idc"] = test_idc.main(cli_flags(
            **DATA, **CR_FLAGS, idc_stages=T["idc_stages"],
            cr_ckpt=ck["cr"] / "t", idc_ckpt=ck["idc"] / "t"))
        for run, more in (("dn", {}), ("dnc", dict(cache_latents=1))):
            pretrain_denoiser.main(cli_flags(
                **dict(base, name=run), **UNET_FLAGS, **VAE_FLAGS,
                vae_ckpt=ck["vae"] / "t", ckpt_dir=ck[run],
                out_dir=d / "img", sample_size=2, **more))
        train_refiner.main(cli_flags(
            **base, **SIZES, vae_ckpt=ck["vae"] / "t", cr_ckpt=ck["cr"] / "t",
            idc_ckpt=ck["idc"] / "t", denoiser_ckpt=ck["dn"] / "dn",
            num_inference_steps=2, ckpt_dir=ck["ref"], out_dir=d / "img"))
    return out


def _jax_logged_keys(module):
    """The key sets of the dicts the JAX CLI's source hands `logger.log`."""
    found = set()
    for node in ast.walk(ast.parse(inspect.getsource(module))):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "log" \
                and getattr(node.func.value, "id", "") == "logger" \
                and isinstance(node.args[0], ast.Dict):
            found.add(frozenset(k.value for k in node.args[0].keys))
    return found


@pytest.mark.parametrize("name", sorted(PROJECTS))
def test_chain_logs_carry_jax_keys(chain, name):
    """Each stage's JSONL rows, under the JAX CLI's project name, carry the
    keys the JAX CLI logs, every value finite."""
    run = {"pretrain_denoiser": "dn"}.get(name, "t")
    rows = _rows(chain["dir"] / "logs", PROJECTS[name], run)
    assert {frozenset(r) - {"step", "time"} for r in rows} == \
        _jax_logged_keys(PAIRS[name][1])
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert len([r for r in rows if "epoch" in r]) == 4   # 16 / 4 steps


def test_chain_composed_refiner_holds_stage_files(chain):
    """The refiner that `train_refiner` composed holds the stage-2 IDC and
    the stage-3 denoiser (and the FPG's overlapping names) bit for bit;
    after training, its frozen parts still do."""
    ck, composed = chain["ckpt"], chain["composed"]
    idc = common.read_state_dict(str(ck["idc"] / "t"))
    den = common.read_state_dict(str(ck["dn"] / "dn"))
    assert idc and den
    for k, v in idc.items():
        assert torch.equal(composed["idc." + k], v), k
    for k, v in den.items():
        assert torch.equal(composed["denoiser." + k], v), k
    fpg = [k for k in composed if k.startswith("fpg.")
           and k[4:] in den and composed[k].shape == den[k[4:]].shape]
    assert fpg
    for k in fpg:
        assert torch.equal(composed[k], den[k[4:]]), k
    _, final = _final_state(ck["ref"])
    trained = final["module"]
    frozen = [n for n, keep in optim.refiner_freeze_mask(
        _refiner(False)[2]).items() if not keep]
    assert frozen
    for n in frozen:
        assert torch.equal(trained[n], composed[n]), n
    assert any(not torch.equal(trained[n], composed[n])
               for n in trained if n.startswith("denoiser.decoders"))


def test_chain_freeze_mask_matches_jax(chain):
    """The port's freeze mask over the trained refiner's names equals the
    JAX mask over the JAX tree of the same state dict, carried back to the
    port's names through convert.py."""
    _, final = _final_state(chain["ckpt"]["ref"])
    sd = {k: v.numpy() for k, v in final["module"].items()}
    tree = refiner_tree(sd)
    jmask = joptim.refiner_freeze_mask(tree["params"])
    as_float = jax.tree_util.tree_map(
        lambda keep, leaf: np.full(np.shape(leaf), float(keep), np.float32),
        jmask, tree["params"])
    back = convert.refiner_state_dict({"params": as_float,
                                       "batch_stats": tree["batch_stats"]})
    mask = optim.refiner_freeze_mask(_refiner(False)[2])
    assert set(mask) <= set(back)
    for n, keep in mask.items():
        assert torch.all(back[n] == float(keep)), n
    assert 0 < sum(mask.values()) < len(mask)


def test_chain_test_idc_and_cached_latents(chain):
    """`test_idc` on the stage files returns the JAX CLI's dict; the cached
    latent run's losses equal the image run's (same draws, the moments
    computed once)."""
    assert set(chain["test_idc"]) == {"batch_accuracy", "sample_accuracy"}
    assert all(0.0 <= v <= 1.0 for v in chain["test_idc"].values())
    logs = chain["dir"] / "logs"
    image = [r["train_loss"] for r in _rows(logs, "hifi_denoiser", "dn")]
    cached = [r["train_loss"] for r in _rows(logs, "hifi_denoiser", "dnc")]
    np.testing.assert_allclose(cached, image, rtol=1e-5)


# -- the schedule -------------------------------------------------------------

def _optax_lrs(lr, warmup, total, n):
    """The learning rate optax's `adamw_cosine` applies at each of n
    updates: with zero gradients an AdamW update is -lr * wd * param."""
    wd = 0.01
    tx = joptim.adamw_cosine(lr, warmup, total, weight_decay=wd)
    params = {"w": jnp.ones(())}
    opt_state = tx.init(params)
    out = []
    for _ in range(n):
        upd, opt_state = tx.update({"w": jnp.zeros(())}, opt_state, params)
        out.append(-float(upd["w"]) / wd)
    return out


@pytest.mark.parametrize("name", ["pretrain_denoiser", "train_refiner"])
def test_lr_schedule_matches_optax(monkeypatch, tmp_path, name):
    """The rate fed to the optimizer at every step of a two-epoch run equals
    optax's `adamw_cosine(lr, warmup, len(loader) * num_epochs)`."""
    seen = []
    apply = steps.TrainState.apply_gradients

    def spy(self):
        seen.append(self.optimizer.param_groups[0]["lr"])
        apply(self)

    monkeypatch.setattr(steps.TrainState, "apply_gradients", spy)
    flags = dict(DATA, num_epochs=2, lr=3e-4, warmup_steps=3, name="t",
                 log_dir=tmp_path, ckpt_dir=tmp_path, out_dir=tmp_path,
                 **UNET_FLAGS, **VAE_FLAGS)
    if name == "train_refiner":
        flags.update(T, num_inference_steps=1)
    else:
        flags.update(sample_size=1, save_image_epoch=5)
    PAIRS[name][0].main(cli_flags(**flags))
    assert len(seen) == 8   # 16 / 4 steps an epoch, two epochs
    np.testing.assert_allclose(seen, _optax_lrs(3e-4, 3, 8, 8), rtol=1e-6,
                               atol=1e-12)


# -- resume -------------------------------------------------------------------

def test_jax_loader_without_epoch_set_repeats_epoch_0():
    """The JAX CLIs rebuild their Loader on --resume and never set its
    epoch, so a resumed run draws epoch 0's order again; the port's
    `resume` sets the epoch and draws the uninterrupted run's order."""
    ds = jcommon.SyntheticFaceDataset(12, 4, keys=("gt",), seed=0)

    def order(loader):
        return [b["gt"][:, 0, 0, 0].tolist() for b in loader]

    uninterrupted = jcore.Loader(ds, 4, shuffle=True, seed=0)
    epoch0, epoch1 = order(uninterrupted), order(uninterrupted)
    assert epoch0 != epoch1
    assert order(jcore.Loader(ds, 4, shuffle=True, seed=0)) == epoch0

    class Ckpt:
        def latest_step(self):
            return 3

        def restore(self, state):
            state.step = 3

    from hifidiff_tpu_torch.data.core import Loader

    loader = Loader(common.SyntheticFaceDataset(12, 4, keys=("gt",)), 4,
                    shuffle=True, seed=0)
    state = types.SimpleNamespace(step=0)
    start = common.resume(types.SimpleNamespace(resume=True), Ckpt(), state,
                          loader)
    assert start == 1 and order(loader) == epoch1


def _assert_same_run(a, b):
    (sa, da), (sb, db) = a, b
    assert sa == sb
    assert da["step"] == db["step"]
    for k in da["module"]:
        assert torch.equal(da["module"][k], db["module"][k]), k
    assert da["optimizer"]["param_groups"] == db["optimizer"]["param_groups"]
    for i, s in da["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, db["optimizer"]["state"][i][k]), (i, k)


def _train_cr(root, **kw):
    train_cr.main(cli_flags(**DATA, name="t", log_dir=root,
                            ckpt_dir=root / "ck", out_dir=root,
                            width=T["cr_width"], enc_depths=T["cr_enc_depths"],
                            mid_depth=T["cr_mid_depth"], save_epoch=1, **kw))
    return _final_state(root / "ck")


def test_resumed_train_cr_equals_uninterrupted(monkeypatch, tmp_path):
    """One epoch, then `--resume` to two, gives the two-epoch run's
    parameters and Adam state bit for bit; with the loader's epoch left at
    0 (the JAX CLI's resume) it does not."""
    whole = _train_cr(tmp_path / "whole", num_epochs=2)
    _train_cr(tmp_path / "split", num_epochs=1)
    _assert_same_run(_train_cr(tmp_path / "split", num_epochs=2, resume=1),
                     whole)

    real = common.resume

    def jax_like(cfg, ckpt, state, loader):
        start = real(cfg, ckpt, state, loader)
        loader.epoch = 0
        return start

    monkeypatch.setattr(train_cr, "resume", jax_like)
    _train_cr(tmp_path / "jax", num_epochs=1)
    _, state = _train_cr(tmp_path / "jax", num_epochs=2, resume=1)
    assert any(not torch.equal(v, whole[1]["module"][k])
               for k, v in state["module"].items())


def test_resumed_train_refiner_equals_uninterrupted(tmp_path):
    """`--stop-after-epoch 0` then `--resume` with the same `--num-epochs`
    reaches the uninterrupted run's step count, learning rate, parameters
    and AdamW state bit for bit."""
    def run(root, **kw):
        train_refiner.main(cli_flags(
            **DATA, **SIZES, name="t", log_dir=root, ckpt_dir=root / "ck",
            out_dir=root, num_epochs=2, warmup_steps=2,
            num_inference_steps=1, save_epoch=5, **kw))
        return _final_state(root / "ck")

    whole = run(tmp_path / "whole")
    first = run(tmp_path / "split", stop_after_epoch=0)
    assert first[0] == 4
    resumed = run(tmp_path / "split", resume=1)
    _assert_same_run(resumed, whole)
    assert resumed[1]["scheduler"] == whole[1]["scheduler"]
    rows = _rows(tmp_path / "split", "hifi_refiner")
    assert [r["epoch"] for r in rows if "epoch" in r] == [0] * 4 + [1] * 4


def _pretrain_idc(root, **kw):
    pretrain_idc.main(cli_flags(**DATA, **CR_FLAGS, name="t", log_dir=root,
                                idc_stages=T["idc_stages"], save_epoch=1,
                                ckpt_dir=root / "ck", **kw))
    return _final_state(root / "ck")


def test_resumed_pretrain_idc_stops_at_num_epochs(tmp_path):
    """Resumed after one epoch, the port's `pretrain_idc` trains the one
    epoch left of two (the uninterrupted run's parameters, bit for bit) and
    nothing more when one was asked for."""
    whole = _pretrain_idc(tmp_path / "whole", num_epochs=2)
    assert _pretrain_idc(tmp_path / "split", num_epochs=1)[0] == 4
    assert _pretrain_idc(tmp_path / "split", num_epochs=1, resume=1)[0] == 4
    _assert_same_run(_pretrain_idc(tmp_path / "split", num_epochs=2,
                                   resume=1), whole)
    rows = _rows(tmp_path / "split", "hifi_idc")
    assert [r["epoch"] for r in rows if "epoch" in r] == [0] * 4 + [1] * 4


def test_jax_pretrain_idc_resume_trains_num_epochs_more(monkeypatch):
    """The JAX CLI's loop after a resume: restored at step 4 (one epoch of
    four steps done) with `--num-epochs 2`, it runs epochs 0 and 1 again,
    eight more steps. Its models, step and checkpoints are stand-ins; the
    loop, the data and the logger's calls are the CLI's own."""
    logged = []

    class State:
        step, params, batch_stats = 4, {}, {}

    class Ckpt:
        def __init__(self, *a):
            pass

        latest_step = close = staticmethod(lambda: 4)

        def restore(self, template):
            return {"state": State()}

        def save(self, step, state, wait=True):
            pass

    class Logger:
        def __init__(self, *a, **k):
            pass

        def log(self, metrics, step):
            logged.append((step, metrics.get("epoch")))

        close = lambda self: None   # noqa: E731

    class Net:
        def __init__(self, *a, **k):
            pass

        def init(self, key, x, train=True):
            return {"params": {}, "batch_stats": {}}

        def apply(self, v, x, train=False):
            return jnp.zeros((x.shape[0], 4)) + x.mean()

    def step_fn(idc, cr, cr_params):
        return lambda state, batch, key: (state, {"loss": 0.0})

    j = jpretrain_idc
    for name, value in dict(
            CheckpointManager=Ckpt, MetricsLogger=Logger, IDCEncoder=Net,
            CoarseRestoration=Net, make_idc_train_step=step_fn,
            load_cr_params=lambda *a: {},
            replicate_global=lambda x, mesh: x,
            shard_batch=lambda x, mesh: x, make_mesh=lambda: None,
            jax=types.SimpleNamespace(jit=lambda f, **k: f,
                                      random=jax.random,
                                      device_get=lambda x: x),
            TrainState=types.SimpleNamespace(
                create=lambda *a, **k: State())).items():
        monkeypatch.setattr(j, name, value)
    j.main(cli_flags(procedural=16, batch_size=4, size=32, num_epochs=2,
                     resume=1))
    epochs = [e for _, e in logged if e is not None]
    assert epochs == [0] * 4 + [1] * 4
    assert logged[-1][0] == 12   # 4 + 8 steps, where two epochs are 8


# -- convergence_demo ----------------------------------------------------------

def _record(calls, name, project):
    """A stand-in for a stage's `main`: records (name, argv) and, for a
    training stage, writes the JSONL rows the demo harvests."""
    def main(argv):
        calls.append((name, list(argv)))
        if name == "test_idc":
            return {"batch_accuracy": 1.0, "sample_accuracy": 1.0}
        if name == "test_refiner":
            return {"psnr": 20.0 + len(calls), "ssim": 0.5}
        flags = dict(zip(argv[::2], argv[1::2]))
        path = f"{flags['--log-dir']}/{project}.{flags['--name']}.jsonl"
        import os

        os.makedirs(flags["--log-dir"], exist_ok=True)
        with open(path, "a") as f:
            for v in (2.0, 1.0):
                f.write(json.dumps(dict(
                    step=0, train_loss=v, val_loss=v, avg_train_loss=v,
                    val_psnr=30.0 / v)) + "\n")
        return None
    return main


def _recorded_demo(monkeypatch, tmp_path, demo, package, argv):
    calls = []
    for name in ("train_vae", "train_cr", "pretrain_idc", "test_idc",
                 "pretrain_denoiser", "train_refiner", "test_refiner"):
        module = getattr(package, name)
        monkeypatch.setattr(module, "main",
                            _record(calls, name, PROJECTS.get(name)))
    tmp_path.mkdir()
    monkeypatch.chdir(tmp_path)
    summary = demo.main(argv)
    return calls, summary


def test_demo_stage_order_and_argv_match_jax(monkeypatch, tmp_path):
    """With every stage's `main` replaced by a recorder in both packages,
    the port's demo runs the JAX demo's stages in its order with its argv,
    each with `--device` appended, and harvests the same summary."""
    import hifidiff_tpu.cli as jcli
    import hifidiff_tpu_torch.cli as pcli

    argv = ["--check", "0", "--n", "32", "--epochs-refiner", "6"]
    jcalls, jsum = _recorded_demo(monkeypatch, tmp_path / "jax", jdemo,
                                  jcli, argv)
    pcalls, psum = _recorded_demo(monkeypatch, tmp_path / "port",
                                  convergence_demo, pcli,
                                  argv + ["--device", "cpu"])
    assert [n for n, _ in pcalls] == [n for n, _ in jcalls]
    assert len(pcalls) == 10
    for (name, p), (_, j) in zip(pcalls, jcalls):
        assert p[-2:] == ["--device", "cpu"], name
        assert p[:-2] == j, name
    assert psum == jsum


def _summary(**changes):
    s = {"vae": {"val_psnr_first": 12.0, "val_psnr_final": 20.5,
                 "train_loss_first": 0.1, "train_loss_final": 0.01},
         "cr": {"train_loss_first": 0.3, "train_loss_final": 0.05,
                "val_loss_first": 0.2, "val_loss_final": 0.1},
         "idc": {"train_loss_first": 0.6, "train_loss_final": 0.1,
                 "val_loss_first": 0.5, "val_loss_final": 0.2,
                 "sample_accuracy": 0.95, "batch_accuracy": 1.0,
                 "sample_accuracy_random_init": 0.7, "hard_family": True},
         "denoiser": {"train_loss_first": 1.0, "train_loss_final": 0.3},
         "refiner": {"train_loss_first": 1.0, "train_loss_final": 0.5},
         "eval": {"random_init": {"psnr": 10.0, "ssim": 0.1},
                  "trained": {"psnr": 14.0, "ssim": 0.4}}}
    for path, value in changes.items():
        stage, key = path.split("__")
        s[stage][key] = value
    return s


FAILING = {
    "vae_no_gain": {"vae__val_psnr_final": 16.5},
    "vae_too_low": {"vae__val_psnr_final": 17.5},
    "cr_no_generalization": {"cr__val_loss_final": 0.3},
    "idc_no_climb": {"idc__sample_accuracy": 0.8},
    "idc_vacuous": {"idc__train_loss_first": 0.01},
    "idc_legacy_low": {"idc__hard_family": False,
                       "idc__sample_accuracy": 0.85},
    "denoiser_flat": {"denoiser__train_loss_final": 1.0},
    "eval_margin": {"eval__trained": {"psnr": 10.5, "ssim": 0.4}},
}


@pytest.mark.parametrize("changes, passes", [
    ({}, True), ({"idc__hard_family": False}, True),
    ({"vae__val_psnr_final": 19.5}, True),
    *((c, False) for c in FAILING.values())],
    ids=["hard", "legacy", "vae_margin", *FAILING])
def test_check_summary_agrees_with_jax(changes, passes):
    """The port's `check_summary` passes and fails where the JAX one does,
    with the same message."""
    s = _summary(**changes)

    def outcome(fn):
        try:
            fn(json.loads(json.dumps(s)))
        except AssertionError as e:
            return str(e)
        return None

    jax_says = outcome(jdemo.check_summary)
    assert outcome(convergence_demo.check_summary) == jax_says
    assert (jax_says is None) == passes


# -- the demo's first two stages, loop for loop (ROADMAP §C) ---------------------

# the demo's narrow widths and its stages' rates and warm-ups; 16 faces at
# batch 8 for two epochs: four steps a stage, an epoch boundary, the val
# pass and a checkpoint after each epoch
LOOP = dict(procedural=16, batch_size=8, size=32, seed=0, num_epochs=2,
            name="t", save_model_epoch=1)
LOOP_VAE = dict(vae_blocks="32,32", vae_layers=1)
LOOP_UNET = dict(width=32, enc_depths="1,1", mid_depth=1, dec_depths="1,1")
LOOP_STAGES = {
    "train_vae": dict(lr=1e-3, warmup_steps=10, save_image_epoch=10),
    "pretrain_denoiser": dict(lr=5e-4, warmup_steps=20, sample_size=1,
                              save_image_epoch=10)}


def _jax_recorded(factory, grads):
    """A JAX step factory whose steps hand the gradients their TrainState
    (`SpyState`) saw to the host, under the CLI's own jit."""
    from test_torch_train import SpyState

    def make(*a, **k):
        inner = factory(*a, **k)

        def step(state, *args):
            state, metrics = inner(state, *args)
            jax.debug.callback(lambda g: grads.append(
                jax.tree_util.tree_map(np.asarray, g)), SpyState.grads)
            return state, metrics
        return step
    return make


def _jax_stage(mp, module, factory, argv):
    """Run a JAX stage CLI with its steps' gradients recorded and the
    arguments of its `adamw_cosine` call kept."""
    from test_torch_train import SpyState

    grads, sched = [], []
    real_tx = module.adamw_cosine
    mp.setattr(module, "TrainState", SpyState)
    mp.setattr(module, factory, _jax_recorded(getattr(module, factory), grads))
    mp.setattr(module, "adamw_cosine",
               lambda *a, **k: sched.append((a, k)) or real_tx(*a, **k))
    module.main(argv)
    jax.effects_barrier()
    return grads, sched[0]


def _port_stage(mp, module, factory, draws, init, argv):
    """Run a port stage CLI fed JAX's draws and initial parameters: its step
    factory's steps get `draws(step)` for the state's step, and `init` (the
    module name, a function of the built module) loads the JAX CLI's first
    parameters. Returns the rates and gradients its optimizer was handed."""
    seen = []
    real_apply = steps.TrainState.apply_gradients

    def spy(self):
        seen.append((self.optimizer.param_groups[0]["lr"],
                     {n: p.grad.detach().clone()
                      for n, p in self.module.named_parameters()
                      if p.grad is not None}))
        real_apply(self)

    real_factory = getattr(module, factory)

    def fed(*a, **k):
        inner = real_factory(*a, **k)

        def step(state, batch, generator=None):
            return inner(state, batch, *draws(state.step))
        return step

    mp.setattr(steps.TrainState, "apply_gradients", spy)
    mp.setattr(module, factory, fed)
    mp.setattr(module, init[0], init[1])
    module.main(argv)
    return seen


def _jax_key(step):
    return jax.random.fold_in(jax.random.PRNGKey(LOOP["seed"]), step)


def _nchw_normal(key, shape_nhwc):
    return torch.from_numpy(np.array(jax.random.normal(
        key, shape_nhwc))).permute(0, 3, 1, 2).contiguous()


def _noise_tensors(port_grads, jax_grads, to_sd):
    """The tensors whose gradients are rounding noise on both sides at some
    step: under 1e-4 of the step's largest gradient, with a sign that
    differs between the packages (so that Adam, which turns a gradient of
    either size into a step of about lr, moves them apart). The biases in
    front of the demo VAE's GroupNorms, one channel a group, have a true
    gradient of zero."""
    noise = set()
    for tg, jg in zip(port_grads, jax_grads):
        jg = to_sd(jg)
        top = max(float(g.abs().max()) for g in tg.values())
        noise |= {n for n, g in tg.items()
                  if max(float(g.abs().max()), float(jg[n].abs().max()))
                  < 1e-4 * top
                  and bool((torch.sign(g) != torch.sign(jg[n])).any())}
    return noise


def test_demo_stages_train_vae_then_pretrain_denoiser_loop_for_loop(
        tmp_path):
    """ROADMAP §C: the demo's first two stages through both packages' CLI
    loops (`train_vae`, then `pretrain_denoiser` on the VAE the stage
    wrote), at the demo's widths, rates and warm-ups, the port started from
    the JAX CLIs' first parameters (their `init` under PRNGKey(seed),
    through convert.py) and fed the draws the JAX steps make from
    `fold_in(PRNGKey(seed), step)`. Equal to 1e-4: the rate fed at each step
    (against optax's schedule of the JAX CLI's own `adamw_cosine` call), each
    step's logged losses and each epoch's val PSNR, and both checkpoints
    the stage writes; the tensors whose gradient is rounding noise on both
    sides (`_noise_tensors`) are left out of the parameters. The loops are
    equal step for step: the demo's gap lies in the draws, not in what the
    CLIs do around the step."""
    from hifidiff_tpu.models import Denoiser as JDenoiser
    from hifidiff_tpu.train.checkpoint import restore_state
    from hifidiff_tpu.vae import AutoencoderKL as JVAE

    flags = {pkg: dict(LOOP, log_dir=tmp_path / pkg / "logs",
                       out_dir=tmp_path / pkg / "img")
             for pkg in ("jax", "port")}
    ck = {pkg: {s: tmp_path / pkg / "ckpt" / s for s in LOOP_STAGES}
          for pkg in flags}
    key = jax.random.PRNGKey(LOOP["seed"])
    jvae = JVAE(block_out=(32, 32), layers_per_block=1)
    vae_init = jax.device_get(jax.jit(jvae.init)(
        key, jnp.zeros((1, 32, 32, 3)))["params"])
    jden = JDenoiser(width=32, enc_nums=(1, 1), mid_num=1, dec_nums=(1, 1))
    den_init = jax.device_get(jax.jit(lambda k: jden.init(
        k, jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,))))(key)["params"])

    def argv(pkg, stage, **more):
        kw = dict(flags[pkg], **LOOP_VAE, **LOOP_STAGES[stage],
                  ckpt_dir=ck[pkg][stage], **more)
        if pkg == "port":
            kw["device"] = "cpu"
        return cli_flags(**kw)

    def vae_draws(step):
        return (_nchw_normal(_jax_key(step), (8, 16, 16, 4)),)

    def den_draws(step):
        k_enc, k_noise, k_t = jax.random.split(_jax_key(step), 3)
        return (_nchw_normal(k_enc, (8, 16, 16, 4)),
                _nchw_normal(k_noise, (8, 16, 16, 4)),
                torch.from_numpy(np.array(jax.random.randint(
                    k_t, (8,), 0, 1000))))

    def load_vae_init(vae):
        vae.load_state_dict(convert.vae_state_dict(vae_init), strict=True)
        return vae

    class Denoiser(pretrain_denoiser.Denoiser):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.load_state_dict(convert.denoiser_state_dict(den_init),
                                 strict=True)

    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        runs["train_vae", "jax"] = _jax_stage(
            mp, jtrain_vae, "make_vae_train_step", argv("jax", "train_vae"))
        runs["pretrain_denoiser", "jax"] = _jax_stage(
            mp, jpretrain_denoiser, "make_denoiser_train_step",
            argv("jax", "pretrain_denoiser", **LOOP_UNET,
                 vae_ckpt=ck["jax"]["train_vae"] / "t"))
    with pytest.MonkeyPatch.context() as mp:
        runs["train_vae", "port"] = _port_stage(
            mp, train_vae, "make_vae_train_step", vae_draws,
            ("flax_default_init_", load_vae_init), argv("port", "train_vae"))
    with pytest.MonkeyPatch.context() as mp:
        runs["pretrain_denoiser", "port"] = _port_stage(
            mp, pretrain_denoiser, "make_denoiser_train_step", den_draws,
            ("Denoiser", Denoiser),
            argv("port", "pretrain_denoiser", **LOOP_UNET,
                 vae_ckpt=ck["port"]["train_vae"] / "t"))

    to_sd = {"train_vae": convert.vae_state_dict,
             "pretrain_denoiser": convert.denoiser_state_dict}
    projects = {"train_vae": "hifi_vae", "pretrain_denoiser": "hifi_denoiser"}
    for stage in LOOP_STAGES:
        jgrads, (args, kwargs) = runs[stage, "jax"]
        seen = runs[stage, "port"]
        assert len(seen) == len(jgrads) == 4, stage
        np.testing.assert_allclose([lr for lr, _ in seen],
                                   _optax_lrs(*args, n=4), rtol=1e-4,
                                   atol=1e-10, err_msg=stage)
        rows = {pkg: _rows(tmp_path / pkg / "logs", projects[stage])
                for pkg in flags}
        for jrow, trow in zip(*(rows[p] for p in ("jax", "port")),
                              strict=True):
            assert set(jrow) == set(trow), stage
            for k in set(jrow) - {"time", "step_time"}:
                np.testing.assert_allclose(trow[k], jrow[k], rtol=1e-4,
                                           atol=1e-6, err_msg=(stage, k))
        noise = _noise_tensors([g for _, g in seen], jgrads, to_sd[stage])
        assert len(noise) <= len(seen[0][1]) / 4, (stage, sorted(noise))
        mgr = checkpoint.CheckpointManager(str(ck["port"][stage] / "t"),
                                           create=False)
        assert mgr.steps() == [2, 4], stage
        for step in mgr.steps():
            want = to_sd[stage](restore_state(
                str(ck["jax"][stage] / "t"), step)["state"]["params"])
            got = torch.load(mgr.path(step), weights_only=True)["state"][
                "module"]
            assert set(got) == set(want), stage
            for n, v in got.items():
                if n not in noise:
                    np.testing.assert_allclose(
                        v.numpy(), want[n].numpy(), rtol=0, atol=1e-4,
                        err_msg=(stage, step, n))
