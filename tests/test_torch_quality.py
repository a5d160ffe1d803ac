"""The port's quality scripts (`hifidiff_tpu_torch/scripts/`) against the JAX
package's (`scripts/*.py`, imported by path and left as they are).

* `cache_quality`: both scripts on the same random narrow stack (drawn in the
  port, saved as the port's stage files, the JAX trees made from it by the
  JAX package's importers and handed to the JAX script through its
  `restore_state`) and the same draws (the normals JAX's `PRNGKey(seed)`
  gives, handed to the port's `draws`). The faces of every row to the
  limits tests/test_torch_pipeline_paths.py holds the same paths to (1e-4
  of the values' scale, float32 sums in another order); the records' keys
  equal, every PSNR within 0.01 dB and every SSIM within 1e-4 (both round
  to 2 and 4 places: one rounding step apart at most). Control: the
  interval row sampled from fresh draws is further than 0.01 dB from the
  JAX script's drift.
* `dump_sampler_latents` against the JAX function on the same weights and
  the same per-batch draws (`fold_in(key, i)`), to the same latent limits;
  control: every batch given batch 0's draws fails them.
* The six training scripts: with every CLI `main` they call replaced by a
  recorder in both packages, the port runs the JAX script's calls in its
  order with its argv (paths under `runs/torch_<name>/` read as
  `runs/<name>/`), `--device` appended, and builds the same record from the
  same rows.
* One real chain on the CPU: the seven scripts at cut lengths on a saved
  random narrow stack, in the order each needs the last; every figure
  finite.

The JAX scripts point JAX's persistent compilation cache at the repo when
imported; the fixture points it into the test's temporary directory, with a
least compile time that keeps anything from being written, and puts the old
settings back afterwards."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from hifidiff_tpu_torch.scripts import (cache_quality, distill_quality,
                                        idc_hard_demo, tae_quality,
                                        tiny_cr_quality, tiny_dn_quality,
                                        turbo_quality)
from torch_parity import write_tiny_checkpoints

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent

FACE_TOL = 1e-4        # of the values' scale (test_torch_pipeline_paths)
PSNR_TOL = 0.01
SSIM_TOL = 1e-4
# the stack the comparisons run: cache_quality's width for CR and refiner,
# latents 8x8 from a three-level VAE
NARROW = dict(size=32, width=8, enc_depths="1,1", mid_depth=1,
              dec_depths="1,1", idc_stages="1,1,1,1", cr_width=8,
              cr_enc_depths="1,1", cr_mid_depth=1, vae_blocks="32,32,32",
              vae_layers=1, seed=0)
NAME = "convdemo"


@pytest.fixture(scope="module")
def jax_scripts(tmp_path_factory):
    """The JAX package's scripts as modules, imported by path, with JAX's
    persistent compilation cache pointed into a temporary directory."""
    import jax

    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    cache = tmp_path_factory.mktemp("jax_cache")
    mods = {}
    try:
        for name in ("cache_quality", "tae_quality", "tiny_cr_quality",
                     "tiny_dn_quality", "distill_quality", "turbo_quality",
                     "idc_hard_demo"):
            spec = importlib.util.spec_from_file_location(
                f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
            mods[name] = sys.modules[spec.name] = \
                importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
            jax.config.update("jax_compilation_cache_dir", str(cache))
        # and nothing written to it: no compile here takes this long
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          1e9)
        yield mods
    finally:
        for name in mods:
            sys.modules.pop(f"jax_script_{name}", None)
        jax.config.update("jax_compilation_cache_dir", old[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old[1])


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """A random narrow stack saved as the port's stage files under
    `<root>/{cr,vae,refiner}/convdemo/`, and its JAX trees."""
    root = tmp_path_factory.mktemp("stack")
    paths, trees, _ = write_tiny_checkpoints(
        root, types.SimpleNamespace(**NARROW))
    for stage, path in paths.items():
        d = root / "ckpt" / stage / NAME
        d.mkdir(parents=True)
        os.replace(path, d / "step_00000001.pt")
    return str(root / "ckpt"), trees


def _jax_draws(key, shape):
    """The normals the JAX split sampler draws from `key`: the initial
    latents from `k_lat`, the posterior's noise from `k_enc`."""
    import jax

    k_lat, k_enc = jax.random.split(key)
    return {"latents_noise": torch.from_numpy(np.array(
                jax.random.normal(k_lat, shape))),
            "posterior_noise": torch.from_numpy(np.array(
                jax.random.normal(k_enc, shape, np.float32)))}


# -- cache_quality ---------------------------------------------------------

CACHE_ARGS = ["--width", "8", "--vae-blocks", "32,32,32", "--procedural",
              "16", "--batch-size", "2", "--steps", "3", "--intervals", "2",
              "--dpmpp-steps", "2", "--combos", "2:2"]


def _close_rows(port, jax_rec):
    """Every PSNR of the two records within PSNR_TOL, every SSIM within
    SSIM_TOL; returns the largest differences."""
    worst = {"psnr": 0.0, "ssim": 0.0}
    for key, j in jax_rec.items():
        p = port[key]
        if isinstance(j, dict):
            sub = _close_rows(p, j)
            worst = {k: max(worst[k], sub[k]) for k in worst}
        elif isinstance(j, float):
            kind = "ssim" if "ssim" in key else "psnr"
            worst[kind] = max(worst[kind], abs(p - j))
        else:
            assert p == j, key
    return worst


def test_cache_quality_against_jax(jax_scripts, stack, monkeypatch,
                                   tmp_path):
    import jax

    jcache = jax_scripts["cache_quality"]
    root, trees = stack
    monkeypatch.chdir(tmp_path)

    def restore(path):
        stage = os.path.basename(os.path.dirname(path))
        if stage == "refiner":
            return {"state": trees["refiner"]}
        return {"state": {"params": trees[stage]}}

    j_faces = []

    def spy(*a, **k):
        fn = real(*a, **k)

        def call(*args):
            out = fn(*args)
            j_faces.append(np.asarray(out, np.float32))
            return out
        return call

    real = jcache.build_refiner_sampler_split
    monkeypatch.setattr(jcache, "restore_state", restore)
    monkeypatch.setattr(jcache, "build_refiner_sampler_split", spy)
    j_rec = jcache.main(CACHE_ARGS + ["--ckpt-root", root,
                                      "--platform", ""])

    runs = {}
    real_eval = cache_quality.evaluate

    def kept(cfg, device):
        result, r = real_eval(cfg, device)
        runs.update(r)
        return result, r

    monkeypatch.setattr(cache_quality, "draws", lambda cfg, b, lat, dev:
                        _jax_draws(jax.random.PRNGKey(cfg.seed),
                                   (b, lat, lat, 4)))
    monkeypatch.setattr(cache_quality, "evaluate", kept)
    out = tmp_path / "CACHE_QUALITY_TORCH.json"
    p_rec = cache_quality.main(CACHE_ARGS + ["--ckpt-root", root,
                                             "--device", "cpu",
                                             "--out", str(out)])
    assert json.loads(out.read_text()) == p_rec
    assert p_rec["run"]["device"] == "cpu" and p_rec["run"]["card"] is None

    # the faces of every row, in the JAX script's order
    labels = ["exact"] + [f"{s}/{k}" for s, k, _ in cache_quality.rows(
        cache_quality.parse_config(cache_quality.Config, CACHE_ARGS))]
    assert len(j_faces) == len(labels)
    for label, jf in zip(labels, j_faces):
        pf = runs[label][1]
        assert pf.shape == jf.shape == (2, 32, 32, 3), label
        err = float(np.abs(pf - jf).max())
        assert err <= FACE_TOL, (label, err)

    # the records
    rec = {k: v for k, v in p_rec.items() if k != "run"}
    assert rec.keys() == j_rec.keys()
    for section in ("intervals", "dpmpp", "combos"):
        assert rec[section].keys() == j_rec[section].keys()
        for key in rec[section]:
            assert rec[section][key].keys() == j_rec[section][key].keys()
    worst = _close_rows(rec, j_rec)
    assert worst["psnr"] <= PSNR_TOL + 1e-9, worst
    assert worst["ssim"] <= SSIM_TOL + 1e-9, worst

    # control: the interval row from fresh draws moves the drift past the
    # limit
    cfg = cache_quality.parse_config(cache_quality.Config, CACHE_ARGS)
    fresh = cache_quality.sample(
        runs["stack"], cfg, runs["batch"]["lr"],
        _jax_draws(jax.random.PRNGKey(1), (2, 8, 8, 4)), "cpu",
        cache_interval=2)[1]
    drift = cache_quality.drift_psnr(fresh, runs["exact"][1])
    assert abs(drift - j_rec["intervals"]["2"]["drift_psnr"]) > PSNR_TOL


# -- dump_sampler_latents --------------------------------------------------

def _eval_flags(root):
    flags = [a for k, v in NARROW.items()
             for a in (f"--{k.replace('_', '-')}", str(v))]
    return flags + ["--procedural", "8", "--batch-size", "4",
                    "--refiner-ckpt", f"{root}/refiner/{NAME}",
                    "--cr-ckpt", f"{root}/cr/{NAME}",
                    "--vae-ckpt", f"{root}/vae/{NAME}", "--grid-every", "0"]


@pytest.fixture(scope="module")
def jax_latents(jax_scripts, stack, tmp_path_factory):
    """The JAX script's `dump_sampler_latents` on the stack's trees: its
    `z` at 2 and 1 steps over the 8 train faces (two batches)."""
    from hifidiff_tpu.cli import common as jcommon

    root, trees = stack
    real = jcommon.load_refiner_stack

    def load(cfg, key, models=None):
        cr, vae, refiner, schedule, latent = jcommon.build_refiner_models(
            cfg)
        return cr, vae, refiner, schedule, trees, latent

    out = tmp_path_factory.mktemp("jax_dump") / "z.npz"
    jcommon.load_refiner_stack = load
    try:
        jax_scripts["tae_quality"].dump_sampler_latents(
            _eval_flags(root), [2, 1], str(out))
    finally:
        jcommon.load_refiner_stack = real
    return np.load(out)["z"]


def _port_latents(root, tmp_path, same_draws_every_batch=False):
    import jax

    def draws(seed, index, shape, device):
        key = jax.random.PRNGKey(seed)
        return _jax_draws(jax.random.fold_in(
            key, 0 if same_draws_every_batch else index), shape)

    mp = pytest.MonkeyPatch()
    mp.setattr(tae_quality, "batch_draws", draws)
    try:
        out = str(tmp_path / "z.npz")
        tae_quality.dump_sampler_latents(
            _eval_flags(root) + ["--device", "cpu"], [2, 1], out)
    finally:
        mp.undo()
    return np.load(out)["z"]


@pytest.mark.parametrize("control", [False, True],
                         ids=["fold_in", "control_batch0_draws"])
def test_dump_sampler_latents_against_jax(stack, jax_latents, tmp_path,
                                          control):
    root, _ = stack
    z = _port_latents(root, tmp_path, same_draws_every_batch=control)
    assert z.shape == jax_latents.shape == (16, 8, 8, 4)
    scale = max(1.0, float(np.abs(jax_latents).max()))
    err = float(np.abs(z - jax_latents).max()) / scale
    assert (err > FACE_TOL) if control else (err <= FACE_TOL), err


# -- the six training scripts' CLI calls -----------------------------------

def _normalize(argv):
    return [a.replace("runs/torch_", "runs/") if isinstance(a, str) else a
            for a in argv]


def _recorders(calls, package):
    """(module, name, stand-in) of every `main` the scripts call, in
    `package` ("hifidiff_tpu" or "hifidiff_tpu_torch"): each records its
    argv and returns rows shaped as the JAX records'."""
    def ret(name, argv):
        n = len(calls)
        if name == "test_refiner":
            return {"psnr": 15.0 + n / 8, "ssim": 0.5 + n / 64}
        if name == "test_idc":   # random-init, then trained: the checks hold
            trained = any(c == "test_idc" for c, _ in calls[:-1])
            return {"batch_accuracy": 1.0,
                    "sample_accuracy": 0.95 if trained else 0.6}
        if name == "distill":
            return {"teacher_steps": 50, "exact_gt_psnr": 19.5 + n,
                    "rounds": [{"round": 0, "student_steps": 10,
                                "distilled_gt_psnr": 15.0 + n}]}
        if name == "pretrain_idc":
            flags = dict(zip(argv[::2], argv[1::2]))
            os.makedirs(flags["--log-dir"], exist_ok=True)
            with open(os.path.join(flags["--log-dir"], "hifi_idc."
                                   f"{flags['--name']}.jsonl"), "a") as f:
                for v in (1.5, 0.4):
                    f.write(json.dumps({"step": 0, "train_loss": v,
                                        "val_loss": v * 0.9}) + "\n")
        return None

    def stand_in(name):
        def main(argv):
            calls.append((name, list(argv)))
            return ret(name, argv)
        return main

    out = []
    for name in ("train_tae", "test_refiner", "train_tiny_cr",
                 "train_tiny_dn", "distill", "train_cr", "pretrain_idc",
                 "test_idc"):
        module = importlib.import_module(f"{package}.cli.{name}")
        out.append((module, "main", stand_in(name)))
    return out


PORT_MODULES = {"cache_quality": cache_quality, "tae_quality": tae_quality,
                "tiny_cr_quality": tiny_cr_quality,
                "tiny_dn_quality": tiny_dn_quality,
                "distill_quality": distill_quality,
                "turbo_quality": turbo_quality,
                "idc_hard_demo": idc_hard_demo}
TRAINING_SCRIPTS = [n for n in PORT_MODULES if n != "cache_quality"]
# flags beside the defaults: the tiny denoiser's rows with the tiny CR too
EXTRA_ARGV = {"tiny_dn_quality": ["--tiny-cr-ckpt",
                                  "runs/tiny_cr_quality/ckpt/convdemo"]}


def _recorded(monkeypatch, where, script, package, argv, module):
    calls = []
    for mod, attr, fn in _recorders(calls, package):
        monkeypatch.setattr(mod, attr, fn)
    if hasattr(module, "dump_sampler_latents"):
        monkeypatch.setattr(
            module, "dump_sampler_latents",
            lambda flags, steps, npz: calls.append(
                ("dump_sampler_latents", list(flags) + [steps, npz])))
    where.mkdir()
    monkeypatch.chdir(where)
    out = where / "record.json"
    module.main(argv + ["--out", str(out)])
    return calls, json.loads(out.read_text())


@pytest.mark.parametrize("script", TRAINING_SCRIPTS)
def test_training_script_calls_match_jax(jax_scripts, monkeypatch, tmp_path,
                                         script):
    """The port's script calls the JAX script's CLI `main`s in its order
    with its argv, each with `--device` appended, and makes the JAX
    record (plus "run") from the same rows."""
    argv = EXTRA_ARGV.get(script, [])
    jcalls, jrec = _recorded(monkeypatch, tmp_path / "jax", script,
                             "hifidiff_tpu", argv, jax_scripts[script])
    port_argv = [a.replace("runs/", "runs/torch_") for a in argv]
    pcalls, prec = _recorded(monkeypatch, tmp_path / "port", script,
                             "hifidiff_tpu_torch", port_argv + [
                                 "--device", "cpu"],
                             PORT_MODULES[script])
    assert [n for n, _ in pcalls] == [n for n, _ in jcalls]
    assert pcalls
    for (name, p), (_, j) in zip(pcalls, jcalls):
        if name == "dump_sampler_latents":   # (flags, steps, npz)
            assert p[-4:-2] == ["--device", "cpu"], name
            assert _normalize(p[:-4] + p[-2:]) == j, name
            continue
        assert p[-2:] == ["--device", "cpu"], name
        assert _normalize(p[:-2]) == j, name

    run = prec.pop("run")
    assert run["device"] == "cpu" and run["argv"][-4:-2] == ["--device",
                                                            "cpu"]
    if script == "idc_hard_demo":
        # the port's description names no figure of another run
        assert prec.pop("description") and jrec.pop("description")
    assert prec == jrec


# -- one real chain on the CPU ---------------------------------------------

def _figures(rec):
    for k, v in rec.items():
        if k == "run":
            continue
        if isinstance(v, dict):
            yield from _figures(v)
        elif isinstance(v, list):
            for item in v:
                if isinstance(item, dict):
                    yield from _figures(item)
        elif isinstance(v, float):
            yield k, v


def test_seven_scripts_chained_on_the_cpu(monkeypatch, tmp_path):
    """The seven scripts at cut lengths on a saved random stack of the
    demo's narrow architecture (what the scripts' CLI calls build), each
    reading what the one before wrote: every figure of every record
    finite, every record written."""
    from hifidiff_tpu_torch.cli import test_refiner
    from hifidiff_tpu_torch.cli.common import build_refiner_models
    from hifidiff_tpu_torch.random_weights import perturb_

    monkeypatch.chdir(tmp_path)
    cfg = test_refiner.Config(size=32, width=32, enc_depths="1,1",
                              mid_depth=1, dec_depths="1,1",
                              idc_stages="1,1,1,1", cr_width=32,
                              cr_enc_depths="1,1", cr_mid_depth=1,
                              vae_blocks="32,32", vae_layers=1)
    for i, (stage, m) in enumerate(zip(("cr", "vae", "refiner"),
                                       build_refiner_models(cfg)[:3])):
        perturb_(m, torch.Generator().manual_seed(i + 1))
        d = tmp_path / "runs" / "convergence" / "ckpt" / stage / NAME
        d.mkdir(parents=True)
        torch.save(m.state_dict(), d / "step_00000001.pt")

    cpu = ["--device", "cpu"]
    data = ["--procedural", "16", "--batch-size", "4"]
    chain = [
        (cache_quality, data + ["--steps", "3", "--intervals", "2",
                                "--dpmpp-steps", "2", "--combos", "2:2"]),
        (tae_quality, data + ["--tae-epochs", "1", "--steps", "3,2",
                              "--dpmpp-steps", "2"]),
        (tiny_cr_quality, data + ["--epochs", "1"]),
        (tiny_dn_quality, data + [
            "--epochs", "1", "--rollout-steps", "2", "--tiny-cr-ckpt",
            "runs/torch_tiny_cr_quality/ckpt/convdemo"]),
        (distill_quality, ["--procedural", "16", "--batch-size", "4",
                           "--eval-batch", "4", "--teacher-steps", "4",
                           "--student-steps", "2,1",
                           "--steps-per-round", "1"]),
        (turbo_quality, data + ["--students", "2:round0_s2,1:round1_s1"]),
        (idc_hard_demo, ["--n", "32", "--batch-size", "8", "--epochs-cr",
                         "2", "--epochs-idc", "1", "--check", "0"])]
    for module, argv in chain:
        name = module.__name__.rsplit(".", 1)[1]
        out = tmp_path / f"{name}.json"
        rec = module.main(argv + cpu + ["--out", str(out)])
        assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
        figures = list(_figures(rec))
        assert len(figures) >= 4, name
        bad = [(k, v) for k, v in figures if not math.isfinite(v)]
        assert not bad, (name, bad)
        assert rec["run"]["device"] == "cpu" and rec["run"]["wall_s"] > 0


@pytest.mark.parametrize("name", list(PORT_MODULES))
def test_config_keeps_the_jax_fields(jax_scripts, name):
    """Each script's Config is the JAX script's field for field, in its
    order and with its defaults, but for `platform` (now `device`, the card
    by default), `out` (a new `*_TORCH.json` record at the repo root) and
    the run directories (under `runs/torch_<name>/`)."""
    module = PORT_MODULES[name]
    j = {f.name: f.default
         for f in dataclasses.fields(jax_scripts[name].Config)}
    p = {f.name: f.default for f in dataclasses.fields(module.Config)}
    assert j.pop("platform") in ("", "cpu")
    assert p.pop("device") == "cuda"
    record = os.path.basename(j.pop("out", "CACHE_QUALITY.json"))
    assert p.pop("out") == str(REPO / record.replace(".json", "_TORCH.json"))
    assert list(p) == list(j)
    assert {k: _normalize([v])[0] for k, v in p.items()} == j
