"""What the two refiner-training comparisons of tests/test_torch_distill.py
read at other initial weights, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/distill_init_probe.py KIND SEED MODE

KIND is `distill` (`test_distill_step_vs_jax`) or `tiny_dn`
(`test_tiny_dn_step_vs_jax`); SEED is `torch.manual_seed` before the test's
modules are drawn (the test pins 0); MODE is

  * `none`: the test's three steps as they run;
  * `noise`: before each step the tensors whose gradients are rounding
    noise on both sides (the test's `left_out`: biases in front of a
    BatchNorm, whose true gradient is zero) are set to the JAX state's;
  * `all`: before each step every tensor of the student is set to the JAX
    state's, and the port's step is also taken in float64 from there.

Prints each gradient over half STEP_GRAD_REL from the JAX one and each
BatchNorm statistic over half STATS_REL from it, with, in `all`, the port's
and the JAX float32 values' distances from the float64 port step.
"""

from __future__ import annotations

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_distill as T  # noqa: E402
from test_torch_train import (GRAD_FLOOR, STATS_REL, STEP_GRAD_REL,  # noqa
                              _only_noise, rel_err)
from hifidiff_tpu_torch.models.refiner import FacialRefiner  # noqa: E402


def setup(kind):
    """(student, its JAX variables, the JAX step, the port's step on (cr,
    vae), the test's numpy generator, its first key, the draws of a key)."""
    (cr, vae, teacher), frozen, rv = T._stack(0 if kind == "distill" else 1)
    if kind == "distill":
        student, sv = copy.deepcopy(teacher), rv
        jstep = jax.jit(lambda s, t, f, b, k: T._jit_step(
            T.jdistill.make_distill_train_step(
                T.JRefiner(**T.REF), T.JCR(**T.CR), T.JVAE(**T.VAE),
                T.J_SCHEDULE, T.N_STUDENT, substeps=2, clip_sample=True,
                clip_sample_range=3.0), s, t, f, b, k))

        def port_step(c, v):
            return T.tdistill.make_distill_train_step(
                c, v, T.N_STUDENT, substeps=2, clip_sample=True,
                clip_sample_range=3.0, device="cpu")

        def draws(key):
            k1, k2, k3, k4 = jax.random.split(key, 4)
            idx = jax.random.randint(k3, (T.B,), 0, T.N_STUDENT)
            return [T._draw_nchw(k1, T.LAT), T._draw_nchw(k2, T.LAT),
                    torch.from_numpy(np.array(idx)), T._draw_nchw(k4, T.LAT)]
        rng, key0 = np.random.default_rng(20), 60
    else:
        student = FacialRefiner(**T.STUDENT)
        sv = T.jax_weights(student, T._refiner_import,
                           T.convert.refiner_state_dict, seed=12)
        jstep = jax.jit(lambda s, t, f, b, k: T._jit_step(
            T.jdistill.make_tiny_dn_train_step(
                T.JRefiner(**T.REF), T.JRefiner(**T.STUDENT), T.JCR(**T.CR),
                T.JVAE(**T.VAE), T.J_SCHEDULE, rollout_steps=2,
                fwd_weight=0.5), s, t, f, b, k))

        def port_step(c, v):
            return T.tdistill.make_tiny_dn_train_step(
                c, v, rollout_steps=2, fwd_weight=0.5, device="cpu")

        def draws(key):
            k1, k2, k3, k4, k5 = jax.random.split(key, 5)
            return [T._draw_nchw(k1, T.LAT), T._draw_nchw(k2, T.LAT),
                    T._draw_nchw(k3, T.LAT), T._draw_t(k4, T.B),
                    T._draw_nchw(k5, T.LAT)]
        rng, key0 = np.random.default_rng(21), 70
    return (cr, vae, teacher, frozen, rv, student, sv, jstep, port_step,
            rng, key0, draws)


def main(kind, seed, mode):
    torch.set_num_threads(1)
    torch.manual_seed(seed)
    (cr, vae, teacher, frozen, rv, student, sv, jstep, port_step, rng, key0,
     draws) = setup(kind)
    jstate = T.SpyState.create(sv["params"],
                               T.joptim.adamw_cosine(1e-4, 1, 100),
                               batch_stats=sv["batch_stats"])
    tstate = T.steps_state(student)
    tgrads = T._spy(tstate)
    tstep = port_step(cr, vae)
    left_out = set()

    def float64_step(start, batch, d):
        s = copy.deepcopy(start).double()
        st = T.steps_state(s)
        grads = T._spy(st)
        port_step(copy.deepcopy(cr).double(), copy.deepcopy(vae).double())(
            st, copy.deepcopy(teacher).double(),
            {k: v.double() for k, v in batch.items()},
            *[x.double() if x.is_floating_point() else x for x in d])
        return grads, s.state_dict()

    for i in range(3):
        lr_img, gt = T._lr_gt(rng)
        key = jax.random.PRNGKey(key0 + i)
        if mode != "none":
            before = T._refiner_sd(jstate.params, jstate.batch_stats)
            with torch.no_grad():
                for n, p in tstate.module.state_dict().items():
                    if mode == "all" or n in left_out:
                        p.copy_(before[n])
        start = copy.deepcopy(tstate.module)
        jstate, _, jg = jstep(jstate, rv, frozen, {"lr": lr_img, "gt": gt},
                              key)
        batch, d = {"lr": T.nchw(lr_img), "gt": T.nchw(gt)}, draws(key)
        tstep(tstate, teacher, batch, *d)
        jgrads = T._refiner_sd(jg, jstate.batch_stats)
        want = T._refiner_sd(jstate.params, jstate.batch_stats)
        top = max(float(g.abs().max()) for g in tgrads.values())
        if mode == "all":
            g64, s64 = float64_step(start, batch, d)
            top64 = max(float(g.abs().max()) for g in g64.values())
        for name, g in tgrads.items():
            if _only_noise(g, jgrads[name], top):
                left_out.add(name)
                continue
            err = rel_err(g.numpy(), jgrads[name].numpy(), GRAD_FLOOR * top)
            if err > STEP_GRAD_REL / 2:
                extra = "" if mode != "all" else (
                    f"; port vs float64 "
                    f"{rel_err(g, g64[name].float(), GRAD_FLOOR * top64):.2e}"
                    f", JAX vs float64 {rel_err(jgrads[name], g64[name].float(), GRAD_FLOOR * top64):.2e}")  # noqa: E501
                print(f"{kind} seed {seed} {mode}: step {i} grad {name}: "
                      f"port vs JAX {err:.2e}{extra}", flush=True)
        for name, p in tstate.module.state_dict().items():
            if name.endswith(("running_mean", "running_var")):
                err = rel_err(p.numpy(), want[name].numpy())
                if err > STATS_REL / 2:
                    extra = "" if mode != "all" else (
                        f"; port vs float64 "
                        f"{rel_err(p, s64[name].float()):.2e}, JAX vs "
                        f"float64 {rel_err(want[name], s64[name].float()):.2e}")
                    print(f"{kind} seed {seed} {mode}: step {i} {name}: "
                          f"port vs JAX {err:.2e}{extra}", flush=True)
    print(f"{kind} seed {seed} {mode}: done, {len(left_out)} tensors "
          f"left out as noise", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
