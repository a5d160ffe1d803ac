"""Port modules against their JAX counterparts on perturbed weights (float32,
CPU, narrow widths): NAFBlock, ConditionalNAFBlock, STNBlock, HCA, ResNet-50,
CR, FPG and the FusedDenoiser in full, precompute+films and encode / decode
modes. Weights:
port init -> perturb -> JAX importers, and back through convert.py under a
strict load (torch_parity.jax_weights)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifidiff_tpu.models import CoarseRestoration as JCR
from hifidiff_tpu.models.denoiser import FusedDenoiser as JDen
from hifidiff_tpu.models.fpg import FacialPriorGuidance as JFPG
from hifidiff_tpu.nn.hca import HybridCrossAttention as JHCA
from hifidiff_tpu.nn.naf import ConditionalNAFBlock as JCNAF
from hifidiff_tpu.nn.naf import NAFBlock as JNAF
from hifidiff_tpu.nn.resnet import ResNet50 as JResNet
from hifidiff_tpu.nn.stn import STNBlock as JSTN
from hifidiff_tpu.utils import torch_import as ti
from hifidiff_tpu_torch import convert
from hifidiff_tpu_torch.models.cr import CoarseRestoration
from hifidiff_tpu_torch.models.denoiser import FusedDenoiser
from hifidiff_tpu_torch.models.fpg import FacialPriorGuidance
from hifidiff_tpu_torch.nn.hca import HybridCrossAttention
from hifidiff_tpu_torch.nn.naf import ConditionalNAFBlock, NAFBlock
from hifidiff_tpu_torch.nn.resnet import ResNet50
from hifidiff_tpu_torch.nn.stn import STNBlock
from torch_parity import jax_weights, nchw, nhwc, normal

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def seeded_init():
    """Module inits draw from torch's global generator: seed it, so that a
    test's weights do not depend on which tests ran before it in the
    worker (a 3-unit STN hidden layer can come out all zero after ReLU,
    which makes the warp the identity)."""
    torch.manual_seed(0)


def close(actual, expected, rel):
    """|actual - expected| <= rel * max|expected|, elementwise: float32 on
    both sides, differing in summation order inside convs and matmuls, so
    the error scales with the magnitude of the values in flight."""
    expected = np.asarray(expected, np.float32)
    scale = max(1.0, float(np.abs(expected).max()))
    np.testing.assert_allclose(np.asarray(actual, np.float32), expected,
                               rtol=0, atol=rel * scale)


def test_naf_block():
    x = normal(np.random.default_rng(0), 2, 8, 8, 16)
    blk = NAFBlock(16)
    p = jax_weights(blk, lambda sd: ti.naf_block_params(sd, ""),
                    convert.naf_block_state_dict)
    ref = JNAF(16).apply({"params": p}, x)
    with torch.inference_mode():
        close(nhwc(blk(nchw(x))), ref, 1e-5)


@pytest.mark.parametrize("hoisted", [False, True])
def test_conditional_naf_block(hoisted):
    """Per-sample t through the block's own projection, or a hoisted
    batch-1 film shared across the batch."""
    rng = np.random.default_rng(1)
    x, t = normal(rng, 3, 4, 4, 32), normal(rng, 3, 64)
    blk = ConditionalNAFBlock(32, 64)
    jp = {"params": jax_weights(
        blk, lambda sd: ti.conditional_naf_block_params(sd, ""),
        convert.naf_block_state_dict)}
    with torch.inference_mode():
        if hoisted:
            film = JCNAF(32, 64).apply(jp, None, t[:1])
            ref = JCNAF(32, 64).apply(jp, x, film=film)
            film_t = blk(None, torch.from_numpy(t[:1]))
            close(film_t.numpy(), film, 1e-5)
            out = blk(nchw(x), film=film_t)
        else:
            ref = JCNAF(32, 64).apply(jp, x, t)
            out = blk(nchw(x), torch.from_numpy(t))
        close(nhwc(out), ref, 1e-5)


@pytest.mark.parametrize("res", [8, 16, 32])
def test_stn_block_warps(res):
    """Perturbed fc_loc.2 makes the warp non-trivial; the port must match,
    and differ from its input."""
    x = normal(np.random.default_rng(res), 2, res, res, 8)
    stn = STNBlock(8, res)
    p = jax_weights(stn, lambda sd: ti.stn_block_params(sd, ""),
                    convert.stn_state_dict, seed=res)
    ref = jax.jit(JSTN(8, res).apply)({"params": p}, x)
    with torch.inference_mode():
        out = nhwc(stn(nchw(x)))
    close(out, ref, 1e-5)
    assert np.abs(out - x).max() > 1e-3


def test_hca():
    rng = np.random.default_rng(2)
    f_g, f_d = normal(rng, 2, 4, 4, 32), normal(rng, 2, 4, 4, 32)
    hca = HybridCrossAttention(32)
    jp, js = jax_weights(hca, lambda sd: ti.hca_params(sd, ""),
                         convert.hca_state_dict)
    jv = {"params": jp, "batch_stats": js}
    ref = JHCA(32).apply(jv, f_g, f_d, train=False)
    w_c, w_s = JHCA(32).apply(jv, f_g, None, train=False)
    with torch.inference_mode():
        gates = hca.gates(nchw(f_g))
        close(nhwc(hca(nchw(f_g), nchw(f_d))), ref, 1e-5)
        close(nhwc(hca(nchw(f_g), nchw(f_d), gates)), ref, 1e-5)
    close(gates[0].flatten(1).numpy(), np.asarray(w_c).reshape(2, -1), 1e-5)
    close(nhwc(gates[1]), w_s, 1e-5)


def test_resnet50():
    x = np.random.default_rng(3).uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    stages = (1, 1, 1, 1)
    net = ResNet50(stages)
    jp, js = jax_weights(net, lambda sd: ti.resnet50_params(sd, stages),
                         convert.resnet50_state_dict)
    ref = jax.jit(lambda v, x: JResNet(stages).apply(v, x, train=False))(
        {"params": jp, "batch_stats": js}, x)
    with torch.inference_mode():
        out = net(nchw(x))
    assert out.shape == (2, 2048)
    close(out.numpy(), ref, 1e-4)


TINY_CR = dict(width=8, resolution=32, enc_nums=(1, 1), mid_num=1,
               dec_nums=(1, 1))


def test_cr():
    x = np.random.default_rng(4).uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    cr = CoarseRestoration(**TINY_CR)
    jp = jax_weights(cr, lambda sd: ti.cr_params(sd, (1, 1), 1, (1, 1)),
                     convert.cr_state_dict)
    ref = jax.jit(JCR(**TINY_CR).apply)({"params": jp}, x)
    with torch.inference_mode():
        close(nhwc(cr(nchw(x))), ref, 1e-4)


def test_fpg():
    z = normal(np.random.default_rng(5), 2, 8, 8, 4)
    fpg = FacialPriorGuidance(width=16, enc_nums=(1, 1))
    p = jax_weights(fpg, lambda sd: ti.fpg_params(sd, (1, 1)),
                    convert.fpg_state_dict)
    refs = JFPG(width=16, enc_nums=(1, 1)).apply({"params": p}, z)
    with torch.inference_mode():
        outs = fpg(nchw(z))
    assert [o.shape[1] for o in outs] == [64, 32, 16]
    for o, r in zip(outs, refs):
        close(nhwc(o), r, 1e-4)


DEN = dict(width=16, latent_size=8, enc_nums=(1, 1), mid_num=1,
           dec_nums=(1, 1))


@pytest.fixture(scope="module")
def denoisers():
    rng = np.random.default_rng(6)
    x = normal(rng, 2, 8, 8, 4)
    t = np.asarray([999.0, 500.0], np.float32)
    priors = [normal(rng, 2, 2, 2, 64), normal(rng, 2, 4, 4, 32),
              normal(rng, 2, 8, 8, 16)]
    emb = normal(rng, 2, 2048)
    den = FusedDenoiser(**DEN)
    jp, js = jax_weights(
        den, lambda sd: ti.fused_denoiser_params(sd, (1, 1), 1, (1, 1)),
        convert.fused_denoiser_state_dict)
    return (den, {"params": jp, "batch_stats": js}, x, t, priors, emb)


def test_fused_denoiser_full(denoisers):
    den, jv, x, t, priors, emb = denoisers
    ref = jax.jit(lambda *a: JDen(**DEN).apply(*a, train=False))(
        jv, x, t, priors, emb)
    with torch.inference_mode():
        out = den(nchw(x), torch.from_numpy(t), [nchw(p) for p in priors],
                  torch.from_numpy(emb))
    close(nhwc(out), ref, 1e-4)


def test_fused_denoiser_precompute_and_films(denoisers):
    """precompute's tables match JAX's, and a step fed the hoisted batch-1
    films, identity injection and gates matches JAX's hoisted step."""
    den, jv, x, t, priors, emb = denoisers
    ts = np.asarray([999.0, 500.0, 20.0], np.float32)
    jpre = jax.jit(lambda v, *a: JDen(**DEN).apply(
        v, None, *a, mode="precompute"))(jv, ts, priors, emb)
    with torch.inference_mode():
        pre = den.precompute(torch.from_numpy(ts), [nchw(p) for p in priors],
                             torch.from_numpy(emb))
    jfilms = [*jpre["films"]["enc"], *jpre["films"]["mid"],
              *jpre["films"]["dec"]]
    assert len(pre["films"]) == len(jfilms) == 5
    for a, b in zip(pre["films"], jfilms):
        close(a.numpy(), b, 1e-5)
    close(nhwc(pre["idc"]), jpre["idc"], 1e-5)
    k = 1
    jf = jax.tree_util.tree_map(lambda a: a[k][None], jpre["films"])
    ref = jax.jit(lambda v, *a, **kw: JDen(**DEN).apply(
        v, *a, train=False, **kw))(jv, x, jnp.full((2,), ts[k]), priors, emb,
                                   films=jf, idc_pre=jpre["idc"],
                                   hca_gates=jpre["gates"])
    with torch.inference_mode():
        out = den(nchw(x), None, [nchw(p) for p in priors], None,
                  films=[f[k:k + 1] for f in pre["films"]],
                  idc_pre=pre["idc"], hca_gates=pre["gates"])
    close(nhwc(out), ref, 1e-4)


@pytest.mark.parametrize("hoisted", [False, True])
def test_fused_denoiser_encode_decode(denoisers, hoisted):
    """The cached sampler's halves match JAX's `mode="encode"` (bottleneck
    and skips) and `mode="decode"` (on the JAX cache, at another timestep),
    with and without the hoisted invariants; and decode(encode(x, t), t) is
    the full call, bit for bit."""
    den, jv, x, t, priors, emb = denoisers
    t2 = np.asarray([700.0, 100.0], np.float32)
    tp = [nchw(p) for p in priors]
    jkw, kw, films2 = {}, {}, None
    if hoisted:
        ts = np.asarray([999.0, 700.0], np.float32)
        jpre = jax.jit(lambda v, *a: JDen(**DEN).apply(
            v, None, *a, mode="precompute"))(jv, ts, priors, emb)
        with torch.inference_mode():
            pre = den.precompute(torch.from_numpy(ts), tp,
                                 torch.from_numpy(emb))
        jf = [jax.tree_util.tree_map(lambda a: a[k][None], jpre["films"])
              for k in range(2)]
        jkw = dict(idc_pre=jpre["idc"], hca_gates=jpre["gates"])
        kw = dict(idc_pre=pre["idc"], hca_gates=pre["gates"])
        films = [[f[k:k + 1] for f in pre["films"]] for k in range(2)]
        films2 = films[1]
    apply = jax.jit(lambda v, *a, **k: JDen(**DEN).apply(
        v, *a, train=False, **k), static_argnames="mode")
    jcache = apply(jv, x, t, priors, emb, mode="encode",
                   **(dict(jkw, films=jf[0]) if hoisted else {}))
    jout = apply(jv, x, t2, priors, emb, mode="decode", cache=jcache,
                 **(dict(hca_gates=jkw["hca_gates"], films=jf[1])
                    if hoisted else {}))
    with torch.inference_mode():
        args = (nchw(x), torch.from_numpy(t), tp, torch.from_numpy(emb))
        cache = den.encode(*args, films=films[0] if hoisted else None, **kw)
        gates = {"hca_gates": kw["hca_gates"]} if hoisted else {}
        out = den.decode(cache, torch.from_numpy(t2), tp, films=films2,
                         **gates)
        full = den(*args, films=films[0] if hoisted else None, **kw)
        again = den.decode(cache, torch.from_numpy(t), tp,
                           films=films[0] if hoisted else None, **gates)
    close(nhwc(cache["x"]), jcache["x"], 1e-4)
    assert len(cache["skips"]) == len(jcache["skips"]) == 2
    for a, b in zip(cache["skips"], jcache["skips"]):
        close(nhwc(a), b, 1e-4)
    close(nhwc(out), jout, 1e-4)
    assert torch.equal(again, full)
