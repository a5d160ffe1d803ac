"""The plain versions of the port's two fused kernels against the JAX
package's Pallas kernels in interpret mode (float32, CPU): GroupNorm + SiLU,
and the fused small-map ConditionalNAFBlock at 1x1 and 2x2 with float, int8
and mixed weights. On the CPU the port's wrappers take these plain versions;
the CUDA kernels are held to them on the card (test_torch_kernels_cuda.py,
chip_smoke.py)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifidiff_tpu.nn.naf import ConditionalNAFBlock as JCNAF
from hifidiff_tpu.ops import quant as jquant
from hifidiff_tpu.ops.norm import _gn_silu_ref
from hifidiff_tpu.ops.pallas.groupnorm_silu import group_norm_silu_pallas
from hifidiff_tpu.utils import torch_import as ti
from hifidiff_tpu_torch import convert
from hifidiff_tpu_torch.nn import naf
from hifidiff_tpu_torch.nn.layers import quantize_module_
from hifidiff_tpu_torch.nn.naf import ConditionalNAFBlock
from hifidiff_tpu_torch.ops import naf_block, norm, quant
from hifidiff_tpu_torch.random_weights import amplify_naf_blocks_, perturb_
from torch_parity import jax_weights, nchw, nhwc, normal

torch.set_num_threads(1)
C, TIME_DIM = 128, 64


@pytest.fixture(autouse=True)
def seeded_init():
    torch.manual_seed(0)


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 64), 32),
                                          ((1, 16, 16, 128), 32),
                                          ((3, 4, 4, 32), 8)])
def test_group_norm_silu_plain_matches_pallas_interpret(shape, groups):
    rng = np.random.default_rng(0)
    x = 2.0 * normal(rng, *shape) + 0.5
    w, b = normal(rng, shape[-1]), normal(rng, shape[-1])
    ref = group_norm_silu_pallas(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), groups)
    args = (nchw(x), torch.from_numpy(w), torch.from_numpy(b), groups)
    out = norm.group_norm_silu_plain(*args)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=0, atol=1e-5)
    # on the CPU both settings of the option are the plain version
    assert torch.equal(norm.group_norm_silu(*args, fused=True), out)
    assert torch.equal(norm.group_norm_silu(*args), out)


def test_group_norm_silu_near_constant_large_mean_group():
    """The case in which a one-pass variance goes negative. Both sides are
    finite; they differ by the float32 cancellation of `x * a + b` at a mean
    of 50 and a = rstd of about 1e3, bounded as in the JAX package's own
    test of this case."""
    rng = np.random.default_rng(1)
    x = 50.0 + 1e-3 * normal(rng, 1, 32, 32, 128)
    w, b = np.ones(128, np.float32), np.zeros(128, np.float32)
    out = norm.group_norm_silu_plain(nchw(x), torch.from_numpy(w),
                                     torch.from_numpy(b))
    assert bool(torch.isfinite(out).all())
    for ref in (group_norm_silu_pallas(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b)),
                _gn_silu_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             32, 1e-6)):
        np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=1e-2,
                                   atol=2e-2)


def _block_pair(monkeypatch, threshold=None, seed=0):
    """A perturbed port block, the JAX params made from it and, with a
    `threshold`, both quantized: the port by `quantize_module_`, the JAX
    tree by `quantize_variables`, each with its own quantizer."""
    torch.manual_seed(seed)
    blk = ConditionalNAFBlock(C, TIME_DIM)
    jp = jax_weights(blk, lambda sd: ti.conditional_naf_block_params(sd, ""),
                     convert.naf_block_state_dict, seed=seed)
    if threshold is not None:
        monkeypatch.setattr(quant, "W8_MIN_WEIGHT_PARAMS", threshold)
        monkeypatch.setattr(jquant, "W8_MIN_WEIGHT_PARAMS", threshold)
        jp = jquant.quantize_variables(jp)
        quantize_module_(blk)
        back = convert.naf_block_state_dict(jp)   # the same int8 bytes
        for k, v in blk.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), back[k].numpy(),
                                          err_msg=k)
    return blk, {"params": jp}


# (threshold, which of conv1 / sca / conv3 / conv4 / conv5 / conv2 are int8)
WEIGHTS = {"float": (None, 0), "int8": (0, 6), "mixed": (2 * C * C, 2)}


@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("hw", [1, 2])
def test_fused_block_plain_matches_jax_fused_block(hw, weights, monkeypatch):
    """The JAX block under HIFIDIFF_FORCE_FUSED_NAF (its Pallas kernel in
    interpret mode) against the port's block with `fuse_small=True`, which
    on the CPU is `fused_cnaf_block_small_plain`. 'mixed': only the two
    (C -> 2C) convolutions reach the size threshold, so the int8 minority
    is dequantized when the block is packed."""
    threshold, n_int8 = WEIGHTS[weights]
    blk, jv = _block_pair(monkeypatch, threshold, seed=hw)
    convs = (blk.conv1, blk.sca[1], blk.conv3, blk.conv4, blk.conv5,
             blk.conv2)
    assert sum(hasattr(m, "weight_q") for m in convs) == n_int8
    rng = np.random.default_rng(2)
    x, film = normal(rng, 3, hw, hw, C), normal(rng, 1, 4 * C, scale=0.2)
    monkeypatch.setenv("HIFIDIFF_FORCE_FUSED_NAF", "1")
    ref = np.asarray(JCNAF(C, TIME_DIM).apply(jv, jnp.asarray(x),
                                              film=jnp.asarray(film)))
    calls = []
    monkeypatch.setattr(
        naf, "fused_cnaf_block_small",
        lambda *a, **k: calls.append(1) or
        naf_block.fused_cnaf_block_small(*a, **k))
    with torch.inference_mode():
        out = blk(nchw(x), film=torch.from_numpy(film), fuse_small=True)
        std = blk(nchw(x), film=torch.from_numpy(film))
    assert calls == [1]                    # the fused path, and only once
    assert np.abs(ref - x).max() > 0.05    # non-vacuous: the block acts
    np.testing.assert_allclose(nhwc(out), ref, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(nhwc(std), ref, atol=2e-5, rtol=1e-5)


def test_fused_block_int8_drifts_from_float(monkeypatch):
    blk, _ = _block_pair(monkeypatch)
    blk_q, _ = _block_pair(monkeypatch, 0)
    rng = np.random.default_rng(3)
    x = nchw(normal(rng, 3, 2, 2, C))
    film = torch.from_numpy(normal(rng, 1, 4 * C, scale=0.2))
    with torch.inference_mode():
        ref = blk(x, film=film, fuse_small=True)
        out = blk_q(x, film=film, fuse_small=True)
    rel = float((out - ref).norm() / ref.norm())
    assert 0 < rel < 0.02, rel      # int8 drift: there, and small


def test_per_sample_film_takes_the_standard_path(monkeypatch):
    """The fused block assumes one shared film row: a (B, 4C) film, the
    training shape, must not reach it."""
    blk, jv = _block_pair(monkeypatch)
    rng = np.random.default_rng(4)
    x, film = normal(rng, 3, 1, 1, C), normal(rng, 3, 4 * C, scale=0.2)

    def refuse(*a, **k):
        raise AssertionError("a per-sample film reached the fused block")

    monkeypatch.setattr(naf, "fused_cnaf_block_small", refuse)
    monkeypatch.setenv("HIFIDIFF_FORCE_FUSED_NAF", "1")
    ref = JCNAF(C, TIME_DIM).apply(jv, jnp.asarray(x), film=jnp.asarray(film))
    with torch.inference_mode():
        out = blk(nchw(x), film=torch.from_numpy(film), fuse_small=True)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("c,shape,film_batch,expand,ok", [
    (128, (2, 128, 1, 1), 1, 2, True), (256, (2, 256, 2, 2), 1, 2, True),
    (128, (2, 128, 4, 4), 1, 2, False), (128, (2, 128, 1, 2), 1, 2, False),
    (64, (2, 64, 1, 1), 1, 2, False), (192, (2, 192, 2, 2), 1, 2, False),
    (128, (2, 128, 2, 2), 2, 2, False), (128, (2, 128, 1, 1), 1, 1, False)])
def test_fused_small_gate(c, shape, film_batch, expand, ok):
    """The JAX gate: a square 1x1 or 2x2 map, film batch 1, both expansion
    factors 2, c a multiple of 128."""
    blk = ConditionalNAFBlock(c, TIME_DIM, dw_expand=expand)
    x, film = torch.zeros(shape), torch.zeros(film_batch, 4 * c)
    assert blk._fused_small_ok(x, film) is ok
    assert not ok or blk.will_fuse(shape[2])


@pytest.mark.parametrize("c,hw,expand,ok", [
    (128, 1, 2, True), (1024, 2, 2, True), (128, 4, 2, False),
    (64, 1, 2, False), (192, 2, 2, False), (128, 2, 1, False)])
def test_will_fuse(c, hw, expand, ok):
    """What the gate knows before it sees a tensor."""
    assert ConditionalNAFBlock(c, TIME_DIM, ffn_expand=expand).will_fuse(
        hw) is ok


@pytest.mark.parametrize("hw", [1, 2])
def test_amplified_block_shows_every_part(hw):
    """On `amplify_naf_blocks_` weights each part of the block carries a
    good share of what the block adds to its input: leaving out the second
    branch, the SCA gate or (on 2x2) the off-centre taps moves the result by
    more than a fifth of that, which the checks on the card rely on."""
    blk = amplify_naf_blocks_(perturb_(ConditionalNAFBlock(C, TIME_DIM),
                                       torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(5)
    x = nchw(normal(rng, 8, hw, hw, C))
    film = torch.from_numpy(normal(rng, 1, 4 * C, scale=0.2))
    pack, sp = blk.fused_pack(hw, torch.float32), hw * hw
    gate_one, no_gamma = pack.vec_c.clone(), pack.vec_c.clone()
    gate_one[3], no_gamma[1] = 1.0, 0.0          # b_sca, gamma
    centre = [p * sp + p for p in range(sp)]
    taps = torch.zeros_like(pack.vec_dw)
    taps[centre] = pack.vec_dw[centre]
    w = pack.weights
    wrong = [pack._replace(vec_c=no_gamma),
             pack._replace(vec_c=gate_one,
                           weights=(w[0], torch.zeros_like(w[1]), *w[2:]))]
    if hw > 1:
        wrong.append(pack._replace(vec_dw=taps))
    with torch.inference_mode():
        ref = naf_block.fused_cnaf_block_small_plain(x, film, pack)
        added = float((ref - x).norm())
        assert added > 0.1 * float(x.norm())
        for p in wrong:
            out = naf_block.fused_cnaf_block_small_plain(x, film, p)
            assert float((out - ref).norm()) > 0.2 * added


def test_fused_pack_is_kept_until_the_weights_change():
    """The block packs once per (map side, dtype); moving or casting it,
    loading a state dict and quantizing it drop the kept packs."""
    blk = ConditionalNAFBlock(C, TIME_DIM)
    pack = blk.fused_pack(2, torch.float32)
    assert blk.fused_pack(2, torch.float32) is pack
    assert blk.fused_pack(1, torch.float32) is not pack
    state = {k: v + 1.0 for k, v in blk.state_dict().items()}
    blk.load_state_dict(state)
    fresh = blk.fused_pack(2, torch.float32)
    assert fresh is not pack
    assert torch.equal(fresh.vec_c[0], pack.vec_c[0] + 1.0)       # beta
    blk.double()
    assert not blk._packs
    blk.float()
    pack = blk.fused_pack(2, torch.float32)
    old, quant.W8_MIN_WEIGHT_PARAMS = quant.W8_MIN_WEIGHT_PARAMS, 0
    try:
        quantize_module_(blk)
    finally:
        quant.W8_MIN_WEIGHT_PARAMS = old
    assert blk.fused_pack(2, torch.float32).weights[0].dtype == torch.int8
    x, film = torch.zeros(2, C, 2, 2), torch.zeros(1, 4 * C)
    with torch.inference_mode():        # a pack made here is a plain tensor
        blk.clear_fused_packs()
        blk(x, film=film, fuse_small=True)
    assert not blk.fused_pack(2, torch.float32).vec_c.is_inference()
    with pytest.raises(RuntimeError, match="no backward"):
        blk(x, film=film, fuse_small=True)
    twin = copy.deepcopy(blk)
    assert twin.fused_pack(2, torch.float32) is not blk.fused_pack(
        2, torch.float32)


def test_pack_layout():
    """The packed vectors: 8 per-channel rows, 5 rows of 2C, hw^4 tap rows
    with mix[p, q] = dw[1 + qy - py, 1 + qx - px], five (cout, cin)
    matrices."""
    blk = ConditionalNAFBlock(C, TIME_DIM)
    pack = blk.fused_pack(2, torch.float32)
    assert pack.ln.shape == (4, C) and pack.vec_c.shape == (8, C)
    assert pack.vec_2c.shape == (5, 2 * C)
    assert pack.vec_dw.shape == (16, 2 * C)
    assert [tuple(w.shape) for w in pack.weights] == [
        (2 * C, C), (C, C), (C, C), (2 * C, C), (C, C)]
    dw = blk.conv2.weight[:, 0]
    # output position p = (0, 1), input position q = (1, 0): tap (2, 0)
    assert torch.equal(pack.vec_dw[1 * 4 + 2], dw[:, 2, 0])
    assert torch.equal(pack.vec_dw[0], dw[:, 1, 1])        # centre tap
    one = blk.fused_pack(1, torch.float32)
    assert one.vec_dw.shape == (1, 2 * C)
    assert torch.equal(one.vec_dw[0], dw[:, 1, 1])


@pytest.mark.parametrize("c,hw,batch", [(2048, 1, 128), (1024, 2, 128),
                                        (128, 1, 1), (384, 2, 3)])
def test_scratch_holds_the_chain_s_buffers(c, hw, batch):
    """The wrapper sizes the CUDA chain's scratch: u and y1 (M, C) in
    float32, the normed and the gated rows (M, C) in bf16, the pooled rows
    (B, C) in bf16, in that order, each starting on a 16-byte boundary; at
    the path's shapes it stays well inside the card's 50 MB L2."""
    m = batch * hw * hw
    sizes = [4 * m * c, 4 * m * c, 2 * m * c, 2 * m * c, 2 * batch * c]
    offsets = np.cumsum([0] + sizes)
    assert all(o % 16 == 0 for o in offsets)
    assert 4 * naf_block.scratch_floats(m, batch, c) == offsets[-1]
    assert offsets[-1] < 8e6
