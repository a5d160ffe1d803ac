"""The captured train step (`train/graphs.py`), on the CPU at the tiny widths
of tests/test_torch_train.py.

Torch captures no CUDA graph on the CPU, so here the mechanism runs its
body eagerly (`capture=False`): the first call of each kind as the state's
own step (the warm-up), then the same static buffers, the draws made
outside the step from the caller's generator, the host's counters and
schedule advanced around each call. For every step factory of
`train/steps.py` and `train/distill.py` that run equals the eager step bit
for bit over three steps past the warm-ups (losses, parameters, BatchNorm
statistics, gradients, optimizer state, EMA), with and without
accumulation and an EMA; the eager steps are held to the JAX package's in
tests/test_torch_train.py and tests/test_torch_distill.py, so the body is
held to it through them. Also: the device-tensor rate of a capturable
optimizer (`optim.CosineRate`) against `LambdaLR` and the JAX schedule, the
state key, and the refusals (the CPU, a gloo group, a batch of another
shape, a state that changed under the capture, `--cuda-graphs` on the
CPU).

On the card (`cuda`-marked, skipped elsewhere): a replay of the CR and
refiner steps at tiny widths against the eager step with a capturable
optimizer, bit for bit. No jax in those: `python -m pytest --noconftest -m
cuda tests/test_torch_train_graphs.py` on the GPU machine.
"""

import copy
import functools

import numpy as np
import pytest
import torch
from torch import nn

from hifidiff_tpu_torch.models.cr import CoarseRestoration
from hifidiff_tpu_torch.models.denoiser import Denoiser
from hifidiff_tpu_torch.models.refiner import FacialRefiner
from hifidiff_tpu_torch.models.tiny_cr import TinyCR
from hifidiff_tpu_torch.nn.resnet import ResNet50
from hifidiff_tpu_torch.train import distill, graphs, optim, steps
from hifidiff_tpu_torch.vae import tiny
from hifidiff_tpu_torch.vae.model import AutoencoderKL

torch.set_num_threads(1)

RES, LATENT, B = 32, 8, 2
CR = dict(width=8, resolution=RES, enc_nums=(1, 1), mid_num=1,
          dec_nums=(1, 1))
DEN = dict(width=16, enc_nums=(1, 1), mid_num=1, dec_nums=(1, 1))
REF = dict(latent_size=LATENT, idc_stage_sizes=(1, 1, 1, 1), **DEN)
VAE = dict(block_out=(32, 32, 32), layers_per_block=1)
STEPS = 3


def _faces(g, *keys, b=B):
    return {k: torch.rand(b, 3, RES, RES, generator=g) for k in keys}


def _cr_batch(g):
    batch = _faces(g, "lr", "gt")
    batch["patches"] = batch["gt"][:, None] * (
        torch.rand(B, 4, 1, RES, RES, generator=g) > 0.8)
    return batch


def _frozen_cr():
    torch.manual_seed(1)
    return CoarseRestoration(**CR)


def _vae():
    torch.manual_seed(2)
    return AutoencoderKL(**VAE)


def _refiner(width=16):
    torch.manual_seed(3)
    return FacialRefiner(**dict(REF, width=width))


def _adamw(params, accumulate=1, capturable=False):
    return optim.adamw_cosine(params, warmup_steps=2, total_steps=10,
                              accumulate_steps=accumulate,
                              capturable=capturable)


def _adam(params, accumulate=1, capturable=False):
    opt = optim.adam(params, capturable=capturable)
    return optim.Optim(opt.optimizer, None, accumulate)


def _cached_batch(g):
    return {"mean": torch.randn(B, 4, LATENT, LATENT, generator=g),
            "logvar": torch.randn(B, 4, LATENT, LATENT, generator=g) * 0.1}


# kind -> () -> (module, make_optim, step, teacher, batch(g))
def _kinds():
    def cr():
        torch.manual_seed(0)
        return (CoarseRestoration(**CR), _adam,
                steps.make_cr_train_step(device="cpu"), None, _cr_batch)

    def idc():
        torch.manual_seed(0)
        return (ResNet50((1, 1, 1, 1)), _adam,
                steps.make_idc_train_step(_frozen_cr(), device="cpu"), None,
                lambda g: _faces(g, "lr", "gt", "other"))

    def denoiser():
        torch.manual_seed(0)
        return (Denoiser(**DEN), _adamw,
                steps.make_denoiser_train_step(_vae(), device="cpu"), None,
                lambda g: torch.rand(B, 3, RES, RES, generator=g))

    def cached():
        torch.manual_seed(0)
        return (Denoiser(**DEN), _adamw,
                steps.make_denoiser_train_step_cached(device="cpu"), None,
                _cached_batch)

    def vae():
        return (_vae(), _adamw, steps.make_vae_train_step(device="cpu"),
                None, lambda g: _faces(g, "image"))

    def refiner():
        module = _refiner()
        optim.apply_freeze_mask_(module, optim.refiner_freeze_mask(module))
        return (module, _adamw,
                steps.make_refiner_train_step(_frozen_cr(), _vae(),
                                              device="cpu"), None,
                lambda g: _faces(g, "lr", "gt"))

    def distill_():
        teacher = _refiner()
        return (copy.deepcopy(teacher), _adamw,
                distill.make_distill_train_step(
                    _frozen_cr(), _vae(), 5, clip_sample=True,
                    stratified=True, device="cpu"), teacher,
                lambda g: _faces(g, "lr", "gt"))

    def tiny_dn():
        teacher = _refiner()
        torch.manual_seed(4)
        return (FacialRefiner(**dict(REF, width=8)), _adamw,
                distill.make_tiny_dn_train_step(_frozen_cr(), _vae(),
                                                rollout_steps=2,
                                                device="cpu"), teacher,
                lambda g: _faces(g, "lr", "gt"))

    def tiny_cr():
        torch.manual_seed(0)
        return (TinyCR(width=8, blocks=1, down_factor=2, up_width=4), _adamw,
                distill.make_tiny_cr_train_step(_frozen_cr(), device="cpu"),
                None, lambda g: _faces(g, "lr", "gt"))

    def tae():
        torch.manual_seed(0)
        widths = (8, 8, 8)
        pair = nn.ModuleDict({
            "enc": tiny.TinyEncoder(widths=widths, blocks_per_stage=1),
            "dec": tiny.TinyDecoder(widths=widths, blocks_per_stage=1)})
        return (pair, _adamw,
                distill.make_tae_train_step(_vae(), device="cpu"), None,
                lambda g: _faces(g, "image"))

    return {"cr": cr, "idc": idc, "denoiser": denoiser,
            "cached_denoiser": cached, "vae": vae, "refiner": refiner,
            "distill": distill_, "tiny_dn": tiny_dn, "tiny_cr": tiny_cr,
            "tae": tae}


KINDS = _kinds()


def _state(module, make_optim, accumulate, ema):
    return steps.TrainState.create(
        module, functools.partial(make_optim, accumulate=accumulate),
        ema_decay=ema, device="cpu")


def _tensors(state):
    """Everything a step writes, by name: parameters, buffers, gradients,
    optimizer state, EMA."""
    out = {f"module.{k}": v for k, v in state.module.state_dict().items()}
    for n, p in state.module.named_parameters():
        if p.grad is not None:
            out[f"grad.{n}"] = p.grad
    names = {id(p): n for n, p in state.module.named_parameters()}
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            out[f"optim.{names[id(p)]}.{k}"] = v
    for n, e in (state.ema_params or {}).items():
        out[f"ema.{n}"] = e
    return out


def _assert_same(got, want, what):
    for k in got.keys() ^ want.keys():
        # a gradient that the captured step zeroed in place where the eager
        # one dropped it: zeros hold what a fresh one holds
        assert k in got and k.startswith("grad.") and not got[k].any(), \
            (what, k)
    for k in got.keys() & want.keys():
        assert torch.equal(got[k], want[k]), f"{what}: {k}"


def _gen(i):
    return torch.Generator().manual_seed(100 + i)


@pytest.mark.parametrize("accumulate,ema", [(1, 0.0), (2, 0.9)])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_body_equals_eager_step(kind, accumulate, ema):
    """The warm-ups (the first call of each kind) and three more calls of
    the captured step's body, run eagerly through its static buffers with
    the draws made outside, against as many eager steps from the same
    state, batches and generators, bit for bit; making the capture runs
    nothing."""
    module, make_optim, step, teacher, make_batch = KINDS[kind]()
    eager = _state(copy.deepcopy(module), make_optim, accumulate, ema)
    body = _state(module, make_optim, accumulate, ema)
    g = torch.Generator().manual_seed(7)
    batches = [make_batch(g) for _ in range(STEPS + accumulate)]
    before = {k: v.clone() for k, v in _tensors(body).items()}
    lead = () if teacher is None else (teacher,)
    cap = graphs.capture_train_step(step, body, batches[0], teacher=teacher,
                                    capture=False)
    _assert_same(_tensors(body), before, "after the capture")
    assert body.step == 0 and body.mini_step == 0 and not cap.draws
    for i, batch in enumerate(batches):
        _, want = step(eager, *lead, batch, **(
            {"generator": _gen(i)} if cap.takes_generator else {}))
        _, got = cap.run(batch, generator=_gen(i))
        _assert_same(got, want, f"step {i} metrics")
        _assert_same(_tensors(body), _tensors(eager), f"step {i} state")
        assert (body.step, body.mini_step) == (eager.step, eager.mini_step)
        if eager.scheduler is not None:
            assert body.scheduler.state_dict() == eager.scheduler.state_dict()
    assert cap.replays == STEPS and cap.warm == {True, accumulate == 1}
    drawn = {"cr": [], "idc": [], "tiny_cr": [],
             "denoiser": ["posterior_noise", "noise", "timesteps"],
             "cached_denoiser": ["posterior_noise", "noise", "timesteps"],
             "vae": ["posterior_noise"], "tae": ["posterior_noise"],
             "refiner": ["hf_posterior_noise", "cr_posterior_noise", "noise",
                         "timesteps"],
             "distill": ["hf_posterior_noise", "cr_posterior_noise",
                         "student_steps", "noise"],
             "tiny_dn": ["hf_posterior_noise", "cr_posterior_noise",
                         "latents_noise", "fwd_timesteps", "noise"]}
    assert list(cap.draws) == drawn[kind]


def test_remat_body_equals_eager_step():
    """`--remat` (the denoiser's blocks under a checkpoint that keeps no RNG
    state: they draw nothing) through the captured step's body, with
    accumulation and an EMA."""
    torch.manual_seed(0)
    module = Denoiser(**DEN, remat=True)
    step = steps.make_denoiser_train_step_cached(device="cpu")
    eager = _state(copy.deepcopy(module), _adamw, 2, 0.9)
    body = _state(module, _adamw, 2, 0.9)
    g = torch.Generator().manual_seed(8)
    batches = [_cached_batch(g) for _ in range(STEPS + 2)]
    cap = graphs.capture_train_step(step, body, batches[0], capture=False)
    for i, batch in enumerate(batches):
        _, want = step(eager, batch, generator=_gen(i))
        _, got = cap.run(batch, generator=_gen(i))
        _assert_same(got, want, f"step {i} metrics")
        _assert_same(_tensors(body), _tensors(eager), f"step {i} state")
    assert cap.replays == STEPS


def _rate_optim(params, accumulate=1):
    """AdamW on a float32 tensor rate written by `CosineRate`, as
    `adamw_cosine(capturable=True)` builds it on the card (the CPU takes a
    tensor rate without foreach)."""
    rate = torch.tensor(1e-4)
    opt = torch.optim.AdamW(params, lr=rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01, foreach=False)
    return optim.Optim(opt, optim.CosineRate(opt, [1e-4], 2, 10), accumulate)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_device_rate_equals_lambda_lr_and_jax(accumulate):
    """The rate `CosineRate` writes at each update equals LambdaLR's rounded
    to float32 and the JAX schedule's (to its float32 rounding, as
    tests/test_torch_train.py holds LambdaLR), accumulation included: the
    k-th applied update reads count k. The captured step's body on it
    equals the eager step bit for bit."""
    from hifidiff_tpu.train import optim as joptim

    torch.manual_seed(0)
    module = CoarseRestoration(**CR)
    step = steps.make_cr_train_step(device="cpu")
    eager = _state(copy.deepcopy(module), _rate_optim, accumulate, 0.0)
    body = _state(module, _rate_optim, accumulate, 0.0)
    lam = torch.optim.lr_scheduler.LambdaLR(
        torch.optim.SGD([nn.Parameter(torch.zeros(1))], lr=1e-4),
        lambda s: optim.cosine_factor(s, 2, 10))
    seen = []
    real = eager.optimizer.step

    def spy(*a, **k):
        seen.append(eager.optimizer.param_groups[0]["lr"].clone())
        return real(*a, **k)

    eager.optimizer.step = spy
    g = torch.Generator().manual_seed(9)
    batches = [_cr_batch(g) for _ in range(4 * accumulate)]
    cap = graphs.capture_train_step(step, body, batches[0], capture=False)
    for i, batch in enumerate(batches):
        _, want = step(eager, batch)
        _, got = cap.run(batch)
        _assert_same(got, want, f"step {i} metrics")
        _assert_same(_tensors(body), _tensors(eager), f"step {i} state")
    assert len(seen) == 4
    jax_rates = joptim.cosine_with_warmup(1e-4, 2, 10)
    for k, rate in enumerate(seen):
        assert rate.dtype == torch.float32
        assert float(rate) == float(np.float32(lam.get_last_lr()[0])), k
        np.testing.assert_allclose(float(rate), float(jax_rates(k)),
                                   rtol=1e-5, atol=1e-12)
        lam.optimizer.step()
        lam.step()
    assert seen[0] == 0.0 and body.scheduler.last_epoch == 4
    assert float(body.optimizer.param_groups[0]["lr"]) \
        == float(np.float32(lam.get_last_lr()[0]))


def _captured_cr(batch_size=B):
    torch.manual_seed(0)
    state = _state(CoarseRestoration(**CR), _adam, 1, 0.9)
    batch = _cr_batch(torch.Generator().manual_seed(1))
    step = steps.make_cr_train_step(device="cpu")
    return state, step, batch, graphs.capture_train_step(
        step, state, batch, capture=False)


def test_state_key_drops_the_capture():
    """A capture holds for the tensors it was made on: after
    `load_state_dict` (a resume), `.to()` or a freeze change the next `run`
    raises, and so does every later one until the step is captured again;
    a replay changes nothing of the key."""
    state, step, batch, cap = _captured_cr()
    cap.run(batch)              # the warm-up makes gradients and Adam's state
    key = graphs.StateKey(state)
    cap.run(batch)
    assert key.holds() and key.read()[1] == graphs.StateKey(state).values
    assert cap.replays == 1

    def dropped(change):
        nonlocal cap
        change()
        with pytest.raises(RuntimeError, match="capture the step again"):
            cap.run(batch)
        with pytest.raises(RuntimeError, match="capture the step again"):
            cap.run(batch)
        cap = graphs.capture_train_step(step, state, batch, capture=False)
        cap.run(batch)

    dropped(lambda: state.load_state_dict(state.state_dict()))
    dropped(lambda: state.module.to(torch.float64).to(torch.float32))
    dropped(lambda: next(state.module.parameters()).requires_grad_(False))


def test_refusals_by_name(tmp_path):
    """No silent eager path: a capture on the CPU, over a gloo group, with an
    optimizer that is not capturable, a batch of another shape, a draw the
    step does not make; a capturable optimizer on the CPU."""
    state, step, batch, cap = _captured_cr()
    with pytest.raises(RuntimeError, match="CUDA graphs need the card"):
        graphs.capture_train_step(step, state, batch)
    small = {k: v[:1] for k, v in batch.items()}
    with pytest.raises(ValueError, match="holds for one batch shape"):
        cap.run(small)
    with pytest.raises(ValueError, match="not draws of the step"):
        cap.run(batch, noise=torch.zeros(1))
    cap.run(batch)
    with pytest.raises(ValueError, match="not draws of the step"):
        cap.run(batch, noise=torch.zeros(1))
    with pytest.raises(ValueError, match="capturable optimizer keeps"):
        optim.adam(state.module.parameters(), capturable=True)
    with pytest.raises(ValueError, match="capturable optimizer keeps"):
        optim.adamw_cosine(state.module.parameters(), capturable=True)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        torch.manual_seed(0)
        grouped = steps.TrainState.create(CoarseRestoration(**CR), optim.adam,
                                          device="cpu", group=dist.group.WORLD)
        with pytest.raises(RuntimeError, match="runs on gloo"):
            graphs.capture_train_step(step, grouped, batch)
    finally:
        dist.destroy_process_group()


def test_eager_optimizer_loads_a_captured_runs_state():
    """A state saved with a capturable optimizer (its rate a tensor, its
    flag set) loads into an eager CPU one, which keeps its own float rate and
    flag and steps on."""
    torch.manual_seed(0)
    state = steps.TrainState.create(CoarseRestoration(**CR), _adamw,
                                    device="cpu")
    step = steps.make_cr_train_step(device="cpu")
    batch = _cr_batch(torch.Generator().manual_seed(2))
    step(state, batch)
    sd = copy.deepcopy(state.state_dict())
    group = sd["optimizer"]["param_groups"][0]
    group["lr"], group["capturable"] = torch.tensor(5e-5), True
    state.load_state_dict(sd)
    group = state.optimizer.param_groups[0]
    assert group["capturable"] is False \
        and group["lr"] == float(torch.tensor(5e-5))
    assert type(group["lr"]) is float
    step(state, batch)
    assert state.step == 2


@pytest.fixture
def cuda():
    """The card, under torch's deterministic mode with cuDNN's deterministic
    algorithms: without it cuDNN may pick other algorithms from one call to
    the next (two eager runs of the IDC step differ), and under a capture
    whose workspace comes from the graph's pool."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs capture the card")
    was = (torch.backends.cudnn.deterministic,
           torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = was[0]
    torch.use_deterministic_algorithms(was[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,accumulate,ema", [("cr", 1, 0.9),
                                                 ("refiner", 1, 0.0),
                                                 ("refiner", 2, 0.9)])
def test_replay_is_bit_equal_to_eager(cuda, kind, accumulate, ema):
    """On the card: the warm-ups and three replays against as many eager
    steps of the same state on a capturable optimizer, the same batches and
    generators, bit for bit; a call that warms up and captures launches
    twice what the eager step launches, a replay nothing from Python."""
    from hifidiff_tpu_torch.ops import kernels

    dev = cuda
    module, _, _, _, make_batch = KINDS[kind]()
    if kind == "cr":
        step = steps.make_cr_train_step(device=dev)
    else:
        step = steps.make_refiner_train_step(_frozen_cr(), _vae(),
                                             device=dev)
    make_optim = functools.partial(
        _adam if kind == "cr" else _adamw, accumulate=accumulate,
        capturable=True)
    eager = steps.TrainState.create(copy.deepcopy(module), make_optim,
                                    ema_decay=ema, device=dev)
    state = steps.TrainState.create(module, make_optim, ema_decay=ema,
                                    device=dev)
    g = torch.Generator().manual_seed(7)
    batches = [{k: v.to(dev) for k, v in make_batch(g).items()}
               for _ in range(STEPS + accumulate)]
    kernels.reset_launches()
    cap = graphs.capture_train_step(step, state, batches[0])
    assert not any(kernels.LAUNCHES.values())

    def gen(i):
        return torch.Generator(device=dev).manual_seed(100 + i)

    for i, batch in enumerate(batches):
        def kw():
            return {"generator": gen(i)} if cap.takes_generator else {}

        before = sum(kernels.LAUNCHES.values())
        _, want = step(eager, batch, **kw())
        one = sum(kernels.LAUNCHES.values()) - before
        _, got = cap.run(batch, **kw())
        launched = sum(kernels.LAUNCHES.values()) - before - one
        assert one > 0 and launched == (2 * one if i < accumulate else 0)
        _assert_same(got, want, f"step {i} metrics")
        _assert_same(_tensors(state), _tensors(eager), f"step {i} state")
    assert cap.replays == STEPS


@pytest.mark.cuda
def test_resume_drops_the_capture_and_recaptures(cuda, tmp_path):
    """On the card: a checkpoint saved by a captured run and restored into
    the same state (a resume) drops the capture, the next call raises, and
    a new capture on the restored state (its two warm-ups and three
    replays) steps as an eager state restored from the same file."""
    from hifidiff_tpu_torch.train import checkpoint

    module, _, _, _, _ = KINDS["refiner"]()
    step = steps.make_refiner_train_step(_frozen_cr(), _vae(), device=cuda)
    make_optim = functools.partial(_adamw, accumulate=2, capturable=True)
    state = steps.TrainState.create(copy.deepcopy(module), make_optim,
                                    ema_decay=0.9, device=cuda)
    eager = steps.TrainState.create(module, make_optim, ema_decay=0.9,
                                    device=cuda)
    g = torch.Generator().manual_seed(3)
    batches = [{k: v.to(cuda) for k, v in _faces(g, "lr", "gt").items()}
               for _ in range(6)]

    def gen(i):
        return torch.Generator(device=cuda).manual_seed(200 + i)

    cap = graphs.capture_train_step(step, state, batches[0])
    cap.run(batches[0], generator=gen(0))      # a mini-step, the warm-up
    path = str(tmp_path / "step_1.pt")
    checkpoint.save_state(path, state)
    checkpoint.restore_state(path, state)
    checkpoint.restore_state(path, eager)
    with pytest.raises(RuntimeError, match="capture the step again"):
        cap.run(batches[1], generator=gen(1))
    cap = graphs.capture_train_step(step, state, batches[1])
    for i, batch in enumerate(batches[1:], 1):
        _, want = step(eager, batch, generator=gen(i))
        _, got = cap.run(batch, generator=gen(i))
        _assert_same(got, want, f"step {i} metrics")
        _assert_same(_tensors(state), _tensors(eager), f"step {i} state")
    assert state.step == eager.step == 6 and cap.replays == 3
    assert isinstance(state.optimizer.param_groups[0]["lr"], torch.Tensor)


def test_step_that_takes_its_draws_as_keywords():
    """A step whose draws pass through `**kwargs` (as `pretrain_denoiser`'s
    image step wraps the denoiser step) is warmed up with a generator and
    replays as the wrapped step does."""
    torch.manual_seed(0)
    module = Denoiser(**DEN)
    inner = steps.make_denoiser_train_step(_vae(), device="cpu")

    def batch_step(state, batch, **draws):
        return inner(state, batch["image"], **draws)

    eager = _state(copy.deepcopy(module), _adamw, 1, 0.0)
    body = _state(module, _adamw, 1, 0.0)
    g = torch.Generator().manual_seed(10)
    batches = [_faces(g, "image") for _ in range(2)]
    cap = graphs.capture_train_step(batch_step, body, batches[0],
                                    capture=False)
    for i, batch in enumerate(batches):
        _, want = batch_step(eager, batch, generator=_gen(i))
        _, got = cap.run(batch, generator=_gen(i))
        _assert_same(got, want, f"step {i} metrics")
        _assert_same(_tensors(body), _tensors(eager), f"step {i} state")
    assert list(cap.draws) == ["posterior_noise", "noise", "timesteps"]
    assert cap.replays == 1


def test_a_failed_capture_leaves_the_state_as_it_was():
    """A step that raises in its applying body (the second kind's warm-up,
    after the accumulating call stepped the state) raises out of `run`; the
    state holds its values and counters from before that call, and the
    capture is dropped: the next call raises."""
    torch.manual_seed(0)
    state = _state(CoarseRestoration(**CR), _adam, 2, 0.9)
    inner = steps.make_cr_train_step(device="cpu")

    def step(st, batch):
        if st.graph_applies:
            raise RuntimeError("the applying body fails")
        return inner(st, batch)

    batch = _cr_batch(torch.Generator().manual_seed(4))
    cap = graphs.capture_train_step(step, state, batch, capture=False)
    cap.run(batch)
    before = {k: v.clone() for k, v in _tensors(state).items()}
    with pytest.raises(RuntimeError, match="the applying body fails"):
        cap.run(batch)
    _assert_same(_tensors(state), before, "after the failed capture")
    assert (state.step, state.mini_step, state.graph_applies) == (1, 1, None)
    with pytest.raises(RuntimeError, match="capture the step again"):
        cap.run(batch)
