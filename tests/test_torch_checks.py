"""The torch forms of tests/test_checks.py's discipline checks
(hifidiff_tpu_torch/utils/checks.py), each with a control it catches, on
the real denoiser train step at tiny widths; and the device-side timer
(utils/timing.py) on the CPU. The graph-capture count on the card is
`cuda`-marked (`python -m pytest --noconftest -m cuda
tests/test_torch_checks.py`). Comparisons are bit for bit."""

import functools

import pytest
import torch

from hifidiff_tpu_torch.utils import timing
from hifidiff_tpu_torch.utils.checks import (CaptureCounter,
                                             assert_deterministic,
                                             assert_in_place, storage_of)

torch.set_num_threads(1)
cuda = pytest.mark.cuda
needs_card = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA card")


def _shape_cache(fn):
    """A call cache keyed on shape and dtype, as a graph cache is: `fn`
    runs on a miss only."""
    memo = {}

    def call(x):
        key = (tuple(x.shape), x.dtype)
        if key not in memo:
            memo[key] = fn(x)
        return memo[key]
    return call


class TestCaptureCounter:
    def test_steady_state_runs_once(self):
        counter = CaptureCounter(lambda x: x * 2)
        f = _shape_cache(counter)
        for i in range(5):
            f(torch.ones(4) * i)
        counter.assert_max(1)

    def test_shape_churn_detected(self):
        counter = CaptureCounter(lambda x: x * 2)
        f = _shape_cache(counter)
        f(torch.ones(4))
        f(torch.ones(5))        # a new shape: the body runs again
        with pytest.raises(AssertionError, match="ran 2 times"):
            counter.assert_max(1)

    @cuda
    @needs_card
    def test_graph_replays_do_not_run_the_body(self):
        """Warm-up and capture run the Python body; replays do not."""
        counter = CaptureCounter(lambda x: (x * 2).sum())
        x = torch.ones(1024, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            counter(x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = counter(x)
        for _ in range(5):
            graph.replay()
        torch.cuda.synchronize()
        counter.assert_max(2)
        assert float(out) == 2048.0
        counter(x)
        with pytest.raises(AssertionError, match="ran 3 times"):
            counter.assert_max(2)


@pytest.fixture
def denoiser_step():
    """The stage-3 train step at tiny widths on the CPU, AdamW with an EMA,
    after one step (so that Adam's moments exist)."""
    from hifidiff_tpu_torch.models.denoiser import Denoiser
    from hifidiff_tpu_torch.train.optim import adamw_cosine
    from hifidiff_tpu_torch.train.steps import (TrainState,
                                                make_denoiser_train_step)
    from hifidiff_tpu_torch.vae.model import AutoencoderKL

    torch.manual_seed(0)
    den = Denoiser(width=16, enc_nums=(1,), mid_num=1, dec_nums=(1,))
    vae = AutoencoderKL(block_out=(32, 32), layers_per_block=1)
    state = TrainState.create(den, functools.partial(
        adamw_cosine, warmup_steps=0, total_steps=4), ema_decay=0.9,
        device="cpu")
    step = make_denoiser_train_step(vae, device="cpu")
    images = torch.rand(2, 3, 32, 32, generator=torch.Generator()
                        .manual_seed(1))
    step(state, images, generator=torch.Generator().manual_seed(2))
    return state, step, images


class TestInPlace:
    def test_train_step_updates_in_place(self, denoiser_step):
        """Parameters, buffers, Adam's moments and the EMA keep their
        storage across a step, while their values move."""
        state, step, images = denoiser_step
        before = storage_of(state)
        assert any(k.startswith("optimizer") for k in before)
        assert any(k.startswith("ema") for k in before)
        values = {n: p.detach().clone()
                  for n, p in state.module.named_parameters()}
        step(state, images, generator=torch.Generator().manual_seed(3))
        assert_in_place(state, before)
        assert any(not torch.equal(p, values[n])
                   for n, p in state.module.named_parameters())

    def test_rebinding_detected(self, denoiser_step):
        state, step, images = denoiser_step
        before = storage_of(state)
        step(state, images, generator=torch.Generator().manual_seed(3))
        p = next(state.module.parameters())
        p.data = p.data.clone()     # a parameter held twice
        with pytest.raises(AssertionError, match="not updated in place"):
            assert_in_place(state, before)


class TestDeterministic:
    def test_train_step_is_deterministic(self, denoiser_step):
        """Two steps from cloned states and generators give the same
        metrics bit for bit."""
        state, step, images = denoiser_step
        assert_deterministic(
            lambda s, im, g: step(s, im, generator=g)[1], state, images,
            torch.Generator().manual_seed(4))

    def test_hidden_state_detected(self):
        calls = {"n": 0}

        def impure(x):
            calls["n"] += 1
            return x * calls["n"]

        with pytest.raises(AssertionError, match="different bits"):
            assert_deterministic(impure, torch.ones(3))

    def test_shared_generator_detected(self):
        """A generator captured by the function (not passed in) advances
        between the calls: the check sees it."""
        g = torch.Generator().manual_seed(0)
        with pytest.raises(AssertionError, match="different bits"):
            assert_deterministic(lambda x: x + torch.rand(3, generator=g),
                                 torch.ones(3))


def test_time_fn_and_time_graph_on_the_cpu():
    """Every call varies its input with i and its outputs are folded in;
    on the CPU both timers use the host's clock."""
    seen = []

    def fn(x, i):
        seen.append(i)
        return {"y": x + i, "z": [x * i]}

    ms, first = timing.time_fn(fn, (torch.ones(8),), 3, device="cpu")
    assert seen == [0, 0, 1, 2] and ms > 0 and first > 0
    acc = timing.fold({"y": torch.tensor([-3.0, 2.0]), "z": [torch.ones(1)]},
                      torch.zeros(()))
    assert float(acc) == 4.0
    ms, capture = timing.time_graph(lambda x: x * 2, (torch.ones(8),), 2,
                                    device="cpu")
    assert ms > 0 and capture > 0
    if not torch.cuda.is_available():   # the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            timing.time_fn(fn, (torch.ones(8),), 1)
