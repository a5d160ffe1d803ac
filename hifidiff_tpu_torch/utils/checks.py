"""Runtime checks of the execution discipline (counterpart of
hifidiff_tpu/utils/checks.py).

The JAX package guards three hazards of a jit framework: silent retracing,
ineffective buffer donation and impure traced functions. Their torch
forms:

  * `CaptureCounter` (for `RetraceCounter`): counts how often a Python body
    runs that should have run once and then replayed: a CUDA-graph capture
    of a sampler or a step, or a cache miss keyed on shapes;
  * `assert_in_place` (for `assert_donated`): a train step updates the
    parameters, the optimizer's moments and the EMA in their own storage,
    so that the state is never held twice;
  * `assert_deterministic` (for `assert_jit_pure`): two calls from cloned
    inputs and the same generator states give the same bits, so that no
    hidden mutable state (a counter, a global RNG) steers the function.
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Callable, Dict

import torch


class CaptureCounter:
    """Wrap a function whose body should run once per input signature (a
    graph capture, or the eager call a cache stands in for) to count its
    runs:

        counter = CaptureCounter(body)
        ... steady-state loop ...
        counter.assert_max(1)
    """

    def __init__(self, fn: Callable):
        self.fn = fn
        self.count = 0
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        self.count += 1
        return self.fn(*args, **kwargs)

    def assert_max(self, n: int) -> None:
        if self.count > n:
            raise AssertionError(
                f"{getattr(self.fn, '__name__', self.fn)} ran {self.count} "
                f"times (expected <= {n}): a capture or a cached call ran "
                "again; check for shape or dtype churn")


def storage_of(state) -> Dict[str, int]:
    """The storage addresses of a `train.steps.TrainState`'s parameters,
    buffers, optimizer moments and EMA, by name."""
    out = {f"param {n}": p.data_ptr()
           for n, p in state.module.named_parameters()}
    out.update({f"buffer {n}": b.data_ptr()
                for n, b in state.module.named_buffers()})
    names = {id(p): n for n, p in state.module.named_parameters()}
    for p, s in state.optimizer.state.items():
        for k, v in s.items():
            if isinstance(v, torch.Tensor) and v.dim():
                out[f"optimizer {names.get(id(p), '?')} {k}"] = v.data_ptr()
    for n, e in (state.ema_params or {}).items():
        out[f"ema {n}"] = e.data_ptr()
    return out


def assert_in_place(state, before: Dict[str, int]) -> None:
    """Assert that every tensor of `state` recorded in `before`
    (`storage_of(state)` taken before a step) still lives in the same
    storage: a step that rebinds a parameter or a moment to a new tensor
    holds the train state twice at its peak."""
    now = storage_of(state)
    moved = [k for k, ptr in before.items() if now.get(k) != ptr]
    if moved:
        raise AssertionError(
            "not updated in place: " + ", ".join(moved[:8])
            + (" ..." if len(moved) > 8 else ""))


def _clone(x: Any) -> Any:
    if isinstance(x, torch.Generator):
        g = torch.Generator(device=x.device)
        g.set_state(x.get_state())
        return g
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return copy.deepcopy(x)


def _bits(out):
    if isinstance(out, torch.Tensor):
        t = out.detach().contiguous()
        return [(tuple(t.shape), t.dtype, t.reshape(-1).view(torch.uint8)
                 if t.numel() else t)]
    if isinstance(out, dict):
        return [b for k in sorted(out) for b in _bits(out[k])]
    if isinstance(out, (list, tuple)):
        return [b for v in out for b in _bits(v)]
    return [out]


def assert_deterministic(fn: Callable, *args, **kwargs) -> None:
    """Call `fn` twice, each time on deep copies of the arguments (a
    `torch.Generator` copied with its state) and from the same global RNG
    state, and assert that the outputs are equal bit for bit."""
    outs = []
    devices = [torch.cuda.current_device()] \
        if torch.cuda.is_available() and torch.cuda.is_initialized() else []
    rng = torch.get_rng_state()
    cuda_rng = [torch.cuda.get_rng_state(d) for d in devices]
    for _ in range(2):
        with torch.random.fork_rng(devices=devices):
            torch.set_rng_state(rng)
            for d, state in zip(devices, cuda_rng):
                torch.cuda.set_rng_state(state, d)
            outs.append(_bits(fn(*_clone(args), **_clone(kwargs))))
    a, b = outs
    same = len(a) == len(b) and all(
        (x[:2] == y[:2] and torch.equal(x[2], y[2]))
        if isinstance(x, tuple) and isinstance(y, tuple) else x == y
        for x, y in zip(a, b))
    if not same:
        raise AssertionError(
            f"{getattr(fn, '__name__', fn)} gave different bits on two calls "
            "from the same inputs and RNG state: hidden mutable state in "
            "the function")
