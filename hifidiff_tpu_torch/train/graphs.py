"""A train step captured as CUDA graphs: the counterpart of the JAX CLIs'
`jax.jit(step, donate_argnums=0)`, which compiles a whole optimizer step
into one XLA program that updates the state in place.

`capture_train_step(step, state, batch, ...)` takes any step that
`train/steps.py` or `train/distill.py` makes and returns a
`CapturedTrainStep`; its `run(batch, generator=...)` is one call of the
eager `step(state, batch, generator=...)`: forward, backward, the gradient
all-reduce of an NCCL group, the optimizer, the EMA, and on the host the
schedule and the counters. With the same generator a replay gives the
eager step's bits where the optimizer is the same (`capturable=True`,
`optim.adam` / `optim.adamw_cosine`).

  * Static buffers: the batch (a tensor or a dict of tensors, its shapes
    fixed at capture) and every random input of the step (posterior noise,
    noise, timesteps, the distillation steps' draws). The first call records
    what the step draws, by name and in order (`steps.DRAWS`); a replay
    draws the same from the caller's generator outside the graph, in the
    eager step's order (host draws such as the stratified student steps
    included), and copies them and the batch into the buffers. A draw that
    is given as a keyword is copied in instead, as the eager step takes it.
  * Warm-up: the first call of each kind (applying the update or not) is
    the state's own step, run eagerly on the capture stream from the
    caller's generator, so that the kernel library, cuDNN / cuBLAS
    workspaces, the optimizer state and the gradients are built outside
    the capture; then that call's graph is captured, which runs nothing.
    The body is the step with `TrainState.graph_applies` set: the gradients
    are zeroed in place, not dropped, and keep their addresses.
  * Accumulation (`accumulate_steps` > 1): two graphs, accumulate only and
    accumulate then apply (divide, step, zero); the host picks one by
    `mini_step` as `TrainState.apply_gradients` counts, and advances the
    schedule after an applying call (`optim.CosineRate` writes the
    device-tensor rate the next replay reads). The EMA follows every call.
  * The state key (`StateKey`): a capture holds for the tensors it was
    made on, the parameters (and their `requires_grad`), buffers,
    gradients, optimizer state, rate, EMA and the teacher's tensors. After
    `load_state_dict` (a resume), `.to()` or a freeze change `run` raises
    until the caller captures again; so does every call after a warm-up or
    a capture that raised.
  * Data parallelism: an NCCL group's all-reduces run inside the graph; the
    equal-rows check of `global_means` reads the host, so it runs in the
    warm-up only (the shapes are fixed). A gloo group cannot be captured and
    is refused; so is the CPU, and a batch of other shapes than the
    capture's (an epoch's last batch without `drop_last`): nothing runs
    eagerly in a replay's place.
  * `ops.kernels.LAUNCHES` counts the warm-up's and the capture's launches,
    never a replay's (`replays` counts those).

`capture=False` builds the same buffers and draws and runs the body eagerly
where a replay would run: the CPU's check of the mechanism (torch captures
no graph there), asked for by name.
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from hifidiff_tpu_torch.train.optim import CosineRate
from hifidiff_tpu_torch.train.steps import DRAWS, Metrics, TrainState

Batch = Union[torch.Tensor, Dict[str, torch.Tensor]]


def batch_signature(batch: Batch) -> Tuple:
    """What a capture fixes of a batch: its keys, shapes and dtypes."""
    if isinstance(batch, torch.Tensor):
        return (None, tuple(batch.shape), batch.dtype)
    return tuple(sorted((k, tuple(v.shape), v.dtype)
                        for k, v in batch.items()))


class StateKey:
    """What the graphs of a capture read and write of `state` and of the
    distillation steps' frozen `teacher`, cheap enough to be checked before
    every replay (lists over the tensors gathered at capture, no walk of
    the module tree): by address every parameter (with its `requires_grad`
    and gradient), buffer and teacher tensor; by identity the module, the
    optimizer, its state (which `load_state_dict` replaces, with every
    tensor in it), each group's rate tensor and the EMA's dict (replaced
    the same way); the groups' `capturable` flags, the accumulation, the
    EMA decay and the group. A gradient not made yet stands as None: no
    graph captured so far reads it."""

    def __init__(self, state: TrainState, teacher: Optional[nn.Module] = None):
        self.state = state
        self.params = list(state.module.parameters())
        self.buffers = [m._buffers for m in state.module.modules()]
        if teacher is not None:
            self.params += [p for p in teacher.parameters()]
            self.buffers += [m._buffers for m in teacher.modules()]
        self.objects, self.values = self.read()

    def read(self) -> Tuple[Tuple, Tuple]:
        st, opt = self.state, self.state.optimizer
        objects = (st.module, opt, opt.state, st.ema_params,
                   *(g["lr"] if isinstance(g["lr"], torch.Tensor) else None
                     for g in opt.param_groups))
        values: List = []
        for p in self.params:
            g = p.grad
            values += (p.data_ptr(), p.requires_grad,
                       None if g is None else g.data_ptr())
        values += [b.data_ptr() for d in self.buffers for b in d.values()
                   if b is not None]
        values += [(g.get("capturable"), len(g["params"]))
                   for g in opt.param_groups]
        values += (st.accumulate_steps, st.ema_decay, st.group)
        return objects, tuple(values)

    def holds(self) -> bool:
        """Whether the graphs captured under this key hold for the state as
        it is now: every address they read is where it was. What the key
        holds as None was made later (a gradient: another kind of call's
        warm-up, or another capture's on the same state)."""
        objects, values = self.read()
        old = self.values
        return len(objects) == len(self.objects) and all(
            a is b for a, b in zip(objects, self.objects)) and (
            old == values or (len(old) == len(values) and all(
                o is None or o == n for o, n in zip(old, values))))

    def update(self) -> None:
        self.objects, self.values = self.read()


def _static(batch: Batch, device: torch.device) -> Batch:
    if isinstance(batch, torch.Tensor):
        return batch.detach().to(device, copy=True)
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"capture_train_step: batch[{k!r}] is a "
                            f"{type(v).__name__}; a capture takes tensors")
    return {k: v.detach().to(device, copy=True) for k, v in batch.items()}


@torch.no_grad()
def _load(static: Batch, batch: Batch) -> None:
    if isinstance(static, torch.Tensor):
        static.copy_(batch)
        return
    for k, v in static.items():
        v.copy_(batch[k])


def _refuse(state: TrainState, capture: bool) -> None:
    if not capture:
        return
    if state.group is not None and dist.get_backend(state.group) != "nccl":
        raise RuntimeError(
            "capture_train_step: the data-parallel group runs on "
            f"{dist.get_backend(state.group)}, whose collectives run on the "
            "host and cannot be captured in a CUDA graph; use nccl, or the "
            "eager step")
    if state.device.type != "cuda":
        raise RuntimeError(
            "capture_train_step: CUDA graphs need the card, and the state "
            f"is on {state.device}; run the eager step there (capture=False "
            "runs the captured step's body eagerly)")
    if not all(g.get("capturable") for g in state.optimizer.param_groups):
        raise ValueError(
            "capture_train_step: the optimizer is not capturable; build it "
            "with optim.adam or optim.adamw_cosine(..., capturable=True)")
    if state.scheduler is not None \
            and not isinstance(state.scheduler, CosineRate):
        raise ValueError(
            "capture_train_step: the schedule must write a device-tensor "
            "rate (optim.adamw_cosine(..., capturable=True) makes one), not "
            f"a {type(state.scheduler).__name__}")


class CapturedTrainStep:
    """What `capture_train_step` returns: `run(batch, generator=None,
    **draws) -> (state, metrics)`, the metrics as fresh device tensors.
    `graphs` maps `applies` (True: the update is applied) to (graph, its
    metric outputs) for each kind of call captured so far; `draws` holds the
    random inputs' buffers by name, in the order the step draws them (empty
    until the first call); `replays` counts the calls that replayed."""

    def __init__(self, step: Callable, state: TrainState, batch: Batch,
                 teacher: Optional[nn.Module] = None, capture: bool = True):
        _refuse(state, capture)
        self.step, self.state, self.teacher = step, state, teacher
        self.capture = capture
        self.replays = 0
        self.batch = _static(batch, state.device)
        self.signature = batch_signature(batch)
        self.graphs: Dict[bool, Tuple[torch.cuda.CUDAGraph, Metrics]] = {}
        self.warm: set = set()         # the kinds of call run once
        self.draw_fns: Optional[List[Tuple[str, Callable]]] = None
        self.draws: Dict[str, torch.Tensor] = {}
        params = inspect.signature(step).parameters
        # the keywords the step takes (None: any)
        self.keywords = None if any(p.kind is p.VAR_KEYWORD
                                    for p in params.values()) \
            else set(params)
        self.takes_generator = self.keywords is None \
            or "generator" in self.keywords
        self.stream = torch.cuda.Stream(state.device) if capture else None
        self.pool = torch.cuda.graph_pool_handle() if capture else None
        self.key: Optional[StateKey] = StateKey(state, teacher)

    @contextlib.contextmanager
    def _on_stream(self):
        """The capture stream, ordered after the caller's work and before
        what the caller queues next."""
        if not self.capture:
            yield
            return
        here = torch.cuda.current_stream(self.state.device)
        self.stream.wait_stream(here)
        try:
            with torch.cuda.stream(self.stream):
                yield
        finally:
            here.wait_stream(self.stream)

    def _body(self, applies: bool, kwargs: Dict) -> Metrics:
        st = self.state
        args = (self.batch,) if self.teacher is None \
            else (self.teacher, self.batch)
        st.graph_applies = applies
        try:
            _, metrics = self.step(st, *args, **kwargs)
        finally:
            st.graph_applies = None
        return metrics

    def _warm_up(self, applies: bool, generator, draws) -> Metrics:
        """The state's step of this kind, eagerly, drawing as the eager step
        draws; the first one records the draws and makes their buffers."""
        kwargs = dict(draws)
        if self.takes_generator:
            kwargs["generator"] = generator
        seen: List = []
        token = DRAWS.set(seen) if self.draw_fns is None else None
        try:
            with self._on_stream():
                metrics = self._body(applies, kwargs)
        finally:
            if token is not None:
                DRAWS.reset(token)
        if token is not None:
            names = [what for what, _, _ in seen]
            if set(draws) - set(names) or len(set(names)) != len(names):
                raise ValueError(f"capture_train_step: the step draws "
                                 f"{names}; given {sorted(draws)}")
            self.draw_fns = [(what, fn) for what, fn, _ in seen]
            self.draws = {what: torch.empty_like(v) for what, _, v in seen}
        if self.capture:      # made on the capture stream, read on this one
            here = torch.cuda.current_stream(self.state.device)
            for v in metrics.values():
                v.record_stream(here)
        return metrics

    def _capture(self, applies: bool) -> None:
        graph = torch.cuda.CUDAGraph()
        with self._on_stream(), torch.cuda.graph(graph, pool=self.pool,
                                                 stream=self.stream):
            out = self._body(applies, self.draws)
        self.graphs[applies] = (graph, out)

    @torch.no_grad()
    def _draw(self, generator, draws) -> None:
        for what, fn in self.draw_fns:
            buf = self.draws[what]
            if what in draws:
                if tuple(draws[what].shape) != tuple(buf.shape):
                    raise ValueError(f"{what} must be {tuple(buf.shape)}, "
                                     f"got {tuple(draws[what].shape)}")
                buf.copy_(draws[what])
            elif generator is None:
                raise ValueError(f"pass {what} or a torch.Generator to "
                                 "draw it from")
            else:
                buf.copy_(fn(generator))

    def _advance(self, applies: bool) -> None:
        """The host's part of `TrainState.apply_gradients`."""
        st = self.state
        st.mini_step = 0 if applies else st.mini_step + 1
        if applies and st.scheduler is not None:
            st.scheduler.step()
        st.step += 1

    def drop(self) -> None:
        """Release the graphs; a later `run` raises."""
        self.graphs.clear()
        self.key = None

    def run(self, batch: Batch, generator: Optional[torch.Generator] = None,
            **draws) -> Tuple[TrainState, Metrics]:
        st = self.state
        if self.key is None:
            raise RuntimeError("CapturedTrainStep.run: the capture was "
                               "dropped; capture the step again")
        if not self.key.holds():
            self.drop()
            raise RuntimeError(
                "CapturedTrainStep.run: the state's tensors are not the ones "
                "the graphs were captured on (load_state_dict, .to(), a "
                "freeze change or a new optimizer): the capture is dropped; "
                "capture the step again")
        if batch_signature(batch) != self.signature:
            raise ValueError(
                f"CapturedTrainStep.run: a batch of {batch_signature(batch)} "
                f"for a capture of {self.signature}: a capture holds for one "
                "batch shape (an epoch's last batch without drop_last needs "
                "its own)")
        bad = sorted(set(draws) - set(self.draws)) \
            if self.draw_fns is not None else \
            sorted(set(draws) - (self.keywords or set(draws)))
        if bad:
            raise ValueError(f"CapturedTrainStep.run: {bad} are not draws of "
                             "the step" + (f" (it draws {list(self.draws)})"
                                           if self.draw_fns is not None
                                           else ""))
        _load(self.batch, batch)
        applies = st.mini_step + 1 == st.accumulate_steps
        if applies in self.warm:
            self._draw(generator, draws)
            if self.capture:
                graph, out = self.graphs[applies]
                graph.replay()
                metrics = {k: v.clone() for k, v in out.items()}
            else:
                metrics = self._body(applies, self.draws)
            self.replays += 1
            self._advance(applies)
        else:
            try:
                metrics = self._warm_up(applies, generator, draws)
                self._advance(applies)
                if self.capture:
                    self._capture(applies)
            except BaseException:
                self.drop()
                raise
            self.warm.add(applies)
            self.key.update()
        if not st.module.training:     # the eager step leaves it so
            st.module.train()
        return st, metrics


def capture_train_step(step: Callable, state: TrainState, batch: Batch, *,
                       teacher: Optional[nn.Module] = None,
                       capture: bool = True) -> CapturedTrainStep:
    """Capture `step` (a `make_*_train_step` factory's) on `state` for
    batches shaped as `batch`; `teacher` is the distillation steps' frozen
    teacher (their second argument). Nothing runs until the first `run`,
    which is the state's step and the capture's warm-up (see the module).
    Raises on the CPU, for a gloo group and for an optimizer that is not
    capturable; a warm-up or a capture that fails raises out of `run`.
    With `capture=False` the body runs eagerly instead."""
    return CapturedTrainStep(step, state, batch, teacher=teacher,
                             capture=capture)
