"""Checkpoint / resume with `torch.save`, and the composition of a refiner
from the earlier stages' weights (counterpart of
hifidiff_tpu/train/checkpoint.py, which keeps orbax directories).

A checkpoint is one file `step_<n>.pt` holding `TrainState.state_dict()`
(module, optimizer, schedule, step, accumulated gradients, EMA) and an
optional `extra` dict. `CheckpointManager` keeps the last `max_to_keep` of
them in a directory.

`compose_refiner` is the reference's composition-time wiring
(`models/refiner.py:18-25`) as a `strict=False` overlay: IDC weights from a
stage-2 state dict, and one stage-3 denoiser state dict that feeds both
`denoiser.` and, by name and shape overlap, `fpg.`; whatever is missing or of
another shape keeps its fresh init.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Optional, Union

import torch
from torch import nn

from hifidiff_tpu_torch.train.steps import TrainState

StateDict = Mapping[str, torch.Tensor]


def save_state(path: str, state: TrainState,
               extra: Optional[Dict] = None) -> None:
    tmp = f"{path}.tmp"
    torch.save({"state": state.state_dict(), "extra": extra or {}}, tmp)
    os.replace(tmp, path)


def restore_state(path: str, state: TrainState) -> Dict:
    """Load the checkpoint file at `path` into `state` (module, optimizer,
    schedule, counters, EMA), in place; returns its `extra` dict."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint file at {path}")
    payload = torch.load(path, map_location=state.device, weights_only=True)
    state.load_state_dict(payload["state"])
    return payload["extra"]


class CheckpointManager:
    """Step-stamped checkpoint files in one directory, the last
    `max_to_keep` kept. `create=False` opens the directory read-only and
    raises if it does not exist."""

    _PATTERN = re.compile(r"step_(\d+)\.pt$")

    def __init__(self, directory: str, max_to_keep: int = 5,
                 create: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if create:
            os.makedirs(self.directory, exist_ok=True)
        elif not os.path.isdir(self.directory):
            raise FileNotFoundError(
                f"checkpoint directory does not exist: {self.directory}")

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def steps(self) -> List[int]:
        found = (self._PATTERN.match(f) for f in os.listdir(self.directory))
        return sorted(int(m[1]) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             extra: Optional[Dict] = None) -> None:
        """Write step `step`; in a multi-process run only the main process
        writes (the reference's `accelerator.is_main_process` gating)."""
        from hifidiff_tpu_torch.parallel.distributed import is_main_process

        if not is_main_process():
            return
        save_state(self.path(step), state, extra)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> Optional[Dict]:
        """Load `step` (the latest when None) into `state`; returns the
        checkpoint's `extra` dict, or None when the directory holds none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return restore_state(self.path(step), state)


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file as a flat state dict; unwraps the reference's
    `{"model_state_dict": ...}` (`train_cr.py:193-201`)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("model_state_dict", sd) if isinstance(sd, dict) else sd


def _overlay(module: nn.Module, loaded: StateDict) -> List[str]:
    """`load_state_dict(strict=False)` that also keeps the init where the
    shapes differ; returns the names it loaded."""
    own = module.state_dict()
    take = {k: v for k, v in loaded.items()
            if k in own and tuple(own[k].shape) == tuple(v.shape)}
    module.load_state_dict(take, strict=False)
    return sorted(take)


def _sub(sd: StateDict, prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def compose_refiner(refiner: nn.Module,
                    idc: Union[None, str, StateDict] = None,
                    denoiser: Union[None, str, StateDict] = None
                    ) -> Dict[str, List[str]]:
    """Overlay stage checkpoints onto a fresh FacialRefiner, in place.

    `idc`: an IDC state dict (or its file). `denoiser`: a stage-3 Denoiser
    state dict (or file), whose names feed the refiner's `denoiser.` and,
    where name and shape agree (intro, encoder blocks, down-convs), its
    `fpg.`; or a saved FacialRefiner (names under `denoiser.`, `fpg.`,
    `idc.`), routed by prefix, its `idc.` part used unless `idc` is given.
    Returns the loaded names per submodule."""
    def read(src):
        return load_state_dict_file(src) if isinstance(src, str) else src

    loaded: Dict[str, List[str]] = {"idc": [], "denoiser": [], "fpg": []}
    if idc is not None:
        loaded["idc"] = _overlay(refiner.idc, read(idc))
    if denoiser is not None:
        sd = read(denoiser)
        if any(k.startswith(("denoiser.", "fpg.", "idc.")) for k in sd):
            loaded["denoiser"] = _overlay(refiner.denoiser,
                                          _sub(sd, "denoiser."))
            loaded["fpg"] = _overlay(refiner.fpg, _sub(sd, "fpg."))
            if idc is None:
                loaded["idc"] = _overlay(refiner.idc, _sub(sd, "idc."))
        else:
            loaded["denoiser"] = _overlay(refiner.denoiser, sd)
            loaded["fpg"] = _overlay(refiner.fpg, sd)
    return loaded
