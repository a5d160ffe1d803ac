"""Where the port's entry points run: on the card unless the caller asks for
the CPU."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[None, str, torch.device],
                   who: str) -> torch.device:
    """`None` means `torch.device("cuda")`. Raises when a CUDA device is
    wanted and there is none: the CPU is used only when asked for with
    `device="cpu"`. Once a process group is up, a CUDA device without an
    index is the rank's card, `cuda:LOCAL_RANK`, which
    `parallel.maybe_initialize` made the current device."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device; it runs on the card unless "
            "device=\"cpu\" is passed")
    if device.type == "cuda" and device.index is None \
            and torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        device = torch.device("cuda", torch.cuda.current_device())
    return device
