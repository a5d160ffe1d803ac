"""Observability: metrics logging, image-grid dumps and profiling hooks
(counterpart of hifidiff_tpu/utils/logging.py).

A pluggable MetricsLogger (stdout + JSONL always; wandb only if installed and
requested), a grid writer that writes the PNG itself with `zlib` (no PIL), a
`torch.profiler` trace scope, and a step timer that waits for the card
before it reads the clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
import time
import zlib
from typing import Dict, Optional

import numpy as np
import torch


class MetricsLogger:
    def __init__(self, log_dir: str, project: str, run_name: str = "run",
                 use_wandb: bool = False, stdout_every: int = 50,
                 main_only: bool = True):
        """main_only: in a `torch.distributed` run only rank 0 writes
        (JSONL / stdout / wandb), the reference's
        `accelerator.is_main_process` gating (`pretrain_denoiser.py:112-120`);
        the other ranks get no-op loggers."""
        self.enabled = not (main_only and torch.distributed.is_available()
                            and torch.distributed.is_initialized()
                            and torch.distributed.get_rank() != 0)
        if not self.enabled:
            self._f = None
            self._wandb = None
            self.stdout_every = 0
            return
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{project}.{run_name}.jsonl")
        self._f = open(self.path, "a")
        self.stdout_every = stdout_every
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # type: ignore

                self._wandb = wandb
                wandb.init(project=project, name=run_name)
            except ImportError:
                print("[logger] wandb not installed; JSONL/stdout only")

    def log(self, metrics: Dict, step: int) -> None:
        if not self.enabled:
            return
        rec = {"step": step, "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self.stdout_every and step % self.stdout_every == 0:
            msg = " ".join(f"{k}={float(v):.5g}" for k, v in metrics.items())
            print(f"[step {step}] {msg}", flush=True)

    def close(self):
        if self._f is not None:
            self._f.close()
        if self._wandb is not None:
            self._wandb.finish()


def save_image_grid(images: np.ndarray, path: str,
                    nrow: Optional[int] = None, pad: int = 2) -> None:
    """(B, H, W, C) float [0,1] -> one grid PNG (save_image equivalent), 8
    bits a channel, RGB for C 3 and grey for C 1: the JAX package's grid,
    written without PIL. In a `torch.distributed` run only rank 0 writes,
    as the reference's image dumps are gated on the main process."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_rank():
        return
    b, h, w, c = images.shape
    nrow = nrow or max(1, int(np.ceil(np.sqrt(b))))
    ncol = int(np.ceil(b / nrow))
    grid = np.zeros((ncol * (h + pad) + pad, nrow * (w + pad) + pad, c),
                    dtype=np.float32)
    for i in range(b):
        r, col = divmod(i, nrow)
        y0 = r * (h + pad) + pad
        x0 = col * (w + pad) + pad
        grid[y0:y0 + h, x0:x0 + w] = images[i]
    arr = (np.clip(grid, 0, 1) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(arr[..., 0] if c == 1 else arr))


def png_bytes(arr: np.ndarray) -> bytes:
    """A uint8 (H, W) grey or (H, W, 3) RGB array as a PNG file's bytes:
    one IDAT chunk of unfiltered rows."""
    if arr.dtype != np.uint8 or not (arr.ndim == 2 or (
            arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"png_bytes takes uint8 (H, W) or (H, W, 3), got "
                         f"{arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    color = 0 if arr.ndim == 2 else 2
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def side_by_side(*batches: np.ndarray) -> np.ndarray:
    """Concatenate same-shape NHWC batches horizontally per sample, the
    reference's `[input | pred | gt]` dump convention
    (`train_cr.py:83-91`)."""
    return np.concatenate(batches, axis=2)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """A `torch.profiler` scope (the host's operators, and the card's kernels
    where CUDA is available) whose Chrome trace is written to
    `log_dir/trace.json` at the end; a no-op when log_dir is None."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling per-step wall-time tracker for train loops. Each tick waits
    for the work queued on the card (when CUDA is in use) before it reads the
    clock, so a step's time is its own and not its enqueue time."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list = []
        self._last = None

    def tick(self) -> Optional[float]:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self._times)) if self._times else 0.0
