"""Process meshes, batch placement and parameter replication (counterpart
of hifidiff_tpu/parallel/mesh.py).

The JAX package declares shardings over a `jax.sharding.Mesh` and lets
GSPMD insert the collectives. The port runs one process per card, so a mesh
is a layout of the run's ranks with a process group per axis:

  * "data": batch sharding, the workload's scaling axis (the reference's
    only strategy, HF Accelerate DDP); the gradient all-reduce and
    BatchNorm's global statistics run over this axis's group;
  * "model": optional channel sharding of the wide layers
    (`parallel.tp.shard_params_tp`).

Ranks are laid out as the JAX package lays out devices,
`np.arange(n).reshape(shape)`: with axes ("data", "model") and shape
(2, 2), ranks 0 and 1 form data row 0's model group, ranks 0 and 2 model
column 0's data group.
"""

from __future__ import annotations

import collections
import itertools
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from hifidiff_tpu_torch.parallel.distributed import (gather_rows,
                                                     process_count,
                                                     process_index)


class Mesh:
    """The ranks of a run laid out over named axes. `shape` is the JAX
    mesh's dict ({"data": 2, "model": 2}), so code reading
    `mesh.shape["data"]` ports line for line; `groups[axis]` is the process
    group of this rank's line along `axis` (None for a single process),
    `index[axis]` this rank's position on it."""

    def __init__(self, axes: Sequence[str], shape: Sequence[int],
                 groups: Dict[str, object], index: Dict[str, int]):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, (int(s) for s in shape)))
        self.groups = groups
        self.index = index

    @property
    def data_group(self):
        return self.groups.get("data")

    @property
    def model_group(self):
        return self.groups.get("model")

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, index={self.index})"


def make_mesh(n: Optional[int] = None, axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the run's `n` processes (default: all of them). With the
    default single axis the shape is (n,); pass axes=("data", "model") and
    a shape for DP x TP. Every process must call it, in the same order as
    every other `new_group`: it makes one group per line of every axis."""
    world = process_count()
    n = world if n is None else int(n)
    if n != world:
        raise ValueError(f"a mesh of {n} processes in a run of {world}: "
                         "the port runs one process per card, and a mesh "
                         "spans every process")
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} over axes {tuple(axes)} does "
                         f"not hold {n} processes")
    ranks = np.arange(n).reshape(shape)
    me = process_index()
    where = tuple(int(i) for i in np.argwhere(ranks == me)[0])
    groups: Dict[str, object] = {}
    for k, axis in enumerate(axes):
        lines = np.moveaxis(ranks, k, -1).reshape(-1, shape[k])
        for line in lines:
            line = [int(r) for r in line]
            group = dist.new_group(line) if n > 1 else None
            if me in line:
                groups[axis] = group
    return Mesh(axes, shape, groups, dict(zip(axes, where)))


def wrap_pad_leading(xa: np.ndarray, multiple: int) -> np.ndarray:
    """Pad axis 0 up to a multiple of `multiple` by repeating the array
    (DistributedSampler's wrap): a plain `xa[:pad]` would clip when pad > n
    (a final local batch of 1 padding to a multiple of 4) and under-pad."""
    if xa.ndim < 1 or xa.shape[0] % multiple == 0:
        return xa
    pad = -xa.shape[0] % multiple
    idx = np.arange(xa.shape[0] + pad) % xa.shape[0]
    return xa[idx]


def to_device(batch: Dict[str, np.ndarray],
              device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """A loader's batch on `device`: NHWC image arrays (B, H, W, C) become
    NCHW tensors, patch stacks (B, P, H, W, C) become (B, P, C, H, W)."""
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        if t.ndim in (4, 5):
            t = t.movedim(-1, -3).contiguous()
        out[k] = t
    return out


def shard_batch(batch: Dict[str, np.ndarray],
                device: Union[str, torch.device],
                multiple: int = 1) -> Dict[str, torch.Tensor]:
    """This process's rows of the global batch on its card (`to_device`'s
    layout), each leaf wrap-padded up to `multiple` rows: the local device
    multiple, which is 1 with one card per process (the JAX package pads to
    its process's device count). Every process's Loader yields the same
    batch sizes, so every process pads alike."""
    return to_device({k: wrap_pad_leading(np.asarray(v), multiple)
                      for k, v in batch.items()}, device)


def device_prefetch(iterator, device: Union[str, torch.device],
                    depth: int = 2, multiple: int = 1):
    """Wrap a host batch iterator so that the next `depth` batches are
    already on the card while the current one trains (`shard_batch`'s
    layout): on CUDA each batch is copied from pinned host memory on a side
    stream, and the consuming stream waits for that copy's event before it
    gets the batch; on the CPU it is `shard_batch` one batch ahead."""
    device = torch.device(device)
    it = iter(iterator)
    if device.type != "cuda":
        for batch in it:
            yield shard_batch(batch, device, multiple)
        return
    stream = torch.cuda.Stream(device)

    def put(batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(
            wrap_pad_leading(np.asarray(v), multiple))).pin_memory()
            for k, v in batch.items()}
        with torch.cuda.stream(stream):
            out = {}
            for k, t in host.items():
                t = t.to(device, non_blocking=True)
                if t.ndim in (4, 5):
                    t = t.movedim(-1, -3).contiguous()
                out[k] = t
            event = torch.cuda.Event()
            event.record(stream)
        return out, event, host

    queue = collections.deque(put(b) for b in itertools.islice(it, depth))
    while queue:
        out, event, _host = queue.popleft()
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for t in out.values():
            t.record_stream(current)
        nxt = next(it, None)
        if nxt is not None:
            queue.append(put(nxt))
        yield out


@torch.no_grad()
def replicate_global(module: torch.nn.Module, group=None) -> None:
    """Make every process of `group` hold rank 0's parameters and buffers:
    first check that they already agree (same-seed init or the same
    checkpoint, as the JAX package requires), then broadcast them from the
    group's first rank so that they agree bit for bit. Raises, on every
    process, where a tensor differs. A no-op for one process."""
    if group is None or process_count(group) == 1:
        return
    tensors = list(itertools.chain(module.parameters(), module.buffers()))
    sums = torch.stack([t.double().sum() for t in tensors])
    every = gather_rows(sums[None], group).cpu()
    differ = [i for i in range(len(tensors))
              if not bool((every[:, i] == every[0, i]).all())]
    if differ:
        names = [n for n, _ in itertools.chain(module.named_parameters(),
                                                module.named_buffers())]
        raise ValueError(
            "replicate_global: the processes hold different values of "
            f"{[names[i] for i in differ[:8]]}; build them from one seed "
            "or one checkpoint")
    src = dist.get_global_rank(group, 0)
    for t in tensors:
        dist.broadcast(t.data, src, group=group)
