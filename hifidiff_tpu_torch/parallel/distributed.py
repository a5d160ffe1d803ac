"""Multi-process runtime support over `torch.distributed` (counterpart of
hifidiff_tpu/parallel/distributed.py).

The reference's only multi-device machinery is HF Accelerate, which (a)
initializes the process group, (b) shards the DataLoader across processes,
and (c) gates logging and checkpoints on `accelerator.is_main_process`
(reference `pretrain_denoiser.py:230,282-287,112-120`). The port's
equivalents:

  (a) `maybe_initialize()`: `torch.distributed.init_process_group` when the
      run is multi-process (explicit arguments, or the variables `torchrun`
      sets), a no-op otherwise;
  (b) `Loader(shard_index=process_index(), num_shards=process_count())`
      (data/core.py);
  (c) `is_main_process()` and `MetricsLogger`'s `main_only`.

One process drives one card (`torchrun --nproc_per_node N`): the rank's
card is `cuda:LOCAL_RANK`, and `devices.resolve_device` maps a bare "cuda"
to it once the group is up. Where GSPMD gives the JAX package its
collectives, the port calls them itself: the gradient all-reduce of
`train.steps.TrainState`, BatchNorm's global statistics
(`nn.layers.BatchNorm2d` under `parallel.sync_batch_norm`), and the gathers
here, which are written as `all_reduce`s of zero-filled slot buffers so that
gloo takes them on CUDA tensors too (its CUDA table has `broadcast`,
`all_reduce` and `barrier` only).

This is the only module of the port that reads `os.environ`: the
launcher's variables are its contract, as JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID are the JAX package's.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

def maybe_initialize(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     local_rank: Optional[int] = None,
                     device: Union[None, str, torch.device] = None) -> bool:
    """Start the default process group for a multi-process run; returns
    whether one is up.

    Explicit arguments win; otherwise torchrun's variables (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) start it; with neither
    it does nothing, so a CLI calls it unconditionally. The backend is
    `backend`, else nccl where `device` (default "cuda") is a CUDA device
    and gloo for the CPU. On CUDA the rank's card, `cuda:LOCAL_RANK`
    (`local_rank`, else LOCAL_RANK, else the rank), becomes the current
    device."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and world_size is None and rank is None \
            and "RANK" not in env:
        return False
    if init_method is None:
        init_method = (f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
                       if "MASTER_ADDR" in env else "env://")
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(env["RANK"]) if rank is None else rank
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    on_cuda = torch.device("cuda" if device is None else device).type \
        == "cuda"
    if backend is None:
        backend = "nccl" if on_cuda else "gloo"
    if on_cuda and torch.cuda.is_available():
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def _up() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index(group=None) -> int:
    """This process's rank in `group` (default: the whole run); 0 without a
    process group."""
    return dist.get_rank(group) if _up() else 0


def process_count(group=None) -> int:
    """The number of processes in `group` (default: the whole run); 1
    without a process group."""
    return dist.get_world_size(group) if _up() else 1


def is_main_process() -> bool:
    """The reference gates wandb, checkpoints and image dumps on
    `accelerator.is_main_process` (`pretrain_denoiser.py:112-120,207-210`);
    this is the port's equivalent."""
    return process_index() == 0


def barrier(group=None) -> None:
    """Wait for every process of `group`; a no-op without a process group."""
    if _up():
        dist.barrier(group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """`t` summed over `group`, in place, no gradient (a no-op for one
    process)."""
    if _up() and process_count(group) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def global_means(metrics: Dict[str, Union[float, torch.Tensor]], rows: int,
                 group=None, equal_rows: bool = False) -> Dict:
    """Means over the global batch from this process's `metrics`, each the
    mean over its own `rows` rows: row-weighted, in one float64 all-reduce,
    what a JAX mean over a batch sharded by `shard_batch` gives
    (wrap-padded rows counted). Floats come back as floats, tensors as
    tensors of their dtype on their device, with no host read unless
    `equal_rows`, which raises unless every process had as many rows (the
    train steps' precondition: `all_reduce_gradients` averages per-process
    means, and `global_rows` takes equal blocks of the draws). Unchanged
    without a group of more than one process."""
    if group is None or process_count(group) == 1:
        return dict(metrics)
    names = list(metrics)
    dev = comm_device(group)
    means = torch.stack([torch.as_tensor(metrics[k]).detach().to(
        dev, torch.float64).reshape(()) for k in names])
    # the row counts filled on the device, not copied from the host, so
    # that a CUDA graph can capture the call
    buf = torch.cat([means * rows, means.new_full((1,), rows),
                     means.new_full((1,), rows * rows)])
    all_reduce_sum(buf, group)
    if equal_rows:
        count, squares = float(buf[-2]), float(buf[-1])
        if process_count(group) * squares != count * count:
            raise ValueError(
                f"the processes of the data-parallel group hold local "
                f"batches of unequal size (this one {rows} rows, "
                f"{count:g} in all): a step needs equal ones, as the "
                f"sharded Loader gives them")
    out = {}
    for i, k in enumerate(names):
        mean = buf[i] / buf[-2]
        out[k] = mean.to(metrics[k].device, metrics[k].dtype) \
            if isinstance(metrics[k], torch.Tensor) else float(mean)
    return out


def comm_device(group=None) -> torch.device:
    """Where a host value goes to be reduced over `group`: the current card
    under nccl, else the CPU."""
    if _up() and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Concatenate every process's `x` along dim 0, rank 0's rows first
    (every process's `x` has the same shape): one `all_reduce` of a
    zero-filled buffer in which each process fills its own slot. No
    gradient."""
    n = process_count(group)
    if n == 1:
        return x
    b = x.shape[0]
    out = x.new_zeros((n * b,) + tuple(x.shape[1:]))
    r = process_index(group)
    out[r * b:(r + 1) * b] = x
    return all_reduce_sum(out, group)


def local_batch_to_global(batch, group=None):
    """Assemble the global batch from each process's local one (a tensor,
    an array or a dict of them), rank 0's rows first: the layout of
    `jax.make_array_from_process_local_data`, here materialized on every
    process (for a test or a rank-0 image dump). Numpy in, numpy out."""
    if isinstance(batch, dict):
        return {k: local_batch_to_global(v, group) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        return gather_rows(torch.from_numpy(np.ascontiguousarray(batch)),
                           group).numpy()
    return gather_rows(batch, group)


def global_rows(draw: Callable[[tuple], torch.Tensor], shape,
                group=None) -> torch.Tensor:
    """Draws for this process's rows of the global batch: `draw(shape)`
    with the leading extent multiplied by the group's size, then this
    process's block of rows. Every process draws from the same generator
    state, so together they hold what one process drawing for the
    concatenated batch holds (the JAX steps draw the global batch from one
    key, then shard it). One process: `draw(shape)` itself."""
    shape = tuple(shape)
    n = process_count(group)
    if n == 1:
        return draw(shape)
    r, b = process_index(group), shape[0]
    return draw((n * b,) + shape[1:])[r * b:(r + 1) * b]


BUCKET_BYTES = 25 * 2 ** 20


@torch.no_grad()
def all_reduce_gradients(params, group, bucket_bytes: int = BUCKET_BYTES
                         ) -> int:
    """Average the `.grad` of `params` over `group`: the gradients are
    copied into flat buckets of about `bucket_bytes` (one dtype and device
    each), one `all_reduce` (sum) a bucket, divided by the group's size and
    copied back. Each process's gradient is the mean over its own rows, so
    with equal local batches this is the gradient of the global-batch mean,
    which JAX's psum gives. Parameters without a gradient are left out;
    every process must hold gradients for the same parameters. Returns the
    number of buckets (all-reduces)."""
    n = process_count(group)
    grads = [p.grad for p in params if p.grad is not None]
    buckets, cur, size = [], [], 0
    for g in grads:
        if cur and (g.dtype != cur[0].dtype or g.device != cur[0].device
                    or size + g.numel() * g.element_size() > bucket_bytes):
            buckets.append(cur)
            cur, size = [], 0
        cur.append(g)
        size += g.numel() * g.element_size()
    if cur:
        buckets.append(cur)
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(n)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
    return len(buckets)


def sync_batch_norm(module: torch.nn.Module, group) -> int:
    """Make every `nn.layers.BatchNorm2d` below `module` take its training
    statistics over `group`'s global batch (None: each process's own);
    returns the number of BatchNorms. The group travels with the module
    tree, a deep copy shares it."""
    from hifidiff_tpu_torch.nn.layers import BatchNorm2d, _Shared

    found = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in found:
        m._sync = _Shared(group)
    return len(found)
