"""Data and tensor parallelism over `torch.distributed` (counterpart of
hifidiff_tpu/parallel/): one process per card, launched by `torchrun
--nproc_per_node N`."""

from hifidiff_tpu_torch.parallel.distributed import (
    all_reduce_gradients,
    barrier,
    gather_rows,
    global_means,
    global_rows,
    is_main_process,
    local_batch_to_global,
    maybe_initialize,
    process_count,
    process_index,
    sync_batch_norm,
)
from hifidiff_tpu_torch.parallel.mesh import (
    Mesh,
    device_prefetch,
    make_mesh,
    replicate_global,
    shard_batch,
    wrap_pad_leading,
)
from hifidiff_tpu_torch.parallel.tp import shard_params_tp, tp_spec_for

__all__ = ["Mesh", "make_mesh", "replicate_global", "shard_batch",
           "device_prefetch", "wrap_pad_leading", "shard_params_tp",
           "tp_spec_for", "maybe_initialize", "is_main_process",
           "process_index", "process_count", "barrier", "gather_rows",
           "global_means", "global_rows", "local_batch_to_global",
           "all_reduce_gradients", "sync_batch_norm"]
