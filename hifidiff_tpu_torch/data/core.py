"""Dataset protocol + threaded prefetching loader (counterpart of
hifidiff_tpu/data/core.py, numpy only).

Samples are dicts of float32 NHWC numpy arrays; the loader shuffles per
epoch with numpy's seeded PRNG, drawing exactly as the JAX package's loader
does (same order and shuffles for a seed), assembles batches on a thread
pool and keeps a bounded prefetch queue so that host work overlaps device
compute. A caller moves a batch to the card with `torch.from_numpy(...)
.to(device)`.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

Sample = Dict[str, np.ndarray]


class Dataset:
    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int) -> Sample:
        raise NotImplementedError


class ConcatDataset(Dataset):
    """Concatenation of datasets (`torch ConcatDataset` equivalent, used for
    MultiPIE-HQ + CelebA-HQ denoiser pretraining, `pretrain_denoiser.py:241`)."""

    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, index: int) -> Sample:
        d = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return self.datasets[d][index - int(self._offsets[d])]


class ArrayDataset(Dataset):
    """In-memory dataset over a dict of equally-long numpy arrays (the
    torch `TensorDataset` equivalent). Used by the latent-moments cache in
    stage-3 pretraining (`cli/pretrain_denoiser.py --cache-latents`)."""

    def __init__(self, arrays: Dict[str, np.ndarray]):
        lens = {k: len(v) for k, v in arrays.items()}
        assert len(set(lens.values())) == 1, f"ragged arrays: {lens}"
        self.arrays = dict(arrays)
        self._n = next(iter(lens.values()))

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, index: int) -> Sample:
        return {k: v[index] for k, v in self.arrays.items()}


def _collate(samples: List[Sample]) -> Sample:
    out: Sample = {}
    for k in samples[0]:
        v0 = samples[0][k]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack([s[k] for s in samples])
        else:
            out[k] = np.asarray([s[k] for s in samples])
    return out


class Loader:
    """Seeded, threaded, prefetching batch iterator.

    Multi-process data parallelism (the Accelerate-sharded-DataLoader
    equivalent, reference `pretrain_denoiser.py:282-287`): pass
    `shard_index=rank, num_shards=world_size` and
    each process iterates a disjoint stride-slice of the SAME seeded
    global shuffle (all processes must use the same seed). The order is
    padded to a multiple of num_shards (torch DistributedSampler
    semantics) so every process yields the same number of batches —
    collective programs never deadlock on a ragged tail. `batch_size` is
    the PER-PROCESS batch.
    """

    def __init__(self, dataset: Dataset, batch_size: int,
                 shuffle: bool = True, drop_last: bool = False,
                 seed: int = 0, num_threads: int = 4,
                 prefetch: int = 4, shard_index: Optional[int] = None,
                 num_shards: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.epoch = 0
        self.shard_index = 0 if shard_index is None else int(shard_index)
        self.num_shards = 1 if num_shards is None else int(num_shards)
        if not (0 <= self.shard_index < self.num_shards):
            raise ValueError(
                f"shard_index {self.shard_index} not in "
                f"[0, {self.num_shards})")

    def _shard_len(self) -> int:
        n = len(self.dataset)
        if self.num_shards == 1:
            return n
        return (n + self.num_shards - 1) // self.num_shards

    def __len__(self) -> int:
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(order)
        if self.num_shards > 1:
            per = self._shard_len()
            # wrap-pad cyclically like torch DistributedSampler — np.resize
            # repeats `order` as many times as needed, which matters when
            # pad > n (tiny dataset, many shards): a single order[:pad]
            # slice would underfill and leave shards with UNEQUAL batch
            # counts, deadlocking collective programs on the missing
            # batches
            order = np.resize(order, per * self.num_shards)
            order = order[self.shard_index::self.num_shards]
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[Sample]:
        batches = self._batch_indices()
        self.epoch += 1
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        lock = threading.Lock()
        cursor = {"i": 0}
        results: Dict[int, Optional[Sample]] = {}
        cond = threading.Condition()

        def worker():
            while not stop.is_set():
                with lock:
                    i = cursor["i"]
                    if i >= len(batches):
                        return
                    cursor["i"] = i + 1
                try:
                    batch = _collate([self.dataset[int(j)] for j in batches[i]])
                except Exception as e:  # surface loader errors to consumer
                    batch = e  # type: ignore[assignment]
                with cond:
                    results[i] = batch  # type: ignore[assignment]
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                with cond:
                    while i not in results:
                        cond.wait(timeout=0.1)
                        if not any(t.is_alive() for t in threads) \
                                and i not in results:
                            raise RuntimeError("loader workers died")
                    batch = results.pop(i)
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
