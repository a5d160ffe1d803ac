"""Datasets and the prefetching loader (counterpart of hifidiff_tpu/data/):
the numpy `Dataset` protocol, `Loader`, and the procedural face family."""

from hifidiff_tpu_torch.data.core import (ArrayDataset, ConcatDataset,
                                          Dataset, Loader, Sample)
from hifidiff_tpu_torch.data.procedural import ProceduralFaceDataset

__all__ = ["ArrayDataset", "ConcatDataset", "Dataset", "Loader", "Sample",
           "ProceduralFaceDataset"]
