"""Datasets and the prefetching loader (counterpart of hifidiff_tpu/data/):
the numpy `Dataset` protocol, `Loader`, the procedural face family, and the
Multi-PIE and CelebA-HQ datasets on PNG trees (K-Face, all JPEG, waits for
the codec slice: ROADMAP §A9.2, step 3)."""

from hifidiff_tpu_torch.data.core import (ArrayDataset, ConcatDataset,
                                          Dataset, Loader, Sample)
from hifidiff_tpu_torch.data.multipie import (MultiPIEDataset,
                                              MultiPIEIDCDataset,
                                              MultiPIEInferenceDataset,
                                              MultiPIESingleViewDataset)
from hifidiff_tpu_torch.data.pretraining import (CelebAHQDataset,
                                                 MultiPIEHQDataset)
from hifidiff_tpu_torch.data.procedural import ProceduralFaceDataset

__all__ = ["ArrayDataset", "ConcatDataset", "Dataset", "Loader", "Sample",
           "ProceduralFaceDataset",
           "MultiPIEDataset", "MultiPIESingleViewDataset",
           "MultiPIEInferenceDataset", "MultiPIEIDCDataset",
           "MultiPIEHQDataset", "CelebAHQDataset"]
