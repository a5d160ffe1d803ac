"""Datasets and the prefetching loader (counterpart of hifidiff_tpu/data/):
the numpy `Dataset` protocol, `Loader`, the procedural face family, and the
K-Face, Multi-PIE and CelebA-HQ datasets on trees of PNG, JPEG, WebP and
BMP files."""

from hifidiff_tpu_torch.data.core import (ArrayDataset, ConcatDataset,
                                          Dataset, Loader, Sample)
from hifidiff_tpu_torch.data.kface import (KFaceCropDataset,
                                           KFaceCropHRDataset,
                                           KFaceCropIDCDataset, KFaceDataset,
                                           KFaceHRDataset, KFaceIDCDataset)
from hifidiff_tpu_torch.data.multipie import (MultiPIEDataset,
                                              MultiPIEIDCDataset,
                                              MultiPIEInferenceDataset,
                                              MultiPIESingleViewDataset)
from hifidiff_tpu_torch.data.pretraining import (CelebAHQDataset,
                                                 MultiPIEHQDataset)
from hifidiff_tpu_torch.data.procedural import ProceduralFaceDataset

__all__ = ["ArrayDataset", "ConcatDataset", "Dataset", "Loader", "Sample",
           "ProceduralFaceDataset",
           "KFaceDataset", "KFaceCropDataset", "KFaceIDCDataset",
           "KFaceCropIDCDataset", "KFaceHRDataset", "KFaceCropHRDataset",
           "MultiPIEDataset", "MultiPIESingleViewDataset",
           "MultiPIEInferenceDataset", "MultiPIEIDCDataset",
           "MultiPIEHQDataset", "CelebAHQDataset"]
