"""FacialRefiner: the IDC encoder, the FPG and the FusedDenoiser
(counterpart of hifidiff_tpu/models/refiner.py; reference
`models/refiner.py:10-38`). Its `state_dict()` prefixes are the reference's
`idc.`, `denoiser.` and `fpg.`. `remat` checkpoints the denoiser's blocks
in training (`models/denoiser.py`)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from hifidiff_tpu_torch.models.denoiser import FusedDenoiser
from hifidiff_tpu_torch.models.fpg import FacialPriorGuidance
from hifidiff_tpu_torch.models.idc import IDCEncoder
from hifidiff_tpu_torch.nn.layers import quantize_module_


class FacialRefiner(nn.Module):
    def __init__(self, latent_size: int = 16, width: int = 128,
                 enc_nums: Sequence[int] = (2, 2, 4, 8), mid_num: int = 8,
                 dec_nums: Sequence[int] = (2, 2, 2, 2),
                 idc_stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 remat: bool = False):
        super().__init__()
        self.idc = IDCEncoder(stage_sizes=idc_stage_sizes)
        self.denoiser = FusedDenoiser(width=width, latent_size=latent_size,
                                      enc_nums=enc_nums, mid_num=mid_num,
                                      dec_nums=dec_nums, remat=remat)
        self.fpg = FacialPriorGuidance(width=width, enc_nums=enc_nums)

    def train(self, mode: bool = True) -> "FacialRefiner":
        """The IDC stays in eval mode whatever `mode` says: it is frozen in
        refiner training and its BatchNorm keeps its running statistics
        (reference `models/refiner.py:20`)."""
        super().train(mode)
        self.idc.eval()
        return self

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor,
                cr_face: torch.Tensor, cr_latent: torch.Tensor,
                fuse_small_naf: bool = False) -> torch.Tensor:
        """Noisy latents (B, 4, h, w), timesteps (B,), the CR face
        (B, 3, 128, 128) in [0, 1] and its VAE latent -> epsilon."""
        return self.denoiser(latents, timesteps, self.fpg(cr_latent),
                             self.idc(cr_face),
                             fuse_small_naf=fuse_small_naf)


def quantize_denoiser_(refiner: FacialRefiner) -> int:
    """Int8 weights for the denoiser, in place: the weights the sampler's
    loop streams every step. The once-per-batch trunks (IDC, FPG) stay
    float. Returns the number of layers replaced."""
    return quantize_module_(refiner.denoiser)
