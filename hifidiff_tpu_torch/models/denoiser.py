"""Latent-space NAFNet-UNet epsilon-predictor with identity and prior
conditioning, NCHW (counterpart of hifidiff_tpu/models/denoiser.py;
reference `models/denoiser/model.py:137-266`).

  * time_mlp: SinusoidalPosEmb(width) -> Linear(width, 8w) -> SimpleGate ->
    Linear(4w, 4w).
  * encoder stages [2,2,4,8] of ConditionalNAFBlocks at 128/256/512/1024 ch
    with 2x2/s2 down-convs; skips recorded BEFORE the down-conv. Middle: 8
    blocks at 2048 ch. Decoder stages [2,2,2,2] after a 1x1 conv +
    PixelShuffle(2) up, the skip added after the up.
  * identity injection at the bottleneck: `idc_conv`, a 1x1 conv over the
    (B, 2048, 1, 1) IDC embedding, viewed as (B, ch, bh, bw); then HCA
    fuses the FPG priors at the bottleneck and after each decoder stage.

`Denoiser` is the unconditional backbone (stage-3 pretraining);
`FusedDenoiser` adds the conditioning. Both share `_UNetCore`.

`precompute` hoists everything that does not depend on the noisy latent:
the FiLM tables of every block for all the sampler's timesteps, the identity
injection and the HCA gates. `forward(films=..., idc_pre=..., hca_gates=...)`
then runs one step without them. `encode` and `decode` split a step in two
for the cached sampler (`diffusion.sampling.sample_ddim_cached`): `encode`
runs up to the conditioned bottleneck (after the identity injection and
`hcas[0]`) and returns it with the skips; `decode` runs the decoder half on
such a cache. `decode(encode(...))` is `forward(...)`.

`fuse_small_naf` (off by default) runs the blocks on 1x1 and 2x2 maps (at
16x16 latents: enc3, the middle blocks and dec0) through the fused
small-map block (each block decides: `ConditionalNAFBlock.will_fuse`).

`remat` (off by default; the JAX package's `nn.remat` of the blocks) runs
every ConditionalNAFBlock of a training forward under
`torch.utils.checkpoint`: its activations are recomputed in the backward
instead of kept, so each block's forward, `ln_film` included, runs twice.
It applies only in training mode with a gradient wanted; the state-dict
names do not change.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from hifidiff_tpu_torch.nn.hca import HybridCrossAttention
from hifidiff_tpu_torch.nn.layers import compute_dtype
from hifidiff_tpu_torch.nn.naf import ConditionalNAFBlock
from hifidiff_tpu_torch.ops.embedding import SinusoidalPosEmb
from hifidiff_tpu_torch.ops.gates import SimpleGate


class TimeMLP(nn.Sequential):
    """SinusoidalPosEmb(width) -> Linear(width, 8w) -> SimpleGate ->
    Linear(4w, 4w); the float32 embedding is cast to the layers' dtype."""

    def __init__(self, width: int):
        time_dim = width * 4
        super().__init__(SinusoidalPosEmb(width),
                         nn.Linear(width, time_dim * 2), SimpleGate(),
                         nn.Linear(time_dim, time_dim))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = self[0](t).to(compute_dtype(self[1]))
        return self[3](self[2](self[1](emb)))


class _UNetCore(nn.Module):
    """The encoder / middle / decoder machinery both denoisers share. With
    `id_dim` it also builds the conditional parts (`idc_conv`, `hcas`), in
    the reference's order of construction."""

    def __init__(self, width: int, in_channels: int, latent_size: int,
                 enc_nums: Sequence[int], mid_num: int,
                 dec_nums: Sequence[int], id_dim: Optional[int] = None,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        time_dim = width * 4

        def stage(ch, n):
            return nn.Sequential(*(ConditionalNAFBlock(ch, time_dim)
                                   for _ in range(n)))

        self.time_mlp = TimeMLP(width)
        self.intro = nn.Conv2d(in_channels, width, 3, padding=1)
        ch = width
        encoders, downs = [], []
        for n in enc_nums:
            encoders.append(stage(ch, n))
            downs.append(nn.Conv2d(ch, ch * 2, 2, stride=2))
            ch *= 2
        self.encoders = nn.ModuleList(encoders)
        self.downs = nn.ModuleList(downs)
        self.middle_blks = stage(ch, mid_num)
        hcas, ups, decoders = [], [], []
        if id_dim is not None:
            bh = latent_size // 2 ** len(enc_nums)
            self._bottleneck = (ch, bh, bh)
            self.idc_conv = nn.Conv2d(id_dim, ch * bh * bh, 1)
            hcas.append(HybridCrossAttention(ch))
        for n in dec_nums:
            ups.append(nn.Sequential(nn.Conv2d(ch, ch * 2, 1, bias=False),
                                     nn.PixelShuffle(2)))
            ch //= 2
            decoders.append(stage(ch, n))
            if id_dim is not None:
                hcas.append(HybridCrossAttention(ch))
        self.ups = nn.ModuleList(ups)
        self.decoders = nn.ModuleList(decoders)
        if id_dim is not None:
            self.hcas = nn.ModuleList(hcas)
        self.ending = nn.Conv2d(width, in_channels, 3, padding=1)

    def blocks(self) -> List[ConditionalNAFBlock]:
        """Every ConditionalNAFBlock in forward order: enc, mid, dec."""
        return [*itertools.chain(*self.encoders), *self.middle_blks,
                *itertools.chain(*self.decoders)]

    def _runner(self, timesteps, films, fuse_small_naf=False):
        """`run(blk, x)` for one forward: each block gets the time embedding,
        or the next of the given `films` (one per block); under `remat` in a
        training forward that wants a gradient, through a checkpoint."""
        t = self.time_mlp(timesteps) if films is None else None
        films = iter(films) if films is not None else itertools.repeat(None)
        remat = self.remat and self.training and torch.is_grad_enabled()

        def run(blk, x):
            if remat:
                # the blocks draw nothing, so no RNG state is kept: that
                # read would stop a CUDA-graph capture of the step
                return checkpoint(blk, x, t, next(films), fuse_small_naf,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            return blk(x, t, next(films), fuse_small_naf)

        return run

    def _encode(self, latents, run):
        """intro, encoder stages and middle blocks -> (bottleneck, skips)."""
        x = self.intro(latents.to(compute_dtype(self.intro)))
        skips = []
        for enc, down in zip(self.encoders, self.downs):
            for blk in enc:
                x = run(blk, x)
            skips.append(x)  # pre-downsample skip (reference convention)
            x = down(x)
        for blk in self.middle_blks:
            x = run(blk, x)
        return x, skips

    def _decode_stage(self, i, x, skips, run):
        x = self.ups[i](x) + skips[-1 - i]
        for blk in self.decoders[i]:
            x = run(blk, x)
        return x


class Denoiser(_UNetCore):
    """Unconditional latent epsilon-predictor (stage-3 pretraining;
    counterpart of hifidiff_tpu's `Denoiser`). Its state-dict names are the
    FusedDenoiser's backbone names, so a trained Denoiser overlays a refiner
    (`train.checkpoint.compose_refiner`)."""

    def __init__(self, width: int = 128, in_channels: int = 4,
                 enc_nums: Sequence[int] = (2, 2, 4, 8), mid_num: int = 8,
                 dec_nums: Sequence[int] = (2, 2, 2, 2),
                 remat: bool = False):
        super().__init__(width, in_channels, 0, enc_nums, mid_num, dec_nums,
                         remat=remat)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor,
                films: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """latents (B, 4, h, w), timesteps (B,) float -> epsilon."""
        h, w = latents.shape[2], latents.shape[3]
        run = self._runner(timesteps, films)
        x, skips = self._encode(latents, run)
        for i in range(len(self.decoders)):
            x = self._decode_stage(i, x, skips, run)
        return self.ending(x)[:, :, :h, :w]


class FusedDenoiser(_UNetCore):
    def __init__(self, width: int = 128, in_channels: int = 4,
                 latent_size: int = 16,
                 enc_nums: Sequence[int] = (2, 2, 4, 8), mid_num: int = 8,
                 dec_nums: Sequence[int] = (2, 2, 2, 2), id_dim: int = 2048,
                 remat: bool = False):
        super().__init__(width, in_channels, latent_size, enc_nums, mid_num,
                         dec_nums, id_dim, remat)

    def idc_injection(self, identity_embedding: torch.Tensor) -> torch.Tensor:
        """(B, 2048) -> (B, ch, bh, bw), the reference's NCHW view."""
        e = identity_embedding.to(compute_dtype(self.idc_conv))
        return self.idc_conv(e[:, :, None, None]).reshape(
            e.shape[0], *self._bottleneck)

    def precompute(self, timesteps: torch.Tensor,
                   facial_priors: Sequence[torch.Tensor],
                   identity_embedding: torch.Tensor) -> Dict:
        """The loop invariants for the timesteps (S,) of a sampler: per-block
        FiLM tables (S, 4c), the identity injection, and the HCA gates (eval
        mode: the gates' BatchNorm on running statistics)."""
        t = self.time_mlp(timesteps)
        return {
            "films": [blk(None, t) for blk in self.blocks()],
            "idc": self.idc_injection(identity_embedding),
            "gates": [hca.gates(p) for hca, p in zip(self.hcas,
                                                      facial_priors)],
        }

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor,
                facial_priors: Sequence[torch.Tensor],
                identity_embedding: Optional[torch.Tensor],
                films: Optional[Sequence[torch.Tensor]] = None,
                idc_pre: Optional[torch.Tensor] = None,
                hca_gates: Optional[Sequence] = None,
                fuse_small_naf: bool = False) -> torch.Tensor:
        """latents (B, 4, h, w), timesteps (B,), priors from the FPG, the
        (B, 2048) IDC embedding -> predicted epsilon (B, 4, h, w).
        `films` (one per block, batch B or 1), `idc_pre` and `hca_gates` are
        `precompute`'s outputs; with `films` the timesteps are unused.
        `fuse_small_naf` sends the blocks that pass their gate through the
        fused small-map block.

        A training forward is this call in `.train()` mode with per-sample
        timesteps and nothing hoisted: every block projects its own FiLM
        rows and the HCA BatchNorms run on batch statistics."""
        run = self._runner(timesteps, films, fuse_small_naf)
        gates = self._gates(hca_gates)
        x, skips = self._encode_half(latents, run, facial_priors,
                                     identity_embedding, idc_pre, gates)
        return self._decode_half(x, skips, run, facial_priors, gates)

    def encode(self, latents: torch.Tensor, timesteps: torch.Tensor,
               facial_priors: Sequence[torch.Tensor],
               identity_embedding: Optional[torch.Tensor],
               films: Optional[Sequence[torch.Tensor]] = None,
               idc_pre: Optional[torch.Tensor] = None,
               hca_gates: Optional[Sequence] = None,
               fuse_small_naf: bool = False) -> Dict:
        """The first half of `forward` (same arguments): {"x": the
        bottleneck after the identity injection and `hcas[0]`, "skips": the
        encoder stages' outputs}."""
        run = self._runner(timesteps, films, fuse_small_naf)
        x, skips = self._encode_half(latents, run, facial_priors,
                                     identity_embedding, idc_pre,
                                     self._gates(hca_gates))
        return {"x": x, "skips": skips}

    def decode(self, cache: Dict, timesteps: torch.Tensor,
               facial_priors: Sequence[torch.Tensor],
               films: Optional[Sequence[torch.Tensor]] = None,
               hca_gates: Optional[Sequence] = None,
               fuse_small_naf: bool = False) -> torch.Tensor:
        """The second half of `forward` on an `encode` cache, with its own
        timesteps -> epsilon. `films` is the whole per-block list, as
        `forward` takes it; the decoder's blocks take its tail."""
        if films is not None:
            films = films[len(films) - sum(len(d) for d in self.decoders):]
        run = self._runner(timesteps, films, fuse_small_naf)
        return self._decode_half(cache["x"], list(cache["skips"]), run,
                                 facial_priors, self._gates(hca_gates))

    def _gates(self, hca_gates: Optional[Sequence]) -> Sequence:
        return hca_gates if hca_gates is not None else \
            [None] * len(self.hcas)

    def _encode_half(self, latents, run, facial_priors, identity_embedding,
                     idc_pre, gates):
        x, skips = self._encode(latents, run)
        x = x + (self.idc_injection(identity_embedding) if idc_pre is None
                 else idc_pre)
        return self.hcas[0](facial_priors[0], x, gates[0]), skips

    def _decode_half(self, x, skips, run, facial_priors, gates):
        for i in range(len(self.decoders)):
            x = self._decode_stage(i, x, skips, run)
            x = self.hcas[i + 1](facial_priors[i + 1], x, gates[i + 1])
        h, w = skips[0].shape[2], skips[0].shape[3]  # the latents' size
        return self.ending(x)[:, :, :h, :w]
