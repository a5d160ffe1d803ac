"""Stable Diffusion 2.1 VAE (AutoencoderKL), NCHW (counterpart of
hifidiff_tpu/vae/model.py). 128/256/512/512 channels, 2 ResNet layers per
block, GroupNorm(32, eps 1e-6) + SiLU with float32 statistics, a
single-head self-attention mid block (matmul + softmax), the asymmetric
(0,1,0,1) pad before each stride-2 conv, nearest x2 + conv upsampling, and a
4-channel diagonal-Gaussian latent with quant/post-quant 1x1 convs.

Module names are diffusers' (`encoder.down_blocks.0.resnets.0.norm1`,
`decoder.mid_block.attentions.0.to_q`, ...), so a diffusers checkpoint
loads with `load_state_dict`.

`fused_gn_silu` (an argument of `encode` / `moments` / `decode`, off by
default) sends every GroupNorm + SiLU site through the fused kernel
(`ops.norm.group_norm_silu(..., fused=True)`).

A fresh AutoencoderKL draws as torch's layers do (the reference's diffusers
VAE); `flax_default_init_` draws it as the JAX package's `vae.init` does
(flax's `lecun_normal` weights, zero biases), which the training CLIs use
where the JAX ones initialize a VAE.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hifidiff_tpu_torch.ops.norm import group_norm, group_norm_silu

SD_VAE_SCALING = 0.18215


def _gn(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, ch, eps=1e-6)


def _gn_silu(norm: nn.GroupNorm, x: torch.Tensor,
             fused: bool = False) -> torch.Tensor:
    return group_norm_silu(x, norm.weight, norm.bias, norm.num_groups,
                           norm.eps, fused=fused)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = _gn(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = _gn(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_ch, out_ch, 1)
                              if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
        h = self.conv1(_gn_silu(self.norm1, x, fused))
        h = self.conv2(_gn_silu(self.norm2, h, fused))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Single-head self-attention over the spatial tokens."""

    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = _gn(ch)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch), nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        gn = self.group_norm
        t = group_norm(x, gn.weight, gn.bias, gn.num_groups, gn.eps)
        t = t.flatten(2).transpose(1, 2)                     # (B, HW, C)
        q, k, v = self.to_q(t), self.to_k(t), self.to_v(t)
        attn = torch.softmax(q @ k.transpose(1, 2) * c ** -0.5, dim=-1)
        out = self.to_out[0](attn @ v)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class MidBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch),
                                      ResnetBlock2D(ch, ch)])
        self.attentions = nn.ModuleList([Attention(ch)])

    def forward(self, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
        x = self.resnets[0](x, fused)
        return self.resnets[1](self.attentions[0](x), fused)


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    """A down/up block: ResNet layers, then an optional resampler held as
    `downsamplers.0` / `upsamplers.0`."""

    def __init__(self, in_ch: int, out_ch: int, layers: int, sampler: str,
                 resample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch)
            for j in range(layers))
        cls = Downsample if sampler == "downsamplers" else Upsample
        self._sampler = sampler if resample else None
        if resample:
            self.add_module(sampler, nn.ModuleList([cls(out_ch)]))

    def forward(self, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
        for r in self.resnets:
            x = r(x, fused)
        if self._sampler is not None:
            x = getattr(self, self._sampler)[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, block_out: Sequence[int], layers_per_block: int,
                 latent_channels: int):
        super().__init__()
        self.conv_in = nn.Conv2d(3, block_out[0], 3, padding=1)
        n = len(block_out)
        self.down_blocks = nn.ModuleList(
            _Block(block_out[max(i - 1, 0)], ch, layers_per_block,
                   "downsamplers", i < n - 1)
            for i, ch in enumerate(block_out))
        self.mid_block = MidBlock(block_out[-1])
        self.conv_norm_out = _gn(block_out[-1])
        self.conv_out = nn.Conv2d(block_out[-1], 2 * latent_channels, 3,
                                  padding=1)

    def forward(self, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x, fused)
        x = self.mid_block(x, fused)
        return self.conv_out(_gn_silu(self.conv_norm_out, x, fused))


class Decoder(nn.Module):
    def __init__(self, block_out: Sequence[int], layers_per_block: int,
                 latent_channels: int, out_channels: int = 3):
        super().__init__()
        rev = list(reversed(block_out))
        self.conv_in = nn.Conv2d(latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0])
        n = len(rev)
        self.up_blocks = nn.ModuleList(
            _Block(rev[max(i - 1, 0)], ch, layers_per_block + 1,
                   "upsamplers", i < n - 1)
            for i, ch in enumerate(rev))
        self.conv_norm_out = _gn(rev[-1])
        self.conv_out = nn.Conv2d(rev[-1], out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor, fused: bool = False) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z), fused)
        for blk in self.up_blocks:
            x = blk(x, fused)
        return self.conv_out(_gn_silu(self.conv_norm_out, x, fused))


def flax_default_init_(module: nn.Module) -> nn.Module:
    """Draw every Conv2d and Linear of `module` as flax's `nn.Conv` /
    `nn.Dense` defaults do: weights from a normal truncated at two standard
    deviations with variance 1 / fan_in (`lecun_normal`), biases zero. Draws
    from torch's global RNG; returns `module`."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = math.sqrt(1.0 / m.weight[0].numel()) / .87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
    return module


class AutoencoderKL(nn.Module):
    def __init__(self, block_out: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4):
        super().__init__()
        self.encoder = Encoder(block_out, layers_per_block, latent_channels)
        self.decoder = Decoder(block_out, layers_per_block, latent_channels)
        self.quant_conv = nn.Conv2d(2 * latent_channels,
                                    2 * latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)

    def moments(self, images: torch.Tensor, fused_gn_silu: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Images in [-1, 1] (B, 3, H, W) -> (mean, logvar) of the latent
        posterior, logvar clipped to [-30, 20]."""
        m = self.quant_conv(self.encoder(
            images.to(self.quant_conv.weight.dtype), fused_gn_silu))
        mean, logvar = m.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, images: torch.Tensor,
               noise: torch.Tensor | None = None,
               fused_gn_silu: bool = False) -> torch.Tensor:
        """A posterior sample `mean + exp(logvar / 2) * noise` for a given
        standard-normal `noise` tensor shaped like the latent, or the mean
        when `noise` is None. Unscaled: multiply by SD_VAE_SCALING at the
        call site."""
        mean, logvar = self.moments(images, fused_gn_silu)
        if noise is None:
            return mean
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)

    def decode(self, latents: torch.Tensor,
               fused_gn_silu: bool = False) -> torch.Tensor:
        """Unscaled latents -> images in [-1, 1]."""
        z = latents.to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z), fused_gn_silu)

    def gn_silu_sites(self) -> Tuple[int, int]:
        """(encode, decode): how many GroupNorm + SiLU sites each runs: two
        per ResNet block and the output norm."""
        def count(part: nn.Module) -> int:
            return 1 + 2 * sum(isinstance(m, ResnetBlock2D)
                               for m in part.modules())

        return count(self.encoder), count(self.decoder)
