"""NAFNet restoration blocks, NCHW (counterpart of hifidiff_tpu/nn/naf.py).

  * NAFBlock (reference `models/cr/naf.py:23-126`): LN -> 1x1 (c->2c) ->
    3x3 depthwise -> SimpleGate -> simplified channel attention -> 1x1 (c)
    -> residual scaled by `beta`; then LN -> 1x1 (c->2c) -> SimpleGate ->
    1x1 (c) -> residual scaled by `gamma`.
  * ConditionalNAFBlock (`models/denoiser/conditional_naf.py:13-136`): the
    same block with FiLM time conditioning from `mlp` (SimpleGate ->
    Linear(time_dim//2, 4c)) giving (shift_att, scale_att, shift_ffn,
    scale_ffn), applied as `x * (scale + 1) + shift` right after each LN —
    fused into the LN by the `ln_film` kernel. With `fuse_small=True` a
    block on a 1x1 or 2x2 map with a batch-1 film runs as one fused call
    (`ops.naf_block.fused_cnaf_block_small`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from hifidiff_tpu_torch.nn.layers import LayerNorm2d
from hifidiff_tpu_torch.ops.gates import SimpleGate, simple_gate
from hifidiff_tpu_torch.ops.naf_block import (CnafPack,
                                              fused_cnaf_block_small,
                                              pack_cnaf_block)


class SimplifiedChannelAttention(nn.Sequential):
    """Global average pool -> 1x1 conv -> per-channel gate of the input. A
    Sequential(pool, conv), so its conv is the reference's `sca.1`."""

    def __init__(self, channels: int):
        super().__init__(nn.AdaptiveAvgPool2d(1),
                         nn.Conv2d(channels, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * super().forward(x)


class NAFBlock(nn.Module):
    def __init__(self, c: int, dw_expand: int = 2, ffn_expand: int = 2):
        super().__init__()
        self.c, self.dw_expand, self.ffn_expand = c, dw_expand, ffn_expand
        dw, ffn = c * dw_expand, c * ffn_expand
        self.norm1 = LayerNorm2d(c)
        self.conv1 = nn.Conv2d(c, dw, 1)
        self.conv2 = nn.Conv2d(dw, dw, 3, padding=1, groups=dw)
        self.sca = SimplifiedChannelAttention(dw // 2)
        self.conv3 = nn.Conv2d(dw // 2, c, 1)
        self.norm2 = LayerNorm2d(c)
        self.conv4 = nn.Conv2d(c, ffn, 1)
        self.conv5 = nn.Conv2d(ffn // 2, c, 1)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    def _attn(self, x: torch.Tensor) -> torch.Tensor:
        x = simple_gate(self.conv2(self.conv1(x)))
        return self.conv3(self.sca(x))

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv5(simple_gate(self.conv4(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x + self._attn(self.norm1(x)) * self.beta
        return y + self._ffn(self.norm2(y)) * self.gamma


class ConditionalNAFBlock(NAFBlock):
    def __init__(self, c: int, time_dim: int = 512, dw_expand: int = 2,
                 ffn_expand: int = 2):
        super().__init__(c, dw_expand, ffn_expand)
        self.mlp = nn.Sequential(SimpleGate(), nn.Linear(time_dim // 2, 4 * c))
        self._packs: Dict[Tuple[int, torch.dtype], CnafPack] = {}
        # how many times the packs were dropped: a CUDA graph that baked in
        # their pointers is stale once this moves (pipeline.py keys on it)
        self.pack_generation = 0
        self.register_load_state_dict_post_hook(
            lambda module, _: module.clear_fused_packs())

    def forward(self, x: Optional[torch.Tensor], t: Optional[torch.Tensor] = None,
                film: Optional[torch.Tensor] = None,
                fuse_small: bool = False) -> torch.Tensor:
        """x: (B, c, H, W); t: (B, time_dim) time embedding.

        FiLM hoisting: the film table depends only on `t`, so the sampler
        computes it for all steps before the loop. Call with `x=None` to get
        the (B, 4c) film from `t`; call with `film=` to skip the projection.
        A film of batch 1 is shared across the batch.

        `fuse_small` (off by default) sends a block that passes
        `_fused_small_ok` through the fused small-map call, on its
        `fused_pack`; on the card that call takes bfloat16 maps and
        `c <= 2048` and raises for anything else. Every other block takes
        the standard path."""
        if film is None:
            film = self.mlp(t)
        if x is None:
            return film
        if fuse_small and self._fused_small_ok(x, film):
            if torch.is_grad_enabled():
                raise RuntimeError(
                    "ConditionalNAFBlock: the fused small-map call has no "
                    "backward; call it under torch.no_grad() or "
                    "torch.inference_mode()")
            return fused_cnaf_block_small(
                x, film, self.fused_pack(x.shape[2], x.dtype), self.norm1.eps)
        shift_att, scale_att, shift_ffn, scale_ffn = film.chunk(4, dim=1)
        y = x + self._attn(self.norm1(x, scale_att, shift_att)) * self.beta
        return y + self._ffn(self.norm2(y, scale_ffn, shift_ffn)) * self.gamma

    def will_fuse(self, hw: int) -> bool:
        """Whether `fuse_small=True` sends this block's hw x hw maps (with a
        hoisted batch-1 film) through the fused call: a 1x1 or 2x2 map,
        `dw_expand == ffn_expand == 2` and `c % 128 == 0`."""
        return hw in (1, 2) and self.dw_expand == 2 \
            and self.ffn_expand == 2 and self.c > 0 and self.c % 128 == 0

    def _fused_small_ok(self, x: torch.Tensor, film: torch.Tensor) -> bool:
        """The fused block's gate: `will_fuse` of a square map, and a
        hoisted batch-1 film (a per-sample film takes the standard path)."""
        return x.shape[2] == x.shape[3] and film.shape[0] == 1 \
            and self.will_fuse(x.shape[2])

    def fused_pack(self, hw: int, dtype: torch.dtype) -> CnafPack:
        """The block's weights packed for the fused call on an hw x hw map
        in `dtype`, packed at the first call and kept. Moving or casting the
        module, `load_state_dict` and `quantize_module_` drop the kept
        packs; after any other change of the weights call
        `clear_fused_packs()`."""
        key = (hw, dtype)
        if key not in self._packs:
            # plain tensors without a graph, whatever mode the caller is in
            with torch.inference_mode(False), torch.no_grad():
                self._packs[key] = self._pack(hw, dtype)
        return self._packs[key]

    def _pack(self, hw: int, dtype: torch.dtype) -> CnafPack:
        return pack_cnaf_block(
            ln1=(self.norm1.weight, self.norm1.bias),
            ln2=(self.norm2.weight, self.norm2.bias), conv1=self.conv1,
            conv2=self.conv2, sca_conv=self.sca[1], conv3=self.conv3,
            conv4=self.conv4, conv5=self.conv5, beta=self.beta,
            gamma=self.gamma, hw=hw, dtype=dtype)

    def clear_fused_packs(self) -> None:
        self._packs.clear()
        self.pack_generation += 1

    def _apply(self, *args, **kwargs):
        self.clear_fused_packs()
        return super()._apply(*args, **kwargs)
