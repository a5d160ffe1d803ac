"""Seeded random weights that exercise every path of the models.

At init some blocks are identities: the NAF blocks' zero `beta`/`gamma`
residual scales, and the STNs' zero-kernel `fc_loc.2`, which makes every
warp the identity. A comparison of two implementations on such weights
proves little. `perturb_` gives beta and gamma N(0, 0.1) values, adds
N(0, 0.01) to the STN `fc_loc.2` kernels, and gives BatchNorm random running
statistics (means N(0, 0.1), variances U(0.5, 1.5)).

That is enough to hold two implementations of a model together in float32.
It is not enough to see inside a NAF block in bfloat16: with default-
initialised weights the block's first branch is about a thousandth of its
second (the depthwise taps, the SimpleGate product and the SCA gate each
shrink it), and with residual scales of N(0, 0.1) both lie near one bf16 ulp
of the block's input. `amplify_naf_blocks_` scales the weights so that every
part of a block shows in its output.
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def perturb_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Perturb `model`'s weights in place, in sorted key order, with numbers
    drawn on the CPU from `generator`; returns the model."""
    for name, t in sorted(model.state_dict().items()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("beta", "gamma"):
            new = torch.randn(t.shape, generator=generator) * 0.1
        elif name.endswith("fc_loc.2.weight"):
            new = t.cpu().float() + torch.randn(t.shape,
                                                generator=generator) * 0.01
        elif leaf == "running_mean":
            new = torch.randn(t.shape, generator=generator) * 0.1
        elif leaf == "running_var":
            new = torch.rand(t.shape, generator=generator) + 0.5
        else:
            continue
        t.copy_(new.to(t.dtype))
    return model


# amplify_naf_blocks_'s factors for beta and gamma, the depthwise 3x3 taps and
# the SCA convolution's weight
_RESIDUAL_GAIN, _DEPTHWISE_GAIN, _SCA_GAIN = 10.0, 4.0, 4.0


@torch.no_grad()
def amplify_naf_blocks_(model: nn.Module) -> nn.Module:
    """Scale, in place, every (float) NAF block below `model` so that each
    of its parts shows in its output: the second branch becomes about a
    fifth of the block's input and the first a tenth of it on a 1x1 map,
    growing with the map as more taps add up (a half on 2x2). For checks
    that must tell a block with a part left out from the block itself;
    apply it before the block is quantized."""
    for m in model.modules():
        if hasattr(m, "beta") and hasattr(m, "sca"):
            m.beta.mul_(_RESIDUAL_GAIN)
            m.gamma.mul_(_RESIDUAL_GAIN)
            m.conv2.weight.mul_(_DEPTHWISE_GAIN)
            m.sca[1].weight.mul_(_SCA_GAIN)
            if hasattr(m, "clear_fused_packs"):
                m.clear_fused_packs()
    return model
