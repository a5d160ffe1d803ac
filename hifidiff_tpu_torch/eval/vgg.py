"""VGG19 feature trunk for the perceptual term of the CR loss (counterpart of
hifidiff_tpu/eval/vgg.py), NCHW.

The reference's optional CRLoss takes torchvision `vgg19.features[:22]`, the
convolutions through conv4_2, with ImageNet normalization (`loss.py:22-23,
49-58`). `VGG19Features22` keeps torchvision's indices in its `features`
Sequential, so a torchvision state dict loads by name
(`vgg19_state_dict_from_torch` keeps the names the trunk has). As in the JAX
package, a ReLU follows conv4_2 too (torchvision's `features[:22]` ends
before it; ROADMAP §C). The reference takes both feature maps without
gradient, so the term adds to the loss and nothing to the gradient
(`train.losses.composite_cr_loss`).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch
from torch import nn

# VGG19 stages up to features[:22]: (channels, convolutions) per stage
VGG19_PLAN = ((64, 2), (128, 2), (256, 4), (512, 2))
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg_features(plan, pool_after_last: bool = False) -> nn.Sequential:
    """torchvision's `features` layout for a VGG `plan`: conv3x3 + ReLU per
    convolution, a 2x2 max pool between stages (and after the last one with
    `pool_after_last`), so that module i is torchvision's `features.i`."""
    layers, cin = [], 3
    for si, (ch, n_convs) in enumerate(plan):
        for _ in range(n_convs):
            layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
            cin = ch
        if si < len(plan) - 1 or pool_after_last:
            layers.append(nn.MaxPool2d(2, 2))
    return nn.Sequential(*layers)


def _normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    shape = (1, -1, 1, 1)
    return (x - torch.tensor(mean, dtype=x.dtype, device=x.device).reshape(
        shape)) / torch.tensor(std, dtype=x.dtype,
                               device=x.device).reshape(shape)


class VGG19Features22(nn.Module):
    """torchvision `vgg19.features[:22]` plus the ReLU after conv4_2: (B, 3,
    H, W) images in [0, 1] -> (B, 512, H/8, W/8) features."""

    def __init__(self):
        super().__init__()
        # drop the ReLU torchvision has at index 21 + 1: it runs in forward
        self.features = vgg_features(VGG19_PLAN)[:-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _normalize(x, IMAGENET_MEAN, IMAGENET_STD)
        return torch.relu(self.features(x))


def vgg19_state_dict_from_torch(sd: Mapping[str, torch.Tensor]
                                ) -> Dict[str, torch.Tensor]:
    """A torchvision vgg19 state dict (`features.N.weight/bias`, the
    classifier too) -> the names `VGG19Features22` has."""
    own = VGG19Features22().state_dict().keys()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"not a torchvision vgg19 state dict: missing "
                       f"{missing[:4]}")
    return {k: torch.as_tensor(sd[k]) for k in own}


def make_vgg_features_fn(sd: Mapping[str, torch.Tensor],
                         device=None) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """`fn(images01) -> features` for `composite_cr_loss`, from a torchvision
    vgg19 state dict: the trunk frozen, in eval mode, on `device`."""
    net = VGG19Features22()
    net.load_state_dict(vgg19_state_dict_from_torch(sd), strict=True)
    net.to(device).eval().requires_grad_(False)
    return net
