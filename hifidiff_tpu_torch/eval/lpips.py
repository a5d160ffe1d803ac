"""LPIPS, the learned perceptual image patch similarity (counterpart of
hifidiff_tpu/eval/lpips.py), NCHW.

The reference computes LPIPS through pyiqa (`test_refiner.py:107-109`),
whose `lpips` metric defaults to the AlexNet backbone (`net="alex"` here);
the VGG16 backbone (lpips `net='vgg'`) is the JAX eval CLI's. Both follow
the standard formulation: the backbone's features at five taps, unit-
normalized over channels, squared differences weighted by the learned 1x1
heads, averaged over the map and summed over the taps.

The trunks keep torchvision's indices in their `features` Sequential, so a
torchvision vgg16 / alexnet state dict loads by name; the heads are the
lpips checkpoint's `lin{i}.model.1.weight`. The convolutions are plain
`torch.nn.Conv2d` (cuDNN on the card). No weights ship with the repository:
`lpips_available` says whether local files were given.
"""

from __future__ import annotations

import os
from typing import List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from hifidiff_tpu_torch.eval.vgg import _normalize, vgg_features

# VGG16 (channels, convolutions) per stage; a tap after each stage
VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# lpips convention: input scaled to [-1, 1], then shifted and scaled
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)
# torchvision AlexNet `features`: (out, kernel, stride, pad, pool before)
ALEXNET_PLAN = ((64, 11, 4, 2, False), (192, 5, 1, 2, True),
                (384, 3, 1, 1, True), (256, 3, 1, 1, False),
                (256, 3, 1, 1, False))


class _Taps(nn.Module):
    """A `features` Sequential read out after each module index of
    `tap_ends`."""

    features: nn.Sequential
    tap_ends: Tuple[int, ...]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps, start = [], 0
        for end in self.tap_ends:
            x = self.features[start:end](x)
            taps.append(x)
            start = end
        return taps


class VGG16Features(_Taps):
    """The VGG16 trunk up to relu5_3, emitting the five LPIPS taps (relu1_2,
    relu2_2, relu3_3, relu4_3, relu5_3)."""

    def __init__(self):
        super().__init__()
        self.features = vgg_features(VGG16_STAGES)
        ends = []
        i = 0
        for si, (_, n_convs) in enumerate(VGG16_STAGES):
            i += 2 * n_convs
            ends.append(i)          # the tap follows module i - 1 (a ReLU)
            i += si < len(VGG16_STAGES) - 1
        self.tap_ends = tuple(ends)


class AlexNetFeatures(_Taps):
    """The torchvision AlexNet trunk, emitting the five LPIPS taps (relu1 ..
    relu5)."""

    def __init__(self):
        super().__init__()
        layers, cin, ends = [], 3, []
        for ch, k, s, p, pool_before in ALEXNET_PLAN:
            if pool_before:
                layers.append(nn.MaxPool2d(3, 2))
            layers += [nn.Conv2d(cin, ch, k, stride=s, padding=p), nn.ReLU()]
            ends.append(len(layers))
            cin = ch
        self.features = nn.Sequential(*layers)
        self.tap_ends = tuple(ends)


def _unit_normalize(feat: torch.Tensor) -> torch.Tensor:
    norm = feat.square().sum(dim=1, keepdim=True).sqrt()
    return feat / norm.clamp_min(1e-10)


def lpips_distance(net: nn.Module, lin_weights: Sequence[torch.Tensor],
                   x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x, y: (B, 3, H, W) in [0, 1]; `net` a `VGG16Features` or
    `AlexNetFeatures` (`load_lpips_params` / `load_lpips_alex_params`).
    Returns the per-sample LPIPS (B,)."""
    def prep(img):
        return _normalize(img * 2.0 - 1.0, LPIPS_SHIFT, LPIPS_SCALE)

    total = 0.0
    for tap_x, tap_y, w in zip(net(prep(x)), net(prep(y)), lin_weights):
        d = (_unit_normalize(tap_x) - _unit_normalize(tap_y)).square()
        d = (d * w.reshape(1, -1, 1, 1).to(d)).sum(dim=1)
        total = total + d.mean(dim=(1, 2))
    return total


def _heads(lpips_state_dict: Mapping[str, torch.Tensor]
           ) -> List[torch.Tensor]:
    return [torch.as_tensor(lpips_state_dict[f"lin{i}.model.1.weight"]
                            ).reshape(-1).float() for i in range(5)]


def _loaded(net: nn.Module, sd: Mapping[str, torch.Tensor]) -> nn.Module:
    own = net.state_dict().keys()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"the backbone state dict lacks {missing[:4]}")
    net.load_state_dict({k: torch.as_tensor(sd[k]) for k in own},
                        strict=True)
    return net.eval().requires_grad_(False)


def load_lpips_params(vgg16_state_dict: Mapping[str, torch.Tensor],
                      lpips_state_dict: Mapping[str, torch.Tensor]
                      ) -> Tuple[VGG16Features, List[torch.Tensor]]:
    """A torchvision vgg16 state dict (`features.*`) and an lpips vgg
    checkpoint (`lin*.model.1.weight`) -> (the trunk, the five heads (C,)),
    on the CPU; move both where the images are."""
    return _loaded(VGG16Features(), vgg16_state_dict), \
        _heads(lpips_state_dict)


def load_lpips_alex_params(alexnet_state_dict: Mapping[str, torch.Tensor],
                           lpips_state_dict: Mapping[str, torch.Tensor]
                           ) -> Tuple[AlexNetFeatures, List[torch.Tensor]]:
    """A torchvision alexnet state dict (convolutions at
    `features.{0,3,6,8,10}`) and an lpips alex checkpoint -> (the trunk, the
    five heads)."""
    return _loaded(AlexNetFeatures(), alexnet_state_dict), \
        _heads(lpips_state_dict)


def lpips_available(vgg_path: Optional[str] = None,
                    lpips_path: Optional[str] = None) -> bool:
    return bool(vgg_path and lpips_path and os.path.exists(vgg_path)
                and os.path.exists(lpips_path))
