"""Optional tensor parallelism: the wide layers split by output channel
over a mesh's "model" axis (counterpart of hifidiff_tpu/parallel/tp.py).

The reference has no TP (its largest layer is a 2048-channel 1x1 conv), so
this is a scaling hook beyond parity. The JAX package shards eligible
parameters along their output-feature dimension and lets GSPMD insert the
collectives. The port swaps each eligible `nn.Conv2d` / `nn.Linear` for a
column-parallel layer: each process of the model group holds `cout / tp`
output channels and computes them, and the full activation is gathered
along C. The backward needs Megatron's pair around the sharded layer:

  * before it, identity forward and an all-reduce of the input gradient
    backward (each process's input gradient is partial: it comes from its
    own output channels only);
  * after it, the gather forward and a slice of the output gradient
    backward.

Both are `all_reduce`s (the gather of a zero-filled slot buffer), which
gloo takes on CUDA tensors too. Norm parameters that the JAX rule also
shards (a LayerNorm's (C,) scale) stay whole here: they are tiny, and
splitting them would split the norm's reduction. `tp_spec_for` is the JAX
package's eligibility rule on the port's layouts.

    mesh = make_mesh(4, axes=("data", "model"), shape=(2, 2))
    shard_params_tp(model, mesh, min_features=2048)
    state = TrainState.create(model, ..., group=mesh.data_group)
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from hifidiff_tpu_torch.nn.layers import _Shared


def tp_spec_for(x, model_size: int, min_features: int,
                dim: int = 0) -> Tuple[Optional[str], ...]:
    """The spec sharding `x`'s output-feature dimension `dim` over "model"
    when it is at least `min_features` wide and divisible by `model_size`,
    else () (replicated): the JAX package's rule. The output-feature
    dimension is the first in the port's layouts (Conv2d (cout, cin, kh,
    kw), Linear (cout, cin), biases and scales (cout,)), where it is the
    last in the JAX package's."""
    shape = tuple(x.shape)
    if not shape:
        return ()
    cout = shape[dim]
    if cout < min_features or cout % model_size != 0:
        return ()
    spec = [None] * len(shape)
    spec[dim] = "model"
    return tuple(spec)


def feature_dim(owner: nn.Module, p: torch.Tensor) -> int:
    """The output-feature dimension of parameter `p` of module `owner` in
    the port's layouts: the first for a Conv2d / Linear weight and for a
    vector; the channel dimension of a per-channel scale shaped (1, C, 1,
    1) to broadcast over NCHW (a NAF block's beta and gamma)."""
    if isinstance(owner, (nn.Conv2d, nn.Linear)) or p.dim() != 4:
        return 0
    return 1


def tp_specs(module: nn.Module, model_size: int,
             min_features: int) -> Dict[str, Tuple[Optional[str], ...]]:
    """`tp_spec_for` of every parameter of `module`, by name."""
    return {f"{prefix}.{n}" if prefix else n:
            tp_spec_for(p, model_size, min_features, feature_dim(owner, p))
            for prefix, owner in module.named_modules()
            for n, p in owner.named_parameters(recurse=False)}


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the input gradient all-reduced over the group
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherSlices(torch.autograd.Function):
    """Each process's slice of `dim` gathered into the whole (one
    all-reduce of a zero-filled slot buffer) forward; this process's slice
    of the gradient backward."""

    @staticmethod
    def forward(ctx, y, group, dim):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        size = y.shape[dim]
        shape = list(y.shape)
        shape[dim] = n * size
        out = y.new_zeros(shape)
        out.narrow(dim, r * size, size).copy_(y)
        dist.all_reduce(out, group=group)
        ctx.dim, ctx.start, ctx.size = dim, r * size, size
        return out

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.size).contiguous(), None, \
            None


def _shard(t: Optional[torch.Tensor], rank: int, size: int):
    if t is None:
        return None
    n = t.shape[0] // size
    return nn.Parameter(t.detach()[rank * n:(rank + 1) * n].clone(),
                        requires_grad=t.requires_grad)


class ColumnParallelConv2d(nn.Module):
    """An `nn.Conv2d` holding this process's `cout / tp` output channels
    (`weight`, `bias` under the layer's own names); its output is the whole
    layer's. A grouped convolution keeps its groups whole: each process
    takes the input channels of its groups."""

    def __init__(self, conv: nn.Conv2d, group, rank: int, size: int):
        super().__init__()
        if conv.padding_mode != "zeros" or conv.groups % size:
            raise ValueError(f"cannot split {conv} {size} ways")
        self._group, self.rank, self.size = _Shared(group), rank, size
        self.in_channels, self.out_channels = conv.in_channels, \
            conv.out_channels
        self.stride, self.padding, self.dilation = conv.stride, \
            conv.padding, conv.dilation
        self.groups = conv.groups // size
        self.split_input = conv.groups > 1
        self.weight = _shard(conv.weight, rank, size)
        self.bias = _shard(conv.bias, rank, size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self._group.group
        x = _CopyToGroup.apply(x, group)
        if self.split_input:    # this process's groups' input channels
            per = self.in_channels // self.size
            x = x[:, self.rank * per:(self.rank + 1) * per]
        y = F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                     self.dilation, self.groups)
        return _GatherSlices.apply(y, group, 1)


class ColumnParallelLinear(nn.Module):
    """An `nn.Linear` holding this process's `cout / tp` output features;
    its output is the whole layer's."""

    def __init__(self, linear: nn.Linear, group, rank: int, size: int):
        super().__init__()
        self._group = _Shared(group)
        self.in_features, self.out_features = linear.in_features, \
            linear.out_features
        self.weight = _shard(linear.weight, rank, size)
        self.bias = _shard(linear.bias, rank, size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self._group.group
        y = F.linear(_CopyToGroup.apply(x, group), self.weight, self.bias)
        return _GatherSlices.apply(y, group, y.dim() - 1)


def shard_params_tp(module: nn.Module, mesh,
                    min_features: int = 2048) -> int:
    """Swap, in place, every `nn.Conv2d` / `nn.Linear` below `module` whose
    weight `tp_spec_for` shards for its column-parallel form over the
    mesh's "model" group; returns the number swapped. Every process of the
    model group must hold the same weights (they are split, not
    broadcast)."""
    if "model" not in mesh.axis_names:
        raise ValueError("mesh has no 'model' axis")
    size = mesh.shape["model"]
    if size == 1:
        return 0
    group, rank = mesh.model_group, mesh.index["model"]
    swapped = 0
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            kind = {nn.Conv2d: ColumnParallelConv2d,
                    nn.Linear: ColumnParallelLinear}.get(type(child))
            if kind is None or not tp_spec_for(child.weight, size,
                                               min_features):
                continue
            if kind is ColumnParallelConv2d and child.groups % size:
                continue
            setattr(parent, name, kind(child, group, rank, size))
            swapped += 1
    return swapped
