"""Shared layers (counterpart of hifidiff_tpu/nn/layers.py).

Convolutions and linear layers are plain `nn.Conv2d` / `nn.Linear`: their
default init is the `kaiming_uniform_(a=sqrt(5))` that the JAX package
reproduces with `torch_conv_kernel_init` / `torch_fan_in_bias_init`.

`Conv2dW8` / `LinearW8` are their int8-weight forms (inference only). The
module tree is the switch, as the params tree is in the JAX package:
`quantize_module_` replaces every eligible layer of a trained float model,
and the same model code then runs the int8 path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hifidiff_tpu_torch.ops import quant
from hifidiff_tpu_torch.ops.norm import layer_norm_2d, ln_film


class LayerNorm2d(nn.Module):
    """Channel LayerNorm over NCHW's channel axis (reference `utils.py:45-54`),
    float32 statistics, output in x's dtype. Given a FiLM `scale`/`shift`
    ((B or 1, C)), it goes through the fused `ln_film` kernel."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None) -> torch.Tensor:
        if scale is not None:
            return ln_film(x, self.weight, self.bias, scale, shift, self.eps)
        return layer_norm_2d(x, self.weight, self.bias, self.eps)


class _Shared:
    """Holds a process group; a deep copy of the module shares it (a group
    cannot be copied)."""

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """`x` in float32, or in float64 where it is."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (eps 1e-5, momentum 0.1) whose training mode follows
    the JAX package's flax BatchNorm (momentum 0.9): the running variance is
    updated with the *biased* batch variance, where torch's own uses the
    unbiased one (the two differ by n / (n - 1), much at a 1x1 bottleneck
    with a small batch). Normalisation, the running mean and eval mode are
    torch's. State-dict names are `nn.BatchNorm2d`'s.

    Under data parallelism (`parallel.sync_batch_norm(module, group)`, a
    group of more than one process) training mode takes its statistics over
    the global batch, as the JAX package's BatchNorm does inside a jit over
    the mesh: two autograd-aware all-reduces, the sum (with the row count)
    giving the mean, then the sum of squared deviations from it giving the
    biased variance (sum and sum of squares would cancel in float32 at a
    1x1 map). `torch.nn.SyncBatchNorm` would update the running variance
    with the unbiased estimate."""

    _sync = _Shared(None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        group = self._sync.group
        if group is not None \
                and torch.distributed.get_world_size(group) > 1:
            return self._forward_global(x, group)
        with torch.no_grad():
            var, mean = torch.var_mean(_at_least_f32(x), dim=(0, 2, 3),
                                       unbiased=False)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype),
                                   self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _forward_global(self, x: torch.Tensor, group) -> torch.Tensor:
        """Training mode over `group`'s global batch (None: this process's
        own batch, by the same formula)."""
        from torch.distributed.nn.functional import all_reduce

        def reduce(t):
            return t if group is None else all_reduce(t, group=group)

        xf = _at_least_f32(x)
        c = xf.shape[1]
        rows = xf.new_full((1,), xf.numel() // c)
        sums = reduce(torch.cat([xf.sum((0, 2, 3)), rows]))
        count = sums[c].detach()
        mean = sums[:c] / count
        dev = xf - mean[None, :, None, None]
        var = reduce(dev.square().sum((0, 2, 3))) / count
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype),
                                   self.momentum)
            self.num_batches_tracked += 1
        y = dev * torch.rsqrt(var + self.eps)[None, :, None, None]
        if self.affine:
            y = y * self.weight[None, :, None, None] \
                + self.bias[None, :, None, None]
        return y.to(x.dtype)


class _W8Module(nn.Module):
    """An int8 `weight_q` buffer in the float layer's weight layout, a
    float32 per-output-channel `weight_scale` buffer and the float layer's
    bias. State-dict names: the float name with `_q` / `_scale`."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor]):
        super().__init__()
        weight_q, weight_scale = quant.quantize_weight_per_cout(weight)
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("weight_scale", weight_scale)
        self.bias = None if bias is None else nn.Parameter(
            bias.detach().clone(), requires_grad=False)
        # follows `.to(dtype)` like the float weight did: `compute_dtype`
        self.register_buffer("_dtype_probe", weight.new_empty(0),
                             persistent=False)

    def _apply(self, fn, recurse=True):
        # `.to(torch.bfloat16)` casts floating buffers; the scales stay
        # float32 (they multiply the float32 accumulator) and only move
        scale = self.weight_scale
        super()._apply(fn, recurse)
        self.weight_scale = scale.to(self.weight_q.device)
        return self


class Conv2dW8(_W8Module):
    """`nn.Conv2d` with int8-resident weights: 1x1 / stride 1 / ungrouped /
    unpadded convolutions through the `matmul_w8` kernel, the others through
    a dequantized plain convolution (`ops.quant.conv_w8`)."""

    def __init__(self, conv: nn.Conv2d):
        if conv.padding_mode != "zeros" or conv.dilation != (1, 1) \
                or isinstance(conv.padding, str):
            raise ValueError(f"Conv2dW8: unsupported convolution {conv}")
        super().__init__(conv.weight, conv.bias)
        self.in_channels, self.out_channels = conv.in_channels, \
            conv.out_channels
        self.stride, self.padding, self.groups = conv.stride, conv.padding, \
            conv.groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = quant.conv_w8(x, self.weight_q, self.weight_scale, self.stride,
                          self.padding, self.groups)
        if self.bias is not None:
            y = y + self.bias[:, None, None]
        return y.to(x.dtype)


class LinearW8(_W8Module):
    """`nn.Linear` with int8-resident weights (`ops.quant.dense_w8`)."""

    def __init__(self, linear: nn.Linear):
        super().__init__(linear.weight, linear.bias)
        self.in_features, self.out_features = linear.in_features, \
            linear.out_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = quant.dense_w8(x, self.weight_q, self.weight_scale)
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


def compute_dtype(layer: nn.Module) -> torch.dtype:
    """The dtype a conv / linear layer computes in, float or int8 form."""
    if isinstance(layer, _W8Module):
        return layer._dtype_probe.dtype
    return layer.weight.dtype


def quantize_module_(module: nn.Module) -> int:
    """Replace, in place, every `nn.Conv2d` / `nn.Linear` below `module`
    whose weight has at least `quant.W8_MIN_WEIGHT_PARAMS` elements by its
    int8 form (the counterpart of `quantize_variables` on a params subtree),
    and drop the packed weights that fused NAF blocks below it keep.
    Returns the number of layers replaced."""
    replaced = 0
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            if type(child) in (nn.Conv2d, nn.Linear) \
                    and quant.w8_layer_eligible(child.weight.numel()):
                w8 = Conv2dW8(child) if isinstance(child, nn.Conv2d) \
                    else LinearW8(child)
                setattr(parent, name, w8)
                replaced += 1
        if hasattr(parent, "clear_fused_packs"):
            parent.clear_fused_packs()
    return replaced
