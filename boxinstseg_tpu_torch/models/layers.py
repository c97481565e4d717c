"""Shared NN building blocks (NCHW).

Counterparts of ``boxinstseg_tpu/models/layers.py``. Module and parameter
names follow the mmdet reference's ``state_dict`` keys (``conv``, ``bn``,
``gn``, ``weight``, ``bias``, ``running_mean``, ``running_var``), so a
port ``state_dict`` maps onto the JAX params with
``convert_reference_checkpoint`` and back with ``utils.weights``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import dist as pdist

IntPair = Union[int, Tuple[int, int]]


def f32_tree(tree):
    """Every floating tensor of a nested dict, list or tuple as fp32: the
    loss boundary of the bf16 policy (the JAX package's ``f32_tree``), where
    the heads' outputs enter the loss math."""
    if isinstance(tree, dict):
        return {k: f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(f32_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.float()
    return tree


def fp32_region(device: torch.device):
    """Autocast off on ``device``: the loss math after ``f32_tree`` runs in
    fp32 under the bf16 policy, as the JAX package's does."""
    return torch.autocast(torch.device(device).type, enabled=False)


def torch_conv_init_(conv: nn.Conv2d) -> nn.Conv2d:
    """PyTorch's default conv init (kaiming uniform, a=sqrt(5)) with a zero
    bias, as the JAX package's variance_scaling(1/3, fan_in, uniform)."""
    nn.init.kaiming_uniform_(conv.weight, a=math.sqrt(5))
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)
    return conv


def normal_init_(conv: nn.Conv2d, std: float = 0.01,
                 bias: float = 0.0) -> nn.Conv2d:
    nn.init.normal_(conv.weight, std=std)
    if conv.bias is not None:
        nn.init.constant_(conv.bias, bias)
    return conv


def bias_init_with_prob(prior_prob: float) -> float:
    """Focal-loss style bias init: -log((1-p)/p)."""
    return -math.log((1 - prior_prob) / prior_prob)


def Conv2d(in_channels: int, out_channels: int, kernel_size: IntPair = 3,
           stride: IntPair = 1, padding: IntPair = 0, dilation: IntPair = 1,
           groups: int = 1, bias: bool = True) -> nn.Conv2d:
    """nn.Conv2d with the JAX package's default init (zero bias)."""
    return torch_conv_init_(nn.Conv2d(in_channels, out_channels, kernel_size,
                                      stride, padding, dilation, groups,
                                      bias=bias))


class FrozenBatchNorm(nn.Module):
    """BatchNorm permanently in eval mode: running statistics are buffers;
    weight and bias stay trainable parameters (the backbone's
    ``norm_eval=True``)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]


class SyncBatchNorm(nn.BatchNorm2d):
    """Train-mode BatchNorm over the global batch, as the JAX package's
    over its whole ``jit`` batch.

    One process: ``F.batch_norm`` on the batch statistics. Under a process
    group: the global batch's mean and biased variance, each the sum over
    ranks through the differentiable all-reduce (so the backward is the
    global batch's too), in two passes. The running variance is updated
    with the BIASED batch variance, as flax does (torch stores the unbiased
    one), so the port's statistics track the JAX package's; torch momentum
    0.1 is flax momentum 0.9. Under the bf16 policy the statistics and the
    normalisation are computed in fp32 and the output comes back in the
    input's dtype, as flax computes them."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.float()
        if pdist.is_distributed():
            return self._global_forward(xf).to(x.dtype)
        with torch.no_grad():
            mean = xf.mean(dim=(0, 2, 3))
            var = xf.var(dim=(0, 2, 3), unbiased=False)
            self._track(mean, var)
        return F.batch_norm(xf, None, None, self.weight, self.bias, True, 0.0,
                            self.eps).to(x.dtype)

    def _track(self, mean, var):
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)

    def _global_forward(self, xf):
        count = xf.new_tensor([xf.numel() // xf.shape[1]])
        s1 = pdist.all_reduce_sum_autograd(
            torch.cat([xf.sum(dim=(0, 2, 3)), count]))
        mean = s1[:-1] / s1[-1]
        centred = xf - mean[None, :, None, None]
        var = pdist.all_reduce_sum_autograd(
            (centred * centred).sum(dim=(0, 2, 3))) / s1[-1]
        self._track(mean.detach(), var.detach())
        inv = torch.rsqrt(var + self.eps) * self.weight
        return centred * inv[None, :, None, None] \
            + self.bias[None, :, None, None]


def GroupNorm(num_channels: int, num_groups: int = 32) -> nn.GroupNorm:
    """GroupNorm with torch's epsilon (1e-5), the JAX package's setting."""
    return nn.GroupNorm(num_groups, num_channels, eps=1e-5)


class ConvModule(nn.Module):
    """conv -> norm -> activation (reference: mmcv ConvModule). The conv
    has a bias iff there is no norm, unless ``bias`` says otherwise; the
    norm is named ``bn`` or ``gn`` as in the reference checkpoints."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntPair = 3, stride: IntPair = 1,
                 padding: IntPair = 0, dilation: IntPair = 1,
                 norm_cfg: Optional[dict] = None, act: Optional[str] = 'relu',
                 bias: Optional[bool] = None, init_std: Optional[float] = None):
        super().__init__()
        use_bias = bias if bias is not None else norm_cfg is None
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           padding, dilation, bias=use_bias)
        if init_std is not None:
            normal_init_(self.conv, init_std)
        self.norm_name = None
        if norm_cfg is not None:
            t = norm_cfg['type']
            if t in ('BN', 'SyncBN'):
                self.norm_name = 'bn'
                self.bn = SyncBatchNorm(out_channels)
            elif t == 'GN':
                self.norm_name = 'gn'
                self.gn = GroupNorm(out_channels,
                                    norm_cfg.get('num_groups', 32))
            else:
                raise ValueError(f'unknown norm type {t}')
        if act not in (None, 'relu'):
            raise ValueError(f'unknown activation {act}')
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.norm_name is not None:
            x = getattr(self, self.norm_name)(x)
        if self.act == 'relu':
            x = F.relu(x)
        return x


class Scale(nn.Module):
    """Learnable scalar multiplier (reference: mmcv.cnn.Scale)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x):
        return x * self.scale


def max_pool_torch(x, kernel_size: int, stride: int, padding: int):
    """Max pool with explicit symmetric padding (padded cells are -inf)."""
    return F.max_pool2d(x, kernel_size, stride, padding)
