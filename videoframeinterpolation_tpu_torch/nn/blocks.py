"""Conv building blocks on NHWC tensors (counterpart of ``videoframeinterpolation_tpu/nn/blocks.py``).

Convolutions keep PyTorch's OIHW weights but take and return NHWC tensors:
the input is handed to cuDNN as a channels-last NCHW view of the same
memory, so no layout copy is made. Module and parameter names are those of
the flax modules, so checkpoints map across mechanically
(``interop/flax_params.py``).

Every layer computes in the dtype of its parameters and input (fp32, or
bf16 after ``create_model`` cast the parameters). As in flax's ``Conv``,
``ConvTranspose`` and ``Dense``, the bias is added after the product has
been rounded to that dtype, so a bf16 layer rounds where the JAX layer does.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on ``(B, H, W, C)`` tensors."""

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution without its bias, in the compute dtype."""
        return self._conv_forward(x.permute(0, 3, 1, 2), self.weight, None).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.product(x) + self.bias


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` on ``(B, H, W, C)`` tensors."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, None, self.stride,
                               self.padding, self.output_padding, self.groups, self.dilation)
        return y.permute(0, 2, 3, 1) + self.bias


class Dense(nn.Linear):
    """``nn.Linear`` over the last axis, bias added after the product."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight) + self.bias


class PReLU(nn.Module):
    """Per-channel PReLU as ``max(x, 0) + alpha * min(x, 0)``."""

    def __init__(self, features: int, init_value: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min(x, 0) + self.alpha.to(x.dtype) * torch.clamp_max(x, 0)


def conv(in_features: int, features: int, kernel_size: int = 3, stride: int = 1,
         padding: int = 1) -> Conv2d:
    """Conv2d with symmetric padding and a bias."""
    return Conv2d(in_features, features, kernel_size, stride, padding)


def conv_transpose_x2(in_features: int, features: int) -> ConvTranspose2d:
    """``ConvTranspose2d(kernel=4, stride=2, padding=1)``: exact 2x upsampling."""
    return ConvTranspose2d(in_features, features, 4, stride=2, padding=1)


class ConvPReLU(nn.Module):
    """conv3x3 + per-channel PReLU."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1):
        super().__init__()
        self.conv = conv(in_features, features, kernel_size, stride, padding)
        self.prelu = PReLU(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prelu(self.conv(x))


class ResBlock(nn.Module):
    """conv-PReLU-conv with an identity skip."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = conv(features, features)
        self.prelu = PReLU(features)
        self.conv2 = conv(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(self.prelu(self.conv1(x)))


def ResBlocks(features: int, n_blocks: int) -> nn.Sequential:
    """A stack of ``n_blocks`` ResBlocks named ``block0``, ``block1``, ..."""
    return nn.Sequential(OrderedDict(
        (f"block{i}", ResBlock(features)) for i in range(n_blocks)))


class HalfChannelConv5ResBlock(nn.Module):
    """5-conv residual block whose last ``side_features`` channels are
    refined twice by a side conv."""

    def __init__(self, features: int, side_features: int,
                 final_activation: bool = True):
        super().__init__()
        c, s = features, side_features
        self.side = s
        self.final_activation = final_activation
        self.conv1 = conv(c, c)
        self.prelu1 = PReLU(c)
        self.conv2 = conv(s, s)
        self.conv2_prelu = PReLU(s)
        self.conv3 = conv(c, c)
        self.prelu3 = PReLU(c)
        self.conv4 = conv(s, s)
        self.conv4_prelu = PReLU(s)
        self.conv5 = conv(c, c)
        if final_activation:
            self.prelu5 = PReLU(c)

    def _refine_side(self, h: torch.Tensor, side_conv: nn.Module,
                     side_prelu: nn.Module) -> torch.Tensor:
        main, side = h[..., :-self.side], h[..., -self.side:]
        return torch.cat([main, side_prelu(side_conv(side))], dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.prelu1(self.conv1(x))
        out = self._refine_side(out, self.conv2, self.conv2_prelu)
        out = self.prelu3(self.conv3(out))
        out = self._refine_side(out, self.conv4, self.conv4_prelu)
        out = x + self.conv5(out)
        if self.final_activation:
            out = self.prelu5(out)
        return out


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU as ``jax.nn.gelu(x, approximate=False)`` computes it:
    ``0.5 * x * erfc(-x * sqrt(0.5))``, with ``sqrt(0.5)`` rounded to ``x``'s
    dtype, erfc taken in fp32, and its value and the result rounded to
    ``x``'s dtype."""
    sqrt_half = torch.tensor(0.5 ** 0.5, dtype=x.dtype).item()
    return (0.5 * x) * torch.erfc(-x.float() * sqrt_half).to(x.dtype)


class FeedForward(nn.Module):
    """Per-pixel MLP: Dense, exact (erf) GELU, Dense."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features)
        self.fc2 = Dense(hidden_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))
