"""Conv building blocks on NHWC tensors (counterpart of ``videoframeinterpolation_tpu/nn/blocks.py``).

Convolutions keep PyTorch's OIHW weights but take and return NHWC tensors:
the input is handed to cuDNN as a channels-last NCHW view of the same
memory, so no layout copy is made. Module and parameter names are those of
the flax modules, so checkpoints map across mechanically
(``interop/flax_params.py``).

Every layer computes in the dtype of its input, and casts its parameters
to it at each call, as flax does: a model trained in bf16 keeps fp32
master parameters and the gradient flows back through the cast. A served
model has its parameters cast once at load (``create_model``), and the
cast is then a no-op. As in flax's ``Conv``, ``ConvTranspose`` and
``Dense``, the bias is added after the product has been rounded to that
dtype, so a bf16 layer rounds where the JAX layer does.

Initialisation follows the JAX package's rules (its ``nn/blocks.py:23-26``):
each layer's kernel is drawn by the rule its JAX counterpart names
(:func:`torch_conv_init` by default, :func:`res_scaled_init` in residual
blocks, :func:`zero_init` for the offset and mask predictors), its bias is
zero and a PReLU starts at 0.25. The fan-in is the JAX kernel's
(``kh * kw * in`` for both convolutions, ``in`` for a dense layer).
The draws come from torch's generator, so they are not JAX's numbers.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def _fan_in(module: nn.Module) -> int:
    """The fan-in of the JAX kernel that ``module``'s weight stands for."""
    w = module.weight
    if isinstance(module, nn.ConvTranspose2d):   # (I, O, kh, kw)
        return w.shape[0] * w.shape[2] * w.shape[3]
    return w[0].numel()                          # (O, I, kh, kw) or (O, I)


def torch_conv_init(w: torch.Tensor, fan_in: int) -> None:
    """torch's default conv init, ``U(+-1/sqrt(fan_in))``: JAX's
    ``variance_scaling(1/3, "fan_in", "uniform")``."""
    bound = 1.0 / math.sqrt(fan_in)
    nn.init.uniform_(w, -bound, bound)


def res_scaled_init(w: torch.Tensor, fan_in: int) -> None:
    """0.1-scaled kaiming normal, ``N(0, 0.02 / fan_in)``: JAX's
    ``variance_scaling(0.02, "fan_in", "normal")``."""
    nn.init.normal_(w, 0.0, math.sqrt(0.02 / fan_in))


def zero_init(w: torch.Tensor, fan_in: int) -> None:
    nn.init.zeros_(w)


def trunc_normal_02(w: torch.Tensor, fan_in: int = 0) -> None:
    """flax's ``truncated_normal(stddev=0.02)``: ``N(0, 0.02)`` truncated at
    two standard deviations, with no correction of the spread (the Swin
    layers' kernels and relative position tables)."""
    nn.init.trunc_normal_(w, 0.0, 0.02, -0.04, 0.04)


Init = Callable[[torch.Tensor, int], None]


class _Initialised:
    """Kernel drawn by ``self.kernel_init`` (set before the base class's
    ``__init__`` runs its ``reset_parameters``), bias zero."""

    kernel_init: Init = staticmethod(torch_conv_init)

    def reset_parameters(self) -> None:
        self.kernel_init(self.weight, _fan_in(self))
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class Conv2d(_Initialised, nn.Conv2d):
    """``nn.Conv2d`` on ``(B, H, W, C)`` tensors."""

    def __init__(self, *args, kernel_init: Init = torch_conv_init, **kwargs):
        self.kernel_init = kernel_init
        super().__init__(*args, **kwargs)

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution without its bias, in ``x``'s dtype."""
        return self._conv_forward(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                                  None).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.product(x) + self.bias.to(x.dtype)


class ConvTranspose2d(_Initialised, nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` on ``(B, H, W, C)`` tensors."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), None,
                               self.stride, self.padding, self.output_padding, self.groups,
                               self.dilation)
        return y.permute(0, 2, 3, 1) + self.bias.to(x.dtype)


class Dense(_Initialised, nn.Linear):
    """``nn.Linear`` over the last axis, bias (if any) added after the product."""

    def __init__(self, *args, kernel_init: Init = torch_conv_init, **kwargs):
        self.kernel_init = kernel_init
        super().__init__(*args, **kwargs)

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """The product without its bias, in ``x``'s dtype."""
        return F.linear(x, self.weight.to(x.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.product(x)
        return y if self.bias is None else y + self.bias.to(x.dtype)


class Float32Params:
    """A module whose own parameters stay fp32 when the model is cast to
    another dtype (``create_model(cfg)`` for a bf16 model), as flax keeps a
    parameter that its layer uses in fp32 whatever the compute dtype (the
    Swin attention's position bias table, :class:`LayerNorm`'s scale and
    bias). A move to another device still moves them."""

    def _apply(self, fn, recurse=True):
        own = {n: p.data for n, p in self.named_parameters(recurse=False)}
        super()._apply(fn, recurse)
        for n, p in self.named_parameters(recurse=False):
            if p.dtype != torch.float32:
                p.data = own[n].to(device=p.device, dtype=torch.float32)
        return self


class LayerNorm(Float32Params, nn.Module):
    """flax's ``nn.LayerNorm`` over the last axis (``torch.nn.LayerNorm``
    computes another function): epsilon 1e-6; the statistics taken in fp32
    from any input dtype, the variance in the fast form ``max(0, E[x^2] -
    E[x]^2)``; ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in fp32,
    rounded to the input's dtype once. ``scale`` starts at one and
    ``bias`` at zero, both fp32."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 * x32).mean(dim=-1, keepdim=True) - mean * mean
        var = torch.maximum(var, var.new_zeros(()))
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.scale.float()) + self.bias.float()
        return y.to(x.dtype)


class PReLU(nn.Module):
    """Per-channel PReLU as ``max(x, 0) + alpha * min(x, 0)``, with
    ``torch.maximum``/``torch.minimum`` so that at ``x == 0`` each side gets
    half the gradient, as ``jnp.maximum``/``jnp.minimum`` give it."""

    def __init__(self, features: int, init_value: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        zero = x.new_zeros(())
        return torch.maximum(x, zero) + self.alpha.to(x.dtype) * torch.minimum(x, zero)


def conv(in_features: int, features: int, kernel_size: int = 3, stride: int = 1,
         padding: int = 1, kernel_init: Init = torch_conv_init) -> Conv2d:
    """Conv2d with symmetric padding and a bias."""
    return Conv2d(in_features, features, kernel_size, stride, padding, kernel_init=kernel_init)


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
        self.conv1 = conv(features, features, kernel_init=res_scaled_init)
        self.prelu = PReLU(features)
        self.conv2 = conv(features, features, kernel_init=res_scaled_init)

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


class _Logistic(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.reciprocal(1.0 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        return grad * (y * (1.0 - y))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA computes it: ``1 / (1 + exp(-x))``, each
    step rounded to ``x``'s dtype (in bf16, ``torch.sigmoid``'s single
    rounding differs in a quarter of the values), and the gradient as
    JAX's rule gives it, ``g * (y * (1 - y))``."""
    return _Logistic.apply(x)


def avg_pool(x: torch.Tensor, s: int) -> torch.Tensor:
    """``flax.linen.avg_pool(x, (s, s), strides=(s, s))`` of ``(B, H, W, C)``
    (H and W divisible by ``s``): the ``s x s`` window's sum, taken one term
    at a time in row-major window order in ``x``'s dtype, as XLA's
    reduce-window takes it on the CPU (in bf16 each partial sum is rounded),
    then divided by ``s * s``."""
    B, H, W, C = x.shape
    cells = x.reshape(B, H // s, s, W // s, s, C)
    total = cells[:, :, 0, :, 0]
    for i in range(s):
        for j in range(s):
            if i or j:
                total = total + cells[:, :, i, :, j]
    return total / (s * s)


class FeedForward(nn.Module):
    """Per-pixel MLP: Dense, exact (erf) GELU, Dense."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features)
        self.fc2 = Dense(hidden_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))
