"""Equalized-learning-rate layers (counterpart of
`cpc2_tpu/losses/custom_layers.py`, reference
`cpc/criterion/custom_layers.py`).

Weights are drawn from N(0, 1) and scaled at run time by He's constant
`sqrt(2 / fan_in)`; biases start at zero. The layer a
`ConstrainedLayer` wraps is its submodule `module`, so the state dict's
keys are the reference's (`lin1.module.weight`).
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
from torch import nn

Tensor = torch.Tensor


class NormalizationLayer(nn.Module):
    """x / rms(x) over axis 1 (reference `custom_layers.py:13-19`)."""

    def forward(self, x: Tensor, epsilon: float = 1e-8) -> Tensor:
        return x * torch.rsqrt((x * x).mean(dim=1, keepdim=True) + epsilon)


def upscale2d(x: Tensor, factor: int = 2) -> Tensor:
    """Nearest-neighbour upscale of (B, C, H, W) by an integer factor
    (reference `custom_layers.py:22-30`)."""
    if not (isinstance(factor, int) and factor >= 1):
        raise AssertionError("factor must be a positive int")
    if factor == 1:
        return x
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)



class ConstrainedLayer(nn.Module):
    """Wraps `module` with the run-time He scaling of its output
    (reference `custom_layers.py:33-78`, always equalized, as every caller
    in the JAX package builds it): the weight is drawn from N(0, 1), as
    the JAX package draws it, and the product (before the bias) is
    multiplied by `sqrt(2 / fan_in)`; the bias starts at zero."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module
        if module.bias is not None:
            nn.init.zeros_(module.bias)
        with torch.no_grad():
            module.weight.normal_(0.0, 1.0)
        self.scale = math.sqrt(2.0 / math.prod(module.weight.shape[1:]))


class EqualizedLinear(ConstrainedLayer):
    """Linear with run-time He scaling (reference `custom_layers.py:134-151`):
    `module` is the `nn.Linear`, weight (out, in)."""

    def __init__(self, n_in: int, n_out: int, bias: bool = True):
        super().__init__(nn.Linear(n_in, n_out, bias=bias))

    def forward(self, x: Tensor) -> Tensor:
        y = torch.matmul(x, self.module.weight.t()) * self.scale
        if self.module.bias is not None:
            y = y + self.module.bias
        return y


class EqualizedConv1d(ConstrainedLayer):
    """Conv1d with run-time He scaling (reference `custom_layers.py:81-105`)
    on NCW input; `module` is the `nn.Conv1d`, weight (out, in, k).
    `padding` is symmetric (an int) or (left, right)."""

    def __init__(self, n_in: int, n_out: int, kernel_size: int,
                 padding: Union[int, Tuple[int, int]] = 0, bias: bool = True,
                 stride: int = 1):
        super().__init__(nn.Conv1d(n_in, n_out, kernel_size, stride=stride,
                                   padding=0, bias=bias))
        self.pad = padding if isinstance(padding, tuple) else (padding,
                                                                padding)

    def forward(self, x: Tensor) -> Tensor:
        conv = self.module
        if self.pad != (0, 0):
            x = nn.functional.pad(x, self.pad)
        y = nn.functional.conv1d(x, conv.weight, None,
                                 conv.stride) * self.scale
        if conv.bias is not None:
            y = y + conv.bias[None, :, None]
        return y
