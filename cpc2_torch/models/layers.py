"""Shared primitive layers (counterpart of `cpc2_tpu/models/layers.py`).

The JAX package's `TorchLinear` is `Linear` here, an `nn.Linear`: same
layout, same default initialization. Its `LayerNorm` (biased variance,
eps 1e-5, affine `weight`/`bias`) is torch's own. Both follow the JAX
layers for bf16 inputs (the transformer heads under `--precision bf16`):
the linear casts its fp32 parameters to the input's dtype, rounds the
product (fp32 sums) to it, then adds the bias in it; the norm computes in
fp32 and returns the input's dtype. fp32 inputs take torch's own code.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """`nn.Linear`; an input of another dtype than the parameters' (bf16)
    gets `TorchLinear`'s: the product in that dtype, then the bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm`; a bf16 input is normalized in fp32 and the result
    returned in bf16, as the JAX `LayerNorm` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        return super().forward(x.float()).to(x.dtype)


class Dropout(nn.Module):
    """Inverted dropout with an explicit `torch.Generator`; active only in
    training mode and at a nonzero rate (as the JAX `Dropout` is only when
    not `deterministic`)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))
