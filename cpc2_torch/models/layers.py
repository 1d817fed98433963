"""Shared primitive layers (counterpart of `cpc2_tpu/models/layers.py`).

The JAX package's `TorchLinear` is `nn.Linear` here: same layout, same
default initialization. Its `LayerNorm` (biased variance, eps 1e-5, affine
`weight`/`bias`) is torch's own.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

LayerNorm = nn.LayerNorm


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
