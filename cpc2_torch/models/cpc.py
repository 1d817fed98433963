"""The CPC model: encoder plus context network (counterpart of
`cpc2_tpu/models/cpc.py:CPCModel`, reference `cpc/model.py:279-390`).

Submodules are named `gEncoder` and `gAR`, so the state dict's keys are the
reference's.
"""

from __future__ import annotations

from torch import nn


class CPCModel(nn.Module):
    """`forward(batch, hidden, generator)` returns `(c_feature, encoded, new_hidden)`:
    the context `(B, frames, dim_ar)`, the encodings `(B, frames, dim_enc)`
    and the context network's final state."""

    def __init__(self, gEncoder: nn.Module, gAR: nn.Module):
        super().__init__()
        self.gEncoder = gEncoder
        self.gAR = gAR

    def forward(self, batch, hidden=None, generator=None):
        encoded = self.gEncoder(batch)
        c_feature, hidden = self.gAR(encoded, hidden, generator)
        return c_feature, encoded, hidden
