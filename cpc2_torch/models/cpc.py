"""The CPC model: encoder plus context network (counterpart of
`cpc2_tpu/models/cpc.py:CPCModel`, reference `cpc/model.py:279-390`), and
several of them run side by side as one (`ConcatenatedModel`, reference
`cpc/model.py:449-465`).

Submodules are named `gEncoder` and `gAR` (`models.{i}` in a concatenated
model), so the state dict's keys are the reference's.
"""

from __future__ import annotations

import torch
from torch import nn


class CPCModel(nn.Module):
    """`forward(batch, hidden, generator)` returns `(c_feature, encoded, new_hidden)`:
    the context `(B, frames, dim_ar)`, the encodings `(B, frames, dim_enc)`
    and the context network's final state. The training step calls its two
    halves, `encode` and `context`, apart."""

    def __init__(self, gEncoder: nn.Module, gAR: nn.Module):
        super().__init__()
        self.gEncoder = gEncoder
        self.gAR = gAR

    @property
    def dim_encoded(self) -> int:
        return self.gEncoder.size_hidden

    @property
    def dim_context(self) -> int:
        """The context's width: the recurrent network's, else (a transformer
        or no context network) the encodings'."""
        net = getattr(self.gAR, 'baseNet', None)
        return net.dim_hidden if net is not None else self.dim_encoded

    @property
    def keeps_hidden(self) -> bool:
        """Whether training carries the context network's state from batch
        to batch (the reference's `keepHidden`)."""
        return getattr(self.gAR, 'keep_hidden', False)

    def encode(self, batch):
        return self.gEncoder(batch)

    def context(self, encoded, hidden=None, generator=None):
        return self.gAR(encoded, hidden, generator)

    def forward(self, batch, hidden=None, generator=None):
        encoded = self.encode(batch)
        c_feature, hidden = self.context(encoded, hidden, generator)
        return c_feature, encoded, hidden


class ConcatenatedModel(nn.Module):
    """Several models on the same audio, their encodings and contexts
    concatenated on the channel axis; the state is a list of one entry per
    model."""

    def __init__(self, models):
        super().__init__()
        self.models = nn.ModuleList(models)

    @property
    def dim_encoded(self) -> int:
        return sum(m.dim_encoded for m in self.models)

    @property
    def dim_context(self) -> int:
        return sum(m.dim_context for m in self.models)

    @property
    def keeps_hidden(self) -> bool:
        return any(m.keeps_hidden for m in self.models)

    def _hiddens(self, hidden):
        return [None] * len(self.models) if hidden is None else hidden

    def encode(self, batch):
        return torch.cat([m.encode(batch) for m in self.models], dim=2)

    def context(self, encoded, hidden=None, generator=None):
        """Each model's context network on its own channels of `encoded`."""
        parts = torch.split(encoded, [m.dim_encoded for m in self.models],
                            dim=2)
        outs = [m.context(part, h, generator) for m, part, h in
                zip(self.models, parts, self._hiddens(hidden))]
        return (torch.cat([c for c, _h in outs], dim=2),
                [h for _c, h in outs])

    def forward(self, batch, hidden=None, generator=None):
        outs = [m(batch, h, generator)
                for m, h in zip(self.models, self._hiddens(hidden))]
        return (torch.cat([c for c, _e, _h in outs], dim=2),
                torch.cat([e for _c, e, _h in outs], dim=2),
                [h for _c, _e, h in outs])
