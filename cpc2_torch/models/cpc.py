"""The CPC model: encoder plus context network (counterpart of
`cpc2_tpu/models/cpc.py:CPCModel`, reference `cpc/model.py:279-390`), its
BERT-style variant (`CPCBertModel`, reference `cpc/model.py:393-446`), and
several of them run side by side as one (`ConcatenatedModel`, reference
`cpc/model.py:449-465`).

Submodules are named `gEncoder` and `gAR` (`models.{i}` in a concatenated
model), so the state dict's keys are the reference's. The masks of
`--mask_prob` and of `--cpc_mode bert` are drawn on the host from numpy's
global state (`compute_mask_indices`, `compute_bert_mask`, copies of the
JAX package's), and the training step applies them.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn


def compute_mask_indices(shape: Tuple[int, int], mask_prob: float,
                         mask_length: int, min_masks: int = 0,
                         rng: Optional[np.random.RandomState] = None
                         ) -> np.ndarray:
    """Random span masks (reference `cpc/model.py:300-369`), with its
    `mask_prob * 100 * all_sz / mask_length` kept. Returns (B, S) bool."""
    rng = rng or np.random
    bsz, all_sz = shape
    mask = np.full((bsz, all_sz), False)

    all_num_mask = int(mask_prob * 100 * all_sz / float(mask_length)
                       + rng.rand())
    all_num_mask = max(min_masks, all_num_mask)

    mask_idcs = []
    for _ in range(bsz):
        sz = all_sz
        num_mask = all_num_mask
        lengths = np.full(num_mask, mask_length)
        if sum(lengths) == 0:
            lengths[0] = min(mask_length, sz - 1)
        min_len = min(lengths)
        if sz - min_len <= num_mask:
            min_len = sz - num_mask - 1
        mask_idc = rng.choice(sz - min_len, num_mask, replace=False)
        mask_idc = np.asarray([mask_idc[j] + offset
                               for j in range(len(mask_idc))
                               for offset in range(lengths[j])])
        mask_idcs.append(np.unique(mask_idc[mask_idc < sz]))

    min_len = min(len(m) for m in mask_idcs)
    nb_masked = 0
    for i, mask_idc in enumerate(mask_idcs):
        if len(mask_idc) > min_len:
            mask_idc = rng.choice(mask_idc, min_len, replace=False)
        mask[i, mask_idc] = True
        nb_masked += len(mask_idc)

    percentage_masked = nb_masked / (bsz * all_sz)
    if percentage_masked > 0.6:
        warnings.warn("We detected that %.2f of all encoded frames have been "
                      "masked. This might be too much." % percentage_masked)
    return mask


def compute_bert_mask(shape: Tuple[int, int], n_mask_sentence: int,
                      block_size: int,
                      rng: Optional[np.random.RandomState] = None
                      ) -> np.ndarray:
    """Block masks for BERT-style CPC (reference `cpc/model.py:406-430`):
    `n_mask_sentence` blocks of `block_size` frames a row. (B, S) bool."""
    rng = rng or np.random
    bsz, seq = shape
    mask = np.zeros((bsz, seq), dtype=bool)
    for b in range(bsz):
        starts = rng.randint(0, seq // block_size,
                             size=n_mask_sentence) * block_size
        for s in starts:
            mask[b, s:s + block_size] = True
    return mask


class CPCModel(nn.Module):
    """`forward(batch, hidden, generator)` returns `(c_feature, encoded, new_hidden)`:
    the context `(B, frames, dim_ar)`, the encodings `(B, frames, dim_enc)`
    and the context network's final state. The training step calls its two
    halves, `encode` and `context`, apart.

    With `mask_prob > 0` the model holds `mask_emb` (dim_enc,), drawn from
    U[0, 1) as the JAX package draws it, which the training step writes
    into the context network's input at the masked frames (`mask`); the
    forward, which makes features, masks nothing."""

    def __init__(self, gEncoder: nn.Module, gAR: nn.Module,
                 mask_prob: float = 0.0):
        super().__init__()
        self.gEncoder = gEncoder
        self.gAR = gAR
        self.mask_prob = mask_prob
        if mask_prob > 0.0:
            self.mask_emb = nn.Parameter(
                torch.rand(gEncoder.size_hidden))

    def mask(self, encoded, mask_indices):
        """`encoded` with `mask_emb` at the frames where `mask_indices`
        (B, S) is true (unchanged without `mask_prob`)."""
        if self.mask_prob <= 0.0 or mask_indices is None:
            return encoded
        return torch.where(mask_indices[..., None], self.mask_emb, encoded)

    @property
    def dim_encoded(self) -> int:
        return self.gEncoder.size_hidden

    @property
    def dim_context(self) -> int:
        """The context's width: the recurrent network's, else (a transformer
        or no context network) the encodings'."""
        out = getattr(self.gAR, 'dim_output', None)
        if out is not None:
            return out
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


class CPCBertModel(CPCModel):
    """BERT-style CPC (reference `cpc/model.py:393-446`): the training step
    zeroes the encodings of the masked blocks before the (bidirectional)
    context network, and the criterion scores the masked frames
    (`losses/bert.py`). Without a mask, as in feature extraction, it is
    the plain model. The masks' shape is the trainer's (`train.step_mask`)."""

    def __init__(self, gEncoder: nn.Module, gAR: nn.Module,
                 supervised: bool = False):
        super().__init__(gEncoder, gAR)
        self.supervised = supervised

    def mask(self, encoded, mask_indices):
        if self.supervised or mask_indices is None:
            return encoded
        return torch.where(mask_indices[..., None],
                           torch.zeros_like(encoded), encoded)


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
