"""Masked-position InfoNCE for BERT-style CPC (counterpart of
`cpc2_tpu/losses/bert.py`, reference `cpc/criterion/research/bert.py`).

The loss is computed at every position with fixed shapes and averaged over
the masked ones; the negatives are drawn uniformly over the unmasked frames
of the whole batch, as the JAX package's categorical draw with -inf logits
at the masked frames does. The draw is made on the device from the
generator: a uniform rank among the unmasked frames, turned into a frame by
a search over their running count, so it has the same shapes whatever the
mask (a CUDA graph can replay it). No kernel: the JAX package scores these
outside any Pallas body too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

Tensor = torch.Tensor


def sample_unmasked(generator: Optional[torch.Generator], mask: Tensor,
                    n_negative: int) -> Tensor:
    """(B*S, N) int64 flat frames, each uniform over the frames where the
    (B, S) `mask` is false."""
    free = (~mask.reshape(-1)).to(torch.int64)
    count = torch.cumsum(free, 0)                       # unmasked up to i
    n_free = count[-1].clamp_min(1)
    u = torch.rand((free.numel(), n_negative), generator=generator,
                   device=mask.device)
    rank = torch.minimum((u * n_free).to(torch.int64), n_free - 1)
    # the first frame whose running count reaches rank + 1
    return torch.searchsorted(count, rank + 1).clamp_max(free.numel() - 1)


class CPCBertCriterion(nn.Module):
    """`wPrediction`, a bias-free (dim_ar -> dim_enc) linear map, scored at
    every frame against the frame's own encoding and N negatives; the loss
    and accuracy are the means over the masked frames. `label` is the
    (B, S) mask of the past views."""

    def __init__(self, dim_ar: int, dim_enc: int, negative_sampling_ext: int):
        super().__init__()
        self.negative_sampling_ext = negative_sampling_ext
        self.wPrediction = nn.Linear(dim_ar, dim_enc, bias=False)

    def forward(self, c_feature: Tensor, encoded_data: Tensor, label: Tensor,
                generator: Optional[torch.Generator] = None,
                negative_indices: Optional[Tensor] = None,
                example_weights: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
        """`negative_indices` (B*S, N), flat frames of the batch, replaces
        the draw. `example_weights` (B,): each example's mean over its own
        masked frames, weighted and summed over the batch
        (`cpc2_tpu/losses/bert.py:61-70`)."""
        b, s, _ = c_feature.shape
        d = encoded_data.shape[-1]
        mask = label.to(torch.bool)
        n_pos = mask.sum().clamp_min(1).to(torch.float32)
        preds = self.wPrediction(c_feature)                   # (B, S, D)
        if negative_indices is None:
            neg_idx = sample_unmasked(generator, mask,
                                      self.negative_sampling_ext)
        else:
            neg_idx = negative_indices.to(device=c_feature.device,
                                          dtype=torch.int64)
            if neg_idx.shape != (b * s, self.negative_sampling_ext):
                raise ValueError(
                    f"negative_indices must be (B*S, N) = "
                    f"{(b * s, self.negative_sampling_ext)}, got "
                    f"{tuple(neg_idx.shape)}")
        z_flat = encoded_data.reshape(b * s, d)
        pos = (preds * encoded_data).mean(dim=-1)             # (B, S)
        neg_z = z_flat[neg_idx]                               # (B*S, N, D)
        neg = (preds.reshape(b * s, 1, d) * neg_z).mean(dim=-1).reshape(
            b, s, self.negative_sampling_ext)
        lse = torch.logsumexp(torch.cat([pos[..., None], neg], dim=-1), -1)
        losses = lse - pos
        correct = pos >= neg.max(dim=-1).values
        w = mask.to(torch.float32)
        if example_weights is not None:
            ew = example_weights.to(torch.float32)
            per_n = w.sum(dim=1).clamp_min(1)
            per_loss = (losses * w).sum(dim=1) / per_n
            per_acc = (correct.to(torch.float32) * w).sum(dim=1) / per_n
            return ((per_loss * ew).sum().reshape(1, 1),
                    (per_acc * ew).sum().reshape(1, 1))
        loss = (losses * w).sum() / n_pos
        acc = (correct.to(torch.float32) * w).sum() / n_pos
        return loss.reshape(1, 1), acc.reshape(1, 1)
