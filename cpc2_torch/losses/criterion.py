"""The multi-step InfoNCE criterion with transformer prediction heads
(counterpart of `cpc2_tpu/losses/criterion.py`, reference
`cpc/criterion/criterion.py:97-363`).

The loss keeps the JAX package's formulation:

1. K prediction heads give `preds (B, K, W, D)` with W = S - K;
2. the K positives are shifted slices of z, `pos = Σ_d pred·z / D`;
3. the N negatives, shared across the K heads, are scored by the CUDA
   kernel of `ops/infonce.py` and divided by D;
4. a negative that samples the positive frame is patched with the
   positive's score, so that `pos >= max(neg)` counts it as correct, as the
   reference's single product over (1+N) candidates does;
5. the cross-entropy over (1+N) candidates is `logsumexp - pos`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..models.layers import Dropout
from ..models.transformer import TransformerAR
from ..ops.infonce import negative_scores

Tensor = torch.Tensor
Generator = Optional[torch.Generator]


def sample_negative_indices(generator: Generator, batch_size: int,
                            seq_size: int, n_negative: int, window_size: int,
                            device: torch.device) -> Tensor:
    """Flat rows of z.reshape(B*S, D), the reference's distribution
    (`criterion.py:237-267`): for every (b, n, w) a batch element
    U[0, B) and the frame (U[1, S) + w) mod S. Returns (B, N, W) int32."""
    shape = (batch_size, n_negative, window_size)
    batch_idx = torch.randint(0, batch_size, shape, generator=generator,
                              device=device, dtype=torch.int32)
    seq_idx = torch.randint(1, seq_size, shape, generator=generator,
                            device=device, dtype=torch.int32)
    base = torch.arange(window_size, device=device, dtype=torch.int32)
    seq_idx = torch.remainder(seq_idx + base, seq_size)
    return seq_idx + batch_idx * seq_size


class PredictionNetwork(nn.Module):
    """K independent transformer prediction heads `predictors.{k}`, each a
    one-layer `TransformerAR` over windows of `size_input_seq` frames.
    Returns the stacked predictions `(B, K, W, dim_enc)`."""

    def __init__(self, n_predicts: int, dim_ar: int, dim_enc: int,
                 dropout: bool = False, size_input_seq: int = 116):
        super().__init__()
        self.predictors = nn.ModuleList(
            TransformerAR(dim_enc, dim_ar, 1, size_input_seq)
            for _ in range(n_predicts))
        # the reference's independent 0.5 dropout on every head's output
        self.drop = Dropout(0.5) if dropout else None

    def forward(self, c: Tensor, generator: Generator = None) -> Tensor:
        ys = torch.stack([head(c, None, generator)[0]
                          for head in self.predictors], dim=1)
        if self.drop is not None:
            ys = self.drop(ys, generator)
        return ys


class CPCUnsupervisedCriterion(nn.Module):
    """Multi-step InfoNCE over the encodings of the future view."""

    def __init__(self, n_predicts: int, dim_ar: int, dim_enc: int,
                 negative_sampling_ext: int, dropout: bool = False,
                 size_input_seq: int = 128, n_skipped: int = 0):
        super().__init__()
        self.n_predicts = n_predicts
        self.negative_sampling_ext = negative_sampling_ext
        self.n_skipped = n_skipped
        self.wPrediction = PredictionNetwork(
            n_predicts, dim_ar, dim_enc, dropout=dropout,
            size_input_seq=size_input_seq - n_predicts)

    def forward(self, c_feature: Tensor, encoded_data: Tensor,
                generator: Generator = None,
                negative_indices: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
        """c_feature (B, S, dim_ar), encoded_data (B, S, D) -> per-head
        (losses, accuracies), each (1, K - n_skipped). `negative_indices`
        (B, N, W), flat rows of the pool, replaces the sampled negatives."""
        b, s, _ = c_feature.shape
        d = encoded_data.shape[-1]
        k_p = self.n_predicts
        w = s - k_p
        device = c_feature.device
        preds = self.wPrediction(c_feature[:, :w], generator)  # (B, K, W, D)

        if negative_indices is None:
            neg_idx = sample_negative_indices(
                generator, b, s, self.negative_sampling_ext, w, device)
        else:
            neg_idx = negative_indices.to(device=device, dtype=torch.int32)
            if neg_idx.shape != (b, self.negative_sampling_ext, w):
                raise ValueError(f"negative_indices must be (B, N, W) = "
                                 f"{(b, self.negative_sampling_ext, w)}, got "
                                 f"{tuple(neg_idx.shape)}")
            if bool((neg_idx < 0).any()) or bool((neg_idx >= b * s).any()):
                raise ValueError("negative_indices must lie in [0, B*S)")
        neg_idx_wn = neg_idx.transpose(1, 2).contiguous()     # (B, W, N)

        pos_z = torch.stack([encoded_data[:, k:k + w]
                             for k in range(1, k_p + 1)], dim=1)
        pos = (preds * pos_z).sum(dim=-1) / d                 # (B, K, W)
        z_flat = encoded_data.reshape(b * s, d)
        neg = negative_scores(preds, z_flat, neg_idx_wn) / d  # (B, K, W, N)

        pos_flat_idx = (
            torch.arange(b, device=device)[:, None, None] * s
            + torch.arange(1, k_p + 1, device=device)[None, :, None]
            + torch.arange(w, device=device)[None, None, :])  # (B, K, W)
        collides = neg_idx_wn[:, None] == pos_flat_idx[..., None]
        neg = torch.where(collides, pos[..., None], neg)

        lse = torch.logsumexp(torch.cat([pos[..., None], neg], dim=-1), -1)
        losses = lse - pos                                    # (B, K, W)
        # ties go to the positive, as torch's argmax picks the first maximum
        correct = pos >= neg.max(dim=-1).values
        out_losses = losses.mean(dim=(0, 2))[self.n_skipped:][None, :]
        out_acc = correct.float().mean(dim=(0, 2))[self.n_skipped:][None, :]
        return out_losses, out_acc
