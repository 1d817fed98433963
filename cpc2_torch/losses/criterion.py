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

The prediction heads are `--rnnMode`'s (transformer, RNN, LSTM, linear,
ffd, conv4/8/12; `transformer_adaptive_span` is the linear head, as in the
JAX package, which has no adaptive span), or with `--multihead_rnn` one
shared transformer trunk whose FFN emits all K heads
(`MultiHeadPredictionNetwork`). `--cpc_mode reverse` flips time in the
criterion as in the context network, `--cpc_mode none` trains nothing
(`NoneCriterion`), and `--signal_quality_path` weights each window's loss
by a sigmoid of its mean signal quality.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import nn

from ..models.ar import StackedRNN
from ..models.layers import Dropout
from ..models.transformer import MultiHeadTransformerAR, TransformerAR
from ..ops.infonce import negative_scores
from ..parallel.data_parallel import gather_pool
from .custom_layers import EqualizedConv1d, EqualizedLinear

Tensor = torch.Tensor
Generator = Optional[torch.Generator]


def sample_negative_indices(generator: Generator, batch_size: int,
                            seq_size: int, n_negative: int, window_size: int,
                            device: torch.device,
                            pool_group: Optional[int] = None,
                            pool_batch: Optional[int] = None) -> Tensor:
    """Flat rows of z.reshape(B*S, D), the reference's distribution
    (`criterion.py:237-267`): for every (b, n, w) a batch element
    U[0, B) and the frame (U[1, S) + w) mod S. Returns (B, N, W) int32.

    `pool_group` G narrows the batch element's draw to b's group of G
    contiguous elements, (b // G) * G + U[0, G): the reference's
    DataParallel workers, each drawing within its own shard
    (`cpc2_tpu/losses/criterion.py:251-280`). The draws are the same two
    `randint`s in the same order, so G = B gives the whole-batch draw.
    `pool_batch` widens it instead to U[0, pool_batch), the elements of
    every rank's batch (`--global_negatives`); the two exclude each
    other."""
    shape = (batch_size, n_negative, window_size)
    if pool_group:
        if pool_batch is not None:
            raise ValueError("pool_group and pool_batch are mutually "
                             "exclusive")
        if batch_size % pool_group:
            raise ValueError(f"pool_group {pool_group} must divide the "
                             f"batch {batch_size}")
        group_base = (torch.arange(batch_size, device=device,
                                   dtype=torch.int32)
                      // pool_group * pool_group)[:, None, None]
        batch_idx = group_base + torch.randint(
            0, pool_group, shape, generator=generator, device=device,
            dtype=torch.int32)
    else:
        batch_idx = torch.randint(0, pool_batch or batch_size, shape,
                                  generator=generator, device=device,
                                  dtype=torch.int32)
    seq_idx = torch.randint(1, seq_size, shape, generator=generator,
                            device=device, dtype=torch.int32)
    base = torch.arange(window_size, device=device, dtype=torch.int32)
    seq_idx = torch.remainder(seq_idx + base, seq_size)
    return seq_idx + batch_idx * seq_size


class FFNetwork(nn.Module):
    """The `ffd` head (reference `criterion.py:11-20`): EqualizedLinear ->
    ReLU -> EqualizedLinear, widths dim_ar -> dim_enc -> dim_enc, no
    dropout (the JAX package builds it at rate 0). Not the transformer's
    FFN, and no kernel in the JAX package either."""

    def __init__(self, din: int, dout: int, dff: int):
        super().__init__()
        self.lin1 = EqualizedLinear(din, dff)
        self.lin2 = EqualizedLinear(dff, dout)

    def forward(self, x: Tensor) -> Tensor:
        return self.lin2(torch.relu(self.lin1(x)))


class ShiftedConv(nn.Module):
    """The `conv4/8/12` head (reference `criterion.py:23-41`): a causal
    (left-padded) equalized Conv1d, its layer `module.module` as in the
    reference's state dicts. (B, W, C) in and out."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.module = EqualizedConv1d(dim_in, dim_out, kernel_size,
                                      padding=(kernel_size - 1, 0))

    def forward(self, x: Tensor) -> Tensor:
        return self.module(x.transpose(1, 2)).transpose(1, 2)


def linear_predictor(dim_ar: int, dim_enc: int,
                     residual_std: float = 0.01) -> nn.Linear:
    """The `linear` head (reference `criterion.py:144-150`), no bias:
    torch's default initialization, unless dim_enc > dim_ar, where the
    weight is [randn(ar, ar); 0.01 * randn(enc - ar, ar)]."""
    layer = nn.Linear(dim_ar, dim_enc, bias=False)
    if dim_enc > dim_ar:
        with torch.no_grad():
            layer.weight.copy_(torch.cat([
                torch.randn(dim_ar, dim_ar),
                residual_std * torch.randn(dim_enc - dim_ar, dim_ar)]))
    return layer


RNN_MODES = ('transformer', 'RNN', 'LSTM', 'linear', 'ffd', 'conv4',
             'conv8', 'conv12', 'transformer_adaptive_span')


class PredictionNetwork(nn.Module):
    """K independent prediction heads `predictors.{k}` of `rnn_mode`
    (`cpc2_tpu/losses/criterion.py:121-212`, reference
    `criterion.py:97-173`). Returns the stacked predictions
    `(B, K, W, dim_enc)`.

    - `transformer`: a one-layer `TransformerAR` over windows of
      `size_input_seq` frames; with `head_dtype` (bf16 under `--precision
      bf16`) the context goes into the heads in that dtype and their
      outputs come back in fp32, as the JAX package casts around its heads
      (`cpc2_tpu/losses/criterion.py:192-201`); every other mode ignores it;
    - `RNN`: a one-layer tanh RNN that, like the reference's `nn.RNN`
      without `batch_first`, scans the (B, W, C) context over the batch
      axis: the JAX package keeps that, and so does the port;
    - `LSTM`: a one-layer LSTM over the frames, its recurrence the LSTM
      kernel (`ops/lstm.py`), one call a head;
    - `ffd`: `FFNetwork`; `conv4/8/12`: `ShiftedConv` of that many taps;
    - `linear` and `transformer_adaptive_span` (which the JAX package also
      runs as the linear head, having no adaptive span): `linear_predictor`.
    """

    def __init__(self, n_predicts: int, dim_ar: int, dim_enc: int,
                 dropout: bool = False, size_input_seq: int = 116,
                 rnn_mode: str = 'transformer',
                 head_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if rnn_mode not in RNN_MODES:
            raise ValueError(f"unknown rnnMode {rnn_mode!r}")
        self.rnn_mode = rnn_mode
        self.head_dtype = head_dtype if rnn_mode == 'transformer' else None

        def head():
            if rnn_mode == 'transformer':
                return TransformerAR(dim_enc, dim_ar, 1, size_input_seq)
            if rnn_mode in ('RNN', 'LSTM'):
                return StackedRNN(dim_ar, dim_enc, 1, rnn_mode)
            if rnn_mode == 'ffd':
                return FFNetwork(dim_ar, dim_enc, dim_enc)
            if rnn_mode.startswith('conv'):
                return ShiftedConv(dim_ar, dim_enc, int(rnn_mode[4:]))
            return linear_predictor(dim_ar, dim_enc)

        self.predictors = nn.ModuleList(head() for _ in range(n_predicts))
        # the reference's independent 0.5 dropout on every head's output
        self.drop = Dropout(0.5) if dropout else None

    def _head(self, head: nn.Module, c: Tensor, generator: Generator
              ) -> Tensor:
        if self.rnn_mode == 'transformer':
            return head(c, None, generator)[0]
        if self.rnn_mode == 'RNN':
            return head(c.transpose(0, 1))[0].transpose(0, 1)
        if self.rnn_mode == 'LSTM':
            return head(c)[0]
        return head(c)

    def forward(self, c: Tensor, generator: Generator = None) -> Tensor:
        if self.head_dtype is not None:
            c = c.to(self.head_dtype)
        ys = torch.stack([self._head(head, c, generator)
                          for head in self.predictors], dim=1)
        if self.head_dtype is not None:
            ys = ys.float()
        if self.drop is not None:
            ys = self.drop(ys, generator)
        return ys


class MultiHeadPredictionNetwork(nn.Module):
    """`--multihead_rnn` (`cpc2_tpu/losses/criterion.py:215-244`, reference
    `criterion.py:44-94`): one transformer trunk, `predictor`, whose
    classifier head emits the K predictions from one FFN of width
    dim_ar -> 2048 -> K x dim_ar (the FFN kernel, one call for all K).
    Returns `(B, K, W, dim_enc)`. It runs in fp32 under every
    `--precision`, as the JAX package's does."""

    def __init__(self, n_predicts: int, dim_ar: int, dim_enc: int,
                 dropout: bool = False, size_input_seq: int = 116,
                 rnn_mode: str = 'transformer'):
        super().__init__()
        if rnn_mode != 'transformer':
            raise ValueError(f"unknown mode {rnn_mode}")
        self.predictor = MultiHeadTransformerAR(dim_enc, dim_ar, 1,
                                                size_input_seq, n_predicts)
        self.drop = Dropout(0.5) if dropout else None

    def forward(self, c: Tensor, generator: Generator = None) -> Tensor:
        y = self.predictor(c, generator).permute(0, 2, 1, 3)
        if self.drop is not None:
            y = self.drop(y, generator)
        return y


class NoneCriterion(nn.Module):
    """`--cpc_mode none` (reference `criterion.py:185-191`): a constant
    zero loss and accuracy, (1, 1). The training step still runs Adam on
    zero gradients, as the JAX step does."""

    def forward(self, c_feature: Tensor, encoded_data: Tensor,
                generator: Generator = None,
                negative_indices: Optional[Tensor] = None,
                quality: Optional[Tensor] = None,
                example_weights: Optional[Tensor] = None,
                pool=None) -> Tuple[Tensor, Tensor]:
        zeros = torch.zeros((1, 1), device=c_feature.device)
        return zeros, zeros.clone()


class CPCUnsupervisedCriterion(nn.Module):
    """Multi-step InfoNCE over the encodings of the future view.
    `head_dtype`: the transformer heads' activation dtype (bf16 under
    `--precision bf16`, else None: fp32). `neg_pool_group` G
    (`--neg_pool_group`, 0: the whole batch) draws each element's negatives
    within its group of G contiguous elements; a batch of at most G
    elements, or one that G does not divide, pools over the whole batch, as
    a DataParallel worker holding a short tail shard does
    (`cpc2_tpu/losses/criterion.py:440-449`)."""

    def __init__(self, n_predicts: int, dim_ar: int, dim_enc: int,
                 negative_sampling_ext: int, dropout: bool = False,
                 size_input_seq: int = 128, n_skipped: int = 0,
                 mode: Optional[str] = None, rnn_mode: str = 'transformer',
                 multihead_rnn: bool = False, growth_rate: float = 10.0,
                 inflection_point_x: float = 0.5,
                 head_dtype: Optional[torch.dtype] = None,
                 neg_pool_group: int = 0):
        super().__init__()
        if mode not in (None, "reverse"):
            raise ValueError("Invalid mode")
        self.n_predicts = n_predicts
        self.neg_pool_group = neg_pool_group
        self.negative_sampling_ext = negative_sampling_ext
        self.n_skipped = n_skipped
        self.mode = mode
        self.growth_rate = growth_rate
        self.inflection_point_x = inflection_point_x
        network = (MultiHeadPredictionNetwork if multihead_rnn
                   else functools.partial(PredictionNetwork,
                                          head_dtype=head_dtype))
        self.wPrediction = network(
            n_predicts, dim_ar, dim_enc, dropout=dropout,
            size_input_seq=size_input_seq - n_predicts, rnn_mode=rnn_mode)

    def _oriented(self, c_feature: Tensor, encoded_data: Tensor
                  ) -> Tuple[Tensor, Tensor]:
        """`--cpc_mode reverse` predicts the past: time flipped."""
        if self.mode == "reverse":
            return torch.flip(c_feature, (1,)), torch.flip(encoded_data, (1,))
        return c_feature, encoded_data

    def forward(self, c_feature: Tensor, encoded_data: Tensor,
                generator: Generator = None,
                negative_indices: Optional[Tensor] = None,
                quality: Optional[Tensor] = None,
                example_weights: Optional[Tensor] = None,
                pool=None) -> Tuple[Tensor, Tensor]:
        """c_feature (B, S, dim_ar), encoded_data (B, S, D) -> per-head
        (losses, accuracies), each (1, K - n_skipped). `negative_indices`
        (B, N, W), flat rows of the pool, replaces the sampled negatives;
        the kernels then take the whole pool's plan, whatever the group,
        since nothing says such indices keep to their groups.
        `quality` (B, Q), the windows' signal quality, weights each
        window's losses by 1e-5 + sigmoid(growth_rate * (mean - inflection
        point)) (`cpc2_tpu/losses/criterion.py:526-530`).

        `pool` (`--global_negatives`, a `parallel.DataParallel` of more
        than one rank): the negatives are drawn over every rank's
        encodings, gathered into a pool of ranks x B x S rows in rank
        order (`parallel.gather_pool`), and this rank's positives sit at
        its offset rank x B x S in it (`cpc2_tpu/losses/criterion.py:
        434-438`). `example_weights` (B,): per-example means over the
        window, weighted sums over the batch, which the caller divides by
        the weights' sum over the ranks (the weighted step of
        `training.Trainer`)."""
        c_feature, encoded_data = self._oriented(c_feature, encoded_data)
        b, s, _ = c_feature.shape
        d = encoded_data.shape[-1]
        k_p = self.n_predicts
        w = s - k_p
        device = c_feature.device
        preds = self.wPrediction(c_feature[:, :w], generator)  # (B, K, W, D)

        ranks = 1 if pool is None else pool.world
        z_flat = encoded_data.reshape(b * s, d)
        shard_offset = 0
        if ranks > 1:
            if self.neg_pool_group:
                raise ValueError("neg_pool_group and global negatives are "
                                 "mutually exclusive")
            z_flat = gather_pool(z_flat, pool)
            shard_offset = pool.rank * b * s
        group = self.neg_pool_group
        if group and (b <= group or b % group):
            group = 0
        if negative_indices is None:
            neg_idx = sample_negative_indices(
                generator, b, s, self.negative_sampling_ext, w, device,
                pool_group=group or None,
                pool_batch=ranks * b if ranks > 1 else None)
        else:
            group = 0
            neg_idx = negative_indices.to(device=device, dtype=torch.int32)
            if neg_idx.shape != (b, self.negative_sampling_ext, w):
                raise ValueError(f"negative_indices must be (B, N, W) = "
                                 f"{(b, self.negative_sampling_ext, w)}, got "
                                 f"{tuple(neg_idx.shape)}")
            rows = z_flat.shape[0]
            if bool((neg_idx < 0).any()) or bool((neg_idx >= rows).any()):
                raise ValueError(f"negative_indices must lie in [0, {rows}),"
                                 f" the pool's rows")
        neg_idx_wn = neg_idx.transpose(1, 2).contiguous()     # (B, W, N)

        pos = self._positive_scores(preds, encoded_data, w)  # (B, K, W)
        neg = negative_scores(preds, z_flat, neg_idx_wn, group=group or None,
                              ranks=ranks) / d               # (B, K, W, N)

        pos_flat_idx = (
            torch.arange(b, device=device)[:, None, None] * s
            + torch.arange(1, k_p + 1, device=device)[None, :, None]
            + torch.arange(w, device=device)[None, None, :]
            + shard_offset)                      # (B, K, W), pool rows
        collides = neg_idx_wn[:, None] == pos_flat_idx[..., None]
        neg = torch.where(collides, pos[..., None], neg)

        lse = torch.logsumexp(torch.cat([pos[..., None], neg], dim=-1), -1)
        losses = lse - pos                                    # (B, K, W)
        # ties go to the positive, as torch's argmax picks the first maximum
        correct = pos >= neg.max(dim=-1).values
        if quality is not None:
            weight = 1e-5 + torch.sigmoid(self.growth_rate * (
                quality.mean(dim=1) - self.inflection_point_x))
            losses = losses * weight[:, None, None]
        if example_weights is not None:
            ew = example_weights.to(losses.dtype)[:, None]
            out_losses = (losses.mean(dim=2) * ew).sum(dim=0)
            out_acc = (correct.float().mean(dim=2) * ew).sum(dim=0)
        else:
            out_losses = losses.mean(dim=(0, 2))
            out_acc = correct.float().mean(dim=(0, 2))
        return (out_losses[self.n_skipped:][None, :],
                out_acc[self.n_skipped:][None, :])

    def _positive_scores(self, preds: Tensor, encoded_data: Tensor,
                         w: int) -> Tensor:
        """pos[b, k, w] = preds[b, k, w] . z[b, w + k + 1] / D, the one
        formula of the loss and of `cosine_distances`."""
        pos_z = torch.stack([encoded_data[:, k:k + w]
                             for k in range(1, self.n_predicts + 1)], dim=1)
        return (preds * pos_z).sum(dim=-1) / encoded_data.shape[-1]

    def cosine_distances(self, c_feature: Tensor,
                         encoded_data: Tensor) -> Tensor:
        """The positives' scores alone, (B, K, W), the heads run without
        dropout whatever the module's mode (counterpart of
        `cpc2_tpu/losses/criterion.py:551-558`, reference
        `criterion.py:304-327`)."""
        c_feature, encoded_data = self._oriented(c_feature, encoded_data)
        w = c_feature.shape[1] - self.n_predicts
        training = self.training
        self.eval()
        try:
            preds = self.wPrediction(c_feature[:, :w])
        finally:
            self.train(training)
        return self._positive_scores(preds, encoded_data, w)

    # reference-spelled alias (`criterion.py:304`)
    getCosineDistances = cosine_distances


# ---------------------------------------------------------------------------
# Supervised criteria (counterparts of `cpc2_tpu/losses/criterion.py:569-736`,
# reference `criterion.py:366-508`)
# ---------------------------------------------------------------------------

class SupervisedCriterion(nn.Module):
    """A criterion called `(c_feature, other_encoded, label)` that returns
    `(loss (1, 1), acc (1, 1))`: the training step hands it the labels
    instead of the InfoNCE draws. The JAX package's flax layers take their
    input width from the tensor they are called on; here each linear layer
    is sized from the tensor it reads, `dim_ar` wide (the context) or
    `dim_enc` wide (the encodings)."""


def _mean(x: Tensor) -> Tensor:
    return x.float().mean().reshape(1, 1)


def _weighted(x: Tensor, example_weights: Tensor) -> Tensor:
    """The sum over the batch of each example's mean of `x` (B, ...) times
    its weight, (1, 1): the weighted step's share of the mean over the
    ranks' real examples (`cpc2_tpu/losses/criterion.py:589-593`)."""
    per = x.float().reshape(x.shape[0], -1).mean(dim=1)
    return (per * example_weights.float()).sum().reshape(1, 1)


class SpeakerCriterion(SupervisedCriterion):
    """Linear speaker classifier on the last context frame: it reads
    `c_feature[:, -1]` whatever `--onEncoder` says."""

    def __init__(self, dim_ar: int, n_speakers: int):
        super().__init__()
        self.linearSpeakerClassifier = nn.Linear(dim_ar, n_speakers)

    def forward(self, c_feature: Tensor, other_encoded: Tensor,
                label: Tensor, example_weights: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
        logits = self.linearSpeakerClassifier(c_feature[:, -1, :])
        hit = logits.argmax(-1) == label
        if example_weights is not None:
            ce = torch.nn.functional.cross_entropy(logits, label,
                                                   reduction='none')
            return _weighted(ce, example_weights), _weighted(hit,
                                                             example_weights)
        loss = torch.nn.functional.cross_entropy(logits, label)
        return loss.reshape(1, 1), _mean(hit)


class AdvSpeakerCriterion(SupervisedCriterion):
    """Adversarial speaker criterion on the mean over frames (of the
    encodings with `on_encoder`); with `label=None` the loss is the
    negative entropy of each prediction, (B,), and the accuracy 0."""

    def __init__(self, dim_ar: int, dim_enc: int, n_speakers: int,
                 on_encoder: bool = False):
        super().__init__()
        self.on_encoder = on_encoder
        self.linearSpeakerClassifier = nn.Linear(
            dim_enc if on_encoder else dim_ar, n_speakers)

    def forward(self, c_feature: Tensor, other_encoded: Tensor,
                label: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
        feats = other_encoded if self.on_encoder else c_feature
        logits = self.linearSpeakerClassifier(feats.mean(dim=1))
        if label is None:
            logp = torch.log_softmax(logits, dim=1)
            p = torch.softmax(logits, dim=1)
            return ((logp * p).sum(dim=1),
                    torch.zeros((1, 1), device=logits.device))
        loss = torch.nn.functional.cross_entropy(logits, label)
        return loss.reshape(1, 1), _mean(logits.argmax(-1) == label)


class PhoneCriterion(SupervisedCriterion):
    """Frame-wise phone classifier on the context, or with `on_encoder` on
    the encodings the step passes (the future view's in training). With
    `n_layers > 1` the reference's `Sequential` of linear layers with a
    ReLU between (keys `PhoneCriterionClassifier.{0,2,4,...}`)."""

    def __init__(self, dim_ar: int, dim_enc: int, n_phones: int,
                 on_encoder: bool = False, n_layers: int = 1):
        super().__init__()
        self.on_encoder = on_encoder
        dim = dim_enc if on_encoder else dim_ar
        if n_layers == 1:
            self.PhoneCriterionClassifier = nn.Linear(dim, n_phones)
        else:
            layers = [nn.Linear(dim, n_phones)]
            for _ in range(n_layers - 1):
                layers += [nn.ReLU(), nn.Linear(n_phones, n_phones)]
            self.PhoneCriterionClassifier = nn.Sequential(*layers)

    def get_prediction(self, c_feature: Tensor) -> Tensor:
        return self.PhoneCriterionClassifier(c_feature)

    # reference-spelled alias
    getPrediction = get_prediction

    def forward(self, c_feature: Tensor, other_encoded: Tensor,
                label: Tensor, example_weights: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
        feats = other_encoded if self.on_encoder else c_feature
        logits = self.get_prediction(feats)
        hit = logits.argmax(-1) == label
        if example_weights is not None:
            ce = torch.nn.functional.cross_entropy(
                logits.reshape(-1, logits.shape[-1]), label.reshape(-1),
                reduction='none').reshape(label.shape)
            return _weighted(ce, example_weights), _weighted(hit,
                                                             example_weights)
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), label.reshape(-1))
        return loss.reshape(1, 1), _mean(hit)


def collapse_label_chain_padded(labels: Tensor) -> Tuple[Tensor, Tensor]:
    """Collapse runs of equal labels, left-compacted and zero-padded to the
    input length, on the labels' device. Returns (collapsed (N, T), sizes
    (N,))."""
    n, t = labels.shape
    status = torch.cat([torch.ones((n, 1), dtype=torch.bool,
                                   device=labels.device),
                        labels[:, 1:] != labels[:, :-1]], dim=1)
    sizes = status.sum(dim=1)
    # stable sort: kept positions first, in their order
    order = torch.argsort((~status).to(torch.int32), dim=1, stable=True)
    collapsed = torch.gather(labels, 1, order)
    mask = torch.arange(t, device=labels.device)[None, :] < sizes[:, None]
    return torch.where(mask, collapsed, torch.zeros_like(collapsed)), sizes


class CTCPhoneCriterion(SupervisedCriterion):
    """A linear (n_phones + 1) head on the context and the CTC loss of the
    collapsed label chain, blank = n_phones. The reference's
    `nn.CTCLoss(zero_infinity=True)` with `reduction='mean'`, as the JAX
    package computes it: a sample with no feasible alignment (more
    collapsed labels than frames) or a non-finite loss counts 0, each loss
    is divided by its target length, then the batch mean. The accuracy is
    0."""

    def __init__(self, dim_ar: int, n_phones: int, on_encoder: bool = False):
        super().__init__()
        if on_encoder:
            raise ValueError("On encoder version not implemented yet")
        self.n_phones = n_phones
        self.PhoneCriterionClassifier = nn.Linear(dim_ar, n_phones + 1)

    def forward(self, c_feature: Tensor, other_encoded: Tensor,
                label: Tensor, example_weights: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
        b, s, _ = c_feature.shape
        logits = self.PhoneCriterionClassifier(c_feature)
        targets, sizes = collapse_label_chain_padded(label)
        log_probs = torch.log_softmax(logits, dim=-1).transpose(0, 1)
        # zero_infinity keeps an infeasible sample's gradient at 0 as well
        loss = torch.nn.functional.ctc_loss(
            log_probs, targets, torch.full((b,), s, dtype=torch.long,
                                           device=logits.device),
            sizes, blank=self.n_phones, reduction='none', zero_infinity=True)
        loss = torch.where((sizes <= s) & torch.isfinite(loss), loss,
                           torch.zeros_like(loss))
        loss = loss / sizes.clamp_min(1).to(loss.dtype)
        zero = torch.zeros((1, 1), device=logits.device)
        if example_weights is not None:
            return _weighted(loss, example_weights), zero
        return loss.mean().reshape(1, 1), zero


class ModelCriterionCombined(nn.Module):
    """A model and a supervised criterion as one module (reference
    `criterion.py:499-508`)."""

    def __init__(self, model: nn.Module, criterion: nn.Module):
        super().__init__()
        self.model = model
        self.criterion = criterion

    def forward(self, data: Tensor, label: Tensor) -> Tuple[Tensor, Tensor]:
        c_feature, encoded_data, _hidden = self.model(data)
        return self.criterion(c_feature, encoded_data, label)
