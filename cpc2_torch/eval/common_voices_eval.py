"""Whole-utterance CTC phone recognition and the phone error rate
(counterpart of `cpc2_tpu/eval/common_voices_eval.py`, reference
`cpc/eval/common_voices_eval.py`).

`train` fits a CTC phone classifier (optional LSTM, a strided Conv1d) on
frozen (`--freeze`) or fine-tuned CPC features of whole utterances, each
padded to the dataset's longest; `per` decodes a validation set with a
beam search on the host and prints the mean PER. Every LSTM on this path,
the CPC model's and the head's, is `ops/lstm.py:fused_lstm` (the
`csrc/lstm.cu` kernels on the card); the CTC loss is torch's `ctc_loss`.
Everything runs in full fp32 (`training.full_fp32`). The flags and the
files (`checkpoint.pt` of `{'classifier', 'model', 'bestLoss'}`,
`args_training.json`, `args_validation_<name>.json`) are the JAX
package's, plus `--device`; `per` loads a `checkpoint.pt` of either
package.

Run, on the card unless `--device cpu`:
    python -m cpc2_torch.eval.common_voices_eval train <pathDB> \
        <pathPhone> <cpc_checkpoint.pt | ID> -o <out> [--freeze] [--LSTM]
    python -m cpc2_torch.eval.common_voices_eval per <out>
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random
import sys
import time
from copy import deepcopy
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.audio_io import load_audio
from ..data.corpus import filter_seqs, find_all_seqs, parse_seq_labels
from ..feature_loader import load_model, load_state
from ..io.checkpoint import to_cpu
from ..losses.seq_alignment import beam_search, get_seq_PER
from ..models.ar import StackedRNN
from ..ops import _build
from ..training import full_fp32, resolve_device

Tensor = torch.Tensor

# What the last `run_training` and `per_step` saw: each epoch's seconds
# and losses, each step's kernel launches (`_build.LAUNCHES` counts that
# moved), each utterance's PER and the posteriors the beam search read.
LAST_RUN: Dict = {}


def load(path_item):
    path_item = Path(path_item)
    seq_name, seq_ext = path_item.stem, path_item.suffix
    if seq_ext == '.npy':
        data = np.load(str(path_item)).astype(np.float32)
        data = data.reshape(data.shape[0], data.shape[1]).T
    else:
        wav, _sr = load_audio(str(path_item))
        data = np.asarray(wav, np.float32).reshape(1, -1)
    return seq_name, data


class SingleSequenceDataset:
    """Whole utterances padded to the dataset's longest (`maxSize`
    samples, `maxSizePhone` labels) (reference `common_voices_eval.py:
    39-144`). `.npy` files are pre-computed features of `inDim` rows. The
    random offset and the shuffle draw from Python's `random`, in the JAX
    package's order."""

    def __init__(self, pathDB, seqNames, phoneLabelsDict, inDim=1,
                 transpose=True, random_offset_amplitude=80, transform=None):
        self.seqNames = deepcopy(seqNames)
        self.pathDB = pathDB
        self.phoneLabelsDict = deepcopy(phoneLabelsDict)
        self.inDim = inDim
        self.transpose = transpose
        self.random_offset_amplitude = random_offset_amplitude
        self.transform = transform
        self.loadSeqs()

    def loadSeqs(self):
        self.seqOffset = [0]
        self.phoneLabels = []
        self.phoneOffsets = [0]
        self.maxSize = 0
        self.maxSizePhone = 0
        start_time = time.time()
        to_load = [Path(self.pathDB) / x for _, x in self.seqNames]
        pool_data = sorted((load(p) for p in to_load), key=lambda x: x[0])
        tmp_data = []
        tot_size = 0
        min_size_phone = float('inf')
        for seq_name, seq in pool_data:
            self.phoneLabels += self.phoneLabelsDict[seq_name]
            self.phoneOffsets.append(len(self.phoneLabels))
            self.maxSizePhone = max(self.maxSizePhone,
                                    len(self.phoneLabelsDict[seq_name]))
            min_size_phone = min(min_size_phone,
                                 len(self.phoneLabelsDict[seq_name]))
            size_seq = seq.shape[1]
            self.maxSize = max(self.maxSize, size_seq)
            tot_size += size_seq
            tmp_data.append(seq)
            self.seqOffset.append(self.seqOffset[-1] + size_seq)
        self.data = np.concatenate(tmp_data, axis=1)
        self.phoneLabels = np.asarray(self.phoneLabels, np.int64)
        print(f'Loaded {len(self.phoneOffsets)} sequences '
              f'in {time.time() - start_time:.2f} seconds')
        print(f'maxSizeSeq : {self.maxSize}')
        print(f'maxSizePhone : {self.maxSizePhone}')
        print(f"minSizePhone : {min_size_phone}")
        print(f'Total size dataset {tot_size / (16000 * 3600)} hours')

    def __getitem__(self, idx):
        offset_start = self.seqOffset[idx]
        offset_end = self.seqOffset[idx + 1]
        phone_start = self.phoneOffsets[idx]
        phone_end = self.phoneOffsets[idx + 1]
        size_seq = int(offset_end - offset_start)
        size_phone = int(phone_end - phone_start)

        out_seq = np.zeros((self.inDim, self.maxSize), np.float32)
        out_phone = np.zeros(self.maxSizePhone, np.int64)
        offset = 0
        if self.random_offset_amplitude > 0:
            offset = random.randint(0, self.random_offset_amplitude)
            size_seq -= offset
        out_seq[:, :size_seq] = self.data[:, offset_start + offset:offset_end]
        out_phone[:size_phone] = self.phoneLabels[phone_start:phone_end]
        if self.transform is not None:
            out_seq = self.transform(out_seq)
        return out_seq, size_seq, out_phone, size_phone

    def __len__(self):
        return len(self.seqOffset) - 1

    def batches(self, batch_size, shuffle=True):
        """(seq (B, inDim, maxSize), size_seq, phone (B, maxSizePhone),
        size_phone) numpy batches; the ragged tail batch runs too (the
        reference's DataLoader with drop_last=False)."""
        order = list(range(len(self)))
        if shuffle:
            random.shuffle(order)
        for i in range(0, len(order), batch_size):
            items = [self[j] for j in order[i:i + batch_size]]
            seq = np.stack([x[0] for x in items])
            size_seq = np.asarray([x[1] for x in items], np.int32)
            phone = np.stack([x[2] for x in items])
            size_phone = np.asarray([x[3] for x in items], np.int32)
            yield seq, size_seq, phone, size_phone

    def n_batches(self, batch_size):
        return -(-len(self) // batch_size)


class CTCPhoneCriterionCV(nn.Module):
    """The CTC classifier head (reference `common_voices_eval.py:147-213`):
    optional masked per-utterance `seqNorm`, an optional LSTM (`conv1`,
    `StackedRNN` in LSTM mode), `Dropout(0.5)` (`drop`), then a Conv1d to
    `n_phones + 1` channels, kernel `size_kernel`, stride
    `size_kernel // 2`, no padding (`PhoneCriterionClassifier`); CTC with
    blank = `n_phones` on the label chain as given (not collapsed)."""

    def __init__(self, dim_encoder: int, n_phones: int,
                 use_lstm: bool = False, size_kernel: int = 8,
                 seq_norm: bool = False, dropout: bool = False,
                 reduction: str = 'sum'):
        super().__init__()
        if reduction not in ('mean', 'sum'):
            raise ValueError(f"reduction {reduction!r}: mean or sum")
        self.n_phones = n_phones
        self.seq_norm = seq_norm
        self.reduction = reduction
        self.conv1 = (StackedRNN(dim_encoder, dim_encoder, 1, 'LSTM')
                      if use_lstm else None)
        self.drop = nn.Dropout(0.5) if dropout else None
        self.PhoneCriterionClassifier = nn.Conv1d(
            dim_encoder, n_phones + 1, size_kernel, stride=size_kernel // 2)

    @property
    def blank_label(self) -> int:
        return self.n_phones

    def get_prediction(self, c_feature: Tensor, feature_size: Tensor
                       ) -> Tensor:
        """c_feature (B, S, C), feature_size (B,) valid frames -> logits
        (B, S', n_phones + 1)."""
        if self.seq_norm:
            s = c_feature.shape[1]
            mask = (torch.arange(s, device=c_feature.device)[None, :]
                    < feature_size[:, None])[..., None]
            n = feature_size.clamp_min(1)[:, None, None].to(c_feature.dtype)
            zero = c_feature.new_zeros(())
            m = torch.where(mask, c_feature, zero).sum(1, keepdim=True) / n
            # the unbiased variance over the valid frames (torch's .var)
            v = torch.where(mask, (c_feature - m) ** 2, zero).sum(
                1, keepdim=True) / (n - 1).clamp_min(1)
            c_feature = (c_feature - m) / torch.sqrt(v + 1e-8)
        if self.conv1 is not None:
            c_feature, _ = self.conv1(c_feature)
        if self.drop is not None:
            c_feature = self.drop(c_feature)
        return self.PhoneCriterionClassifier(
            c_feature.transpose(1, 2)).transpose(1, 2)

    def forward(self, c_feature: Tensor, feature_size: Tensor, label: Tensor,
                label_size: Tensor) -> Tensor:
        """The CTC loss, (1, 1): a sample whose labels and their adjacent
        repeats outnumber its frames (`feature_size // 4`, clipped to the
        logits'), or whose loss is not finite, counts 0; `mean` divides
        each loss by its label count before the batch mean, `sum` sums."""
        logits = self.get_prediction(c_feature, feature_size)
        frames = (feature_size // 4).clamp(0, logits.shape[1]).long()
        label, label_size = label.long(), label_size.long()
        log_probs = torch.log_softmax(logits, dim=-1).transpose(0, 1)
        loss = F.ctc_loss(log_probs, label, frames, label_size,
                          blank=self.blank_label, reduction='none',
                          zero_infinity=True)
        valid = (torch.arange(label.shape[1], device=label.device)[None, :]
                 < label_size[:, None])
        repeats = ((label[:, 1:] == label[:, :-1]) & valid[:, 1:]).sum(1)
        feasible = frames >= label_size + repeats
        loss = torch.where(feasible & torch.isfinite(loss), loss,
                           torch.zeros_like(loss))
        if self.reduction == 'mean':
            loss = loss / label_size.clamp_min(1).to(loss.dtype)
            return loss.mean().reshape(1, 1)
        return loss.sum().reshape(1, 1)


class IDModule(nn.Module):
    """Pre-computed features passed through, (B, C, S) -> (B, S, C)
    (reference `common_voices_eval.py:215-222`)."""

    def forward(self, feature: Tensor, hidden=None, generator=None):
        return feature.transpose(1, 2), None, None


class CVSteps:
    """The CTC head's train, validation and prediction steps on the
    criterion's device, each in full fp32. The model reads `seq[:, 0]` of
    a (B, 1, S) audio batch, or the whole (B, C, S) batch of features.

    Frozen, the model runs in `eval()` under `no_grad` and its parameters'
    gradients stay zero, so AdamW's weight decay alone moves them, as
    optax's `adamw` does over the JAX package's whole parameter tree.
    Unfrozen, the model runs in `train()` mode and takes gradients. The
    criterion is in `train()` mode on every training step."""

    def __init__(self, model: nn.Module, criterion: nn.Module,
                 optimizer: Optional[torch.optim.Optimizer], freeze: bool):
        self.model = model
        self.criterion = criterion
        self.optimizer = optimizer
        self.freeze = freeze
        self.device = next(criterion.parameters()).device
        if freeze and optimizer is not None:
            for p in model.parameters():
                p.grad = torch.zeros_like(p)

    def _stage(self, *arrays) -> Tuple[Tensor, ...]:
        seq = np.asarray(arrays[0], np.float32)
        seq = seq[:, 0, :] if seq.shape[1] == 1 else seq
        return (torch.from_numpy(np.ascontiguousarray(seq)).to(self.device),
                *(torch.as_tensor(np.asarray(a), dtype=torch.long).to(
                    self.device) for a in arrays[1:]))

    def _features(self, seq: Tensor, train: bool) -> Tensor:
        grad = train and not self.freeze
        self.model.train(grad)
        with torch.set_grad_enabled(grad):
            c_feature, _encoded, _hidden = self.model(seq)
        return c_feature

    def train_batch(self, seq, size_seq, phone, size_phone) -> Tensor:
        """One AdamW step; returns the loss (a 0-d tensor), detached."""
        seq, size_seq, phone, size_phone = self._stage(seq, size_seq, phone,
                                                       size_phone)
        with full_fp32():
            self.criterion.train()
            self.optimizer.zero_grad(set_to_none=False)
            c_feature = self._features(seq, True)
            loss = self.criterion(c_feature, size_seq, phone,
                                  size_phone).mean()
            loss.backward()
            self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def val_batch(self, seq, size_seq, phone, size_phone) -> Tensor:
        seq, size_seq, phone, size_phone = self._stage(seq, size_seq, phone,
                                                       size_phone)
        with full_fp32():
            self.criterion.eval()
            return self.criterion(self._features(seq, False), size_seq,
                                  phone, size_phone).mean()

    @torch.no_grad()
    def predict_batch(self, seq, size_seq) -> np.ndarray:
        """The softmax over the head's logits, (B, S', n_phones + 1), on
        the host."""
        seq, size_seq = self._stage(seq, size_seq)
        with full_fp32():
            self.criterion.eval()
            logits = self.criterion.get_prediction(
                self._features(seq, False), size_seq)
            return torch.softmax(logits, dim=2).cpu().numpy()


def build_cv_steps(model, criterion, optimizer, freeze: bool):
    """`CVSteps`' three callables: train, validation, prediction."""
    steps = CVSteps(model, criterion, optimizer, freeze)
    return steps.train_batch, steps.val_batch, steps.predict_batch


def make_optimizer(model: nn.Module, criterion: nn.Module,
                   args: argparse.Namespace) -> torch.optim.AdamW:
    """AdamW at optax's `adamw` defaults (weight decay 1e-4) over the head
    and the model; unfrozen, the model at `lr / 10` (the JAX package's
    `multi_transform`). Torch's fused AdamW on the card."""
    groups = [{'params': list(criterion.parameters())}]
    model_params = list(model.parameters())
    if model_params:
        groups.append({'params': model_params,
                       'lr': args.lr if args.freeze else args.lr / 10})
    fused = next(criterion.parameters()).device.type == 'cuda'
    return torch.optim.AdamW(groups, lr=args.lr,
                             betas=(args.beta1, args.beta2),
                             eps=args.epsilon, weight_decay=1e-4,
                             fused=fused or None)


def get_per(data):
    """(reference `common_voices_eval.py:294-301`)."""
    pred, size_pred, gt, size_gt, blank_label = data
    l_ = min(int(size_pred) // 4, pred.shape[0])
    p_ = pred[:l_].reshape(l_, -1)
    gt_seq = gt[:int(size_gt)].reshape(-1).tolist()
    pred_seq = beam_search(p_, 20, blank_label)[0][1]
    return get_seq_PER(gt_seq, pred_seq)


def per_step(dataset, predict_batch, blank_label, batch_size,
             downsampling_factor):
    """The mean PER of `dataset`'s utterances, each decoded by a beam
    search of 20 on the host. Each utterance's PER and the posteriors the
    search read go to `LAST_RUN` (`pers`, `posteriors`)."""
    avg_per, var_per, n_items = 0.0, 0.0, 0
    pers, posteriors = [], []
    print("Starting the PER computation through beam search")
    for seq, size_seq, phone, size_phone in dataset.batches(batch_size,
                                                            shuffle=False):
        predictions = predict_batch(seq, size_seq // downsampling_factor)
        for b in range(seq.shape[0]):
            size_pred = size_seq[b] // downsampling_factor
            score = get_per((predictions[b], size_pred, phone[b],
                             size_phone[b], blank_label))
            posteriors.append(predictions[b][:min(
                int(size_pred) // 4, predictions.shape[1])])
            pers.append(score)
            avg_per += score
            var_per += score * score
            n_items += 1
    avg_per /= n_items
    var_per = var_per / n_items - avg_per ** 2
    print(f"Average PER {avg_per}")
    print(f"Standard deviation PER {math.sqrt(max(var_per, 0))}")
    LAST_RUN.update(pers=pers, posteriors=posteriors)
    return avg_per


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before[k] for k, n in _build.LAUNCHES.items()
            if n != before[k]}


def _sweep(dataset, step, batch_size, shuffle) -> Tuple[float, list]:
    """One pass of `step` over `dataset`: (the mean loss, each step's
    launches). `size_seq // 160` is the feature frames in every mode, `ID`
    included, as in the JAX package."""
    tot, n, launches = 0.0, 0, []
    for seq, size_seq, phone, size_phone in dataset.batches(batch_size,
                                                            shuffle):
        before = dict(_build.LAUNCHES)
        tot += float(step(seq, size_seq // 160, phone, size_phone))
        launches.append(_launches_since(before))
        n += 1
    return tot / max(n, 1), launches


def run_training(dataset_train, dataset_val, steps: CVSteps, batch_size,
                 n_epochs, path_checkpoint) -> float:
    """Train for `n_epochs`, validating after each; the epoch of the best
    validation loss writes `path_checkpoint` (`{'classifier', 'model',
    'bestLoss'}`, on the CPU). Returns the best validation loss."""
    print(f"Starting the training for {n_epochs} epochs")
    best_loss = float('inf')
    LAST_RUN.clear()
    LAST_RUN.update(epoch_s=[], loss_train=[], loss_val=[],
                    train_launches=[], val_launches=[])
    for epoch in range(n_epochs):
        start = time.perf_counter()
        loss_train, train_launches = _sweep(dataset_train, steps.train_batch,
                                            batch_size, True)
        print(f"Epoch {epoch} loss train : {loss_train}")
        loss_val, val_launches = _sweep(dataset_val, steps.val_batch,
                                        batch_size, False)
        print(f"Epoch {epoch} loss val : {loss_val}")
        LAST_RUN["epoch_s"].append(time.perf_counter() - start)
        LAST_RUN["loss_train"].append(loss_train)
        LAST_RUN["loss_val"].append(loss_val)
        LAST_RUN["train_launches"].append(train_launches)
        LAST_RUN["val_launches"].append(val_launches)
        if loss_val < best_loss:
            best_loss = loss_val
            torch.save(to_cpu({'classifier': steps.criterion.state_dict(),
                               'model': steps.model.state_dict(),
                               'bestLoss': best_loss}), path_checkpoint)
    return best_loss


def get_PER_args(args):
    path_args_training = os.path.join(args.output, "args_training.json")
    with open(path_args_training, 'rb') as f:
        data = json.load(f)
    if args.pathDB is None:
        args.pathDB = data["pathDB"]
        args.file_extension = data["file_extension"]
    if args.pathVal is None and args.pathPhone is None:
        args.pathPhone = data["pathPhone"]
        args.pathVal = data["pathVal"]
    args.pathCheckpoint = data["pathCheckpoint"]
    args.no_pretraining = data["no_pretraining"]
    args.LSTM = data.get("LSTM", False)
    args.seqNorm = data.get("seqNorm", False)
    args.dropout = data.get("dropout", False)
    args.in_dim = data.get("in_dim", 1)
    args.loss_reduction = data.get("loss_reduction", "mean")
    return args


def _add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument('--device', type=str, default='cuda',
                        choices=['cuda', 'cpu'],
                        help="cuda (the default; raises without a card) "
                        "or cpu.")


def parse_args(argv):
    parser = argparse.ArgumentParser(
        description='Simple phone recognition pipeline for the common '
                    'voices datasets')
    subparsers = parser.add_subparsers(dest='command')

    parser_train = subparsers.add_parser('train')
    parser_train.add_argument('pathDB', type=str)
    parser_train.add_argument('pathPhone', type=str)
    parser_train.add_argument('pathCheckpoint', type=str,
                              help='Path to the CPC checkpoint to load. Set '
                              'to ID to work with pre-computed features.')
    parser_train.add_argument('--freeze', action='store_true')
    parser_train.add_argument('--pathTrain', default=None, type=str)
    parser_train.add_argument('--pathVal', default=None, type=str)
    parser_train.add_argument('--file_extension', type=str, default=".mp3")
    parser_train.add_argument('--batchSize', type=int, default=8)
    parser_train.add_argument('--nEpochs', type=int, default=30)
    parser_train.add_argument('--beta1', type=float, default=0.9)
    parser_train.add_argument('--beta2', type=float, default=0.999)
    parser_train.add_argument('--epsilon', type=float, default=1e-08)
    parser_train.add_argument('--lr', type=float, default=2e-04)
    parser_train.add_argument('-o', '--output', type=str, default='out')
    parser_train.add_argument('--debug', action='store_true')
    parser_train.add_argument('--no_pretraining', action='store_true')
    parser_train.add_argument('--LSTM', action='store_true')
    parser_train.add_argument('--seqNorm', action='store_true')
    parser_train.add_argument('--kernelSize', type=int, default=8)
    parser_train.add_argument('--dropout', action='store_true')
    parser_train.add_argument('--in_dim', type=int, default=1)
    parser_train.add_argument('--loss_reduction', type=str, default='mean',
                              choices=['mean', 'sum'])
    parser_train.add_argument('--roffset', type=int, default=0)
    parser_train.add_argument('-a', '--augments', type=json.loads, nargs='*',
                              default=None)
    parser_train.add_argument('--t_ms', type=int, default=100)
    _add_device(parser_train)

    parser_per = subparsers.add_parser('per')
    parser_per.add_argument('output', type=str)
    parser_per.add_argument('--batchSize', type=int, default=8)
    parser_per.add_argument('--debug', action='store_true')
    parser_per.add_argument('--pathDB', type=str, default=None)
    parser_per.add_argument('--pathVal', type=str, default=None)
    parser_per.add_argument('--pathPhone', default=None, type=str)
    parser_per.add_argument('--file_extension', type=str, default=".mp3")
    parser_per.add_argument('--name', type=str, default="0")
    _add_device(parser_per)
    return parser.parse_args(argv)


def _augments(cfgs):
    """The `-a` chain: each JSON object an `AugmentCfg`, drawing from
    numpy's global state and Python's `random`, as the JAX package's
    augmenters do."""
    from ..data.augmentation import AugmentCfg, CombinedTransforms
    return CombinedTransforms([AugmentCfg(**cfg) for cfg in cfgs],
                              rng=np.random.mtrand._rand, choice_rng=random)


def main(argv) -> float:
    """`train`: returns the best validation loss; `per`: the mean PER."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    random.seed()
    if args.command == 'per':
        args = get_PER_args(args)

    if not os.path.isdir(args.output):
        os.mkdir(args.output)

    phoneLabels, nPhones = parse_seq_labels(args.pathPhone)
    inSeqs, _ = find_all_seqs(args.pathDB, extension=args.file_extension,
                              loadCache=False)

    if args.command == 'train' and args.pathTrain is not None:
        seqTrain = filter_seqs(args.pathTrain, inSeqs)
    else:
        seqTrain = inSeqs

    if args.pathVal is None and args.command == 'train':
        random.shuffle(seqTrain)
        sizeTrain = int(0.9 * len(seqTrain))
        seqTrain, seqVal = seqTrain[:sizeTrain], seqTrain[sizeTrain:]
    elif args.pathVal is not None:
        seqVal = filter_seqs(args.pathVal, inSeqs)
    else:
        seqVal = inSeqs

    if args.debug:
        seqVal = seqVal[:100]

    downsampling_factor = 160
    if args.pathCheckpoint == 'ID':
        downsampling_factor = 1
        model = IDModule()
        hiddenGar = args.in_dim
    else:
        model, hiddenGar, _ = load_model(
            [args.pathCheckpoint], loadStateDict=not args.no_pretraining)
    model = model.to(device)

    # the head's initial weights from a fixed seed, as the JAX package's
    # from PRNGKey(0)
    torch.manual_seed(0)
    criterion = CTCPhoneCriterionCV(
        hiddenGar, nPhones, use_lstm=args.LSTM,
        size_kernel=getattr(args, 'kernelSize', 8), seq_norm=args.seqNorm,
        dropout=args.dropout, reduction=args.loss_reduction).to(device)

    print(f"Loading the validation dataset at {args.pathDB}")
    datasetVal = SingleSequenceDataset(args.pathDB, seqVal, phoneLabels,
                                       inDim=args.in_dim,
                                       random_offset_amplitude=0)

    pathCheckpoint = os.path.join(args.output, 'checkpoint.pt')

    if args.command == 'train':
        if args.debug:
            random.shuffle(seqTrain)
            seqTrain = seqTrain[:1000]
            seqVal = seqVal[:100]
        print(f"Loading the training dataset at {args.pathDB}")
        transform = (None if args.augments is None
                     else _augments(args.augments))
        datasetTrain = SingleSequenceDataset(
            args.pathDB, seqTrain, phoneLabels, inDim=args.in_dim,
            random_offset_amplitude=args.roffset, transform=transform)
        steps = CVSteps(model, criterion,
                        make_optimizer(model, criterion, args), args.freeze)

        with open(os.path.join(args.output, "args_training.json"), 'w') as f:
            json.dump(vars(args), f, indent=2)

        return run_training(datasetTrain, datasetVal, steps, args.batchSize,
                            args.nEpochs, pathCheckpoint)

    print(f"Loading data at {pathCheckpoint}")
    state_dict = torch.load(pathCheckpoint, map_location='cpu',
                            weights_only=False)
    if 'bestLoss' in state_dict:
        print(f"Best loss : {state_dict['bestLoss']}")
    load_state(criterion, state_dict['classifier'], 'classifier')
    load_state(model, state_dict['model'], 'model')
    steps = CVSteps(model, criterion, None, True)

    with open(os.path.join(args.output,
                           f"args_validation_{args.name}.json"), 'w') as f:
        json.dump(vars(args), f, indent=2)

    start = time.perf_counter()
    LAST_RUN.clear()
    before = dict(_build.LAUNCHES)
    avg_per = per_step(datasetVal, steps.predict_batch,
                       criterion.blank_label, args.batchSize,
                       downsampling_factor)
    LAST_RUN.update(per_s=time.perf_counter() - start,
                    launches=_launches_since(before))
    return avg_per


if __name__ == "__main__":
    main(sys.argv[1:])
