"""Linear separability probes over frozen (or fine-tuned) CPC features
(counterpart of `cpc2_tpu/eval/linear_separability.py`, reference
`cpc/eval/linear_separability.py`).

A linear head trained on top of a loaded CPC checkpoint: speaker
classification on the last context frame, aligned-phone classification
(`--pathPhone`), or CTC phone recognition (`--pathPhone --CTC`). The flags,
the checkpoint layout (`checkpoint_<n>.pt`, `checkpoint_args.json`,
`checkpoint_logs.json`) and the log keys are the reference's.

Run, on the card unless `--device cpu`:
    python -m cpc2_torch.eval.linear_separability <corpus> <train.txt> \
        <val.txt> <checkpoint.pt> [more checkpoints] --pathCheckpoint <out> \
        [--pathPhone <labels>] [--CTC] [--get_encoded] [--unfrozen]

Frozen (the default), the model runs in `eval()` under `torch.no_grad()`
and the optimizer holds only the head's parameters: the JAX package zeroes
the model's gradients under Adam, which leaves it as it is too. With
`--unfrozen` the model runs in `train()` mode and takes gradients. The
features are computed in full fp32 (`training.full_fp32`), as for ABX.
Several checkpoints make one `ConcatenatedModel`.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import _DDP
from ..data.corpus import filter_seqs, find_all_seqs, parse_seq_labels
from ..data.dataset import AudioBatchData
from ..feature_loader import load_model
from ..io.checkpoint import save_checkpoint, save_logs, to_cpu
from ..losses import CTCPhoneCriterion, PhoneCriterion, SpeakerCriterion
from ..train import show_logs
from ..training import full_fp32, resolve_device

Tensor = torch.Tensor

# The host-clock ms of every train and validation step of the last `run`.
LAST_RUN: Dict = {}

# The reference's flags (`linear_separability.py:123-188`), as the JAX
# package's table, plus `--device`.
_FLAGS = [
    (('pathDB',), dict(type=str, help="Audio corpus root.")),
    (('pathTrain',), dict(type=str, help="Training sequence list.")),
    (('pathVal',), dict(type=str, help="Validation sequence list.")),
    (('load',), dict(type=str, nargs='*', help="CPC checkpoint(s) to "
                     "probe.")),
    (('--pathPhone',), dict(type=str, default=None,
                            help="Aligned phone labels; switches the probe "
                            "from speaker to phone separability.")),
    (('--CTC',), dict(action='store_true',
                      help="CTC loss instead of aligned-phone CE.")),
    (('--pathCheckpoint',), dict(type=str, default='out',
                                 help="Output directory.")),
    (('--nGPU',), dict(type=int, default=-1,
                       help="Device count; the port probes on one.")),
    (('--batchSizeGPU',), dict(type=int, default=8,
                               help="Windows per device.")),
    (('--n_epoch',), dict(type=int, default=10)),
    (('--debug',), dict(action='store_true')),
    (('--unfrozen',), dict(action='store_true',
                           help="Fine-tune the feature network under the "
                           "probe loss instead of freezing it.")),
    (('--no_pretraining',), dict(action='store_true',
                                 help="Probe a randomly initialized "
                                 "model.")),
    (('--file_extension',), dict(type=str, default=".flac")),
    (('--save_step',), dict(type=int, default=-1)),
    (('--get_encoded',), dict(action='store_true',
                              help="Probe the convolutional encoder output "
                              "instead of the context.")),
    (('--lr',), dict(type=float, default=2e-4)),
    (('--beta1',), dict(type=float, default=0.9)),
    (('--beta2',), dict(type=float, default=0.999)),
    (('--epsilon',), dict(type=float, default=2e-8)),
    (('--ignore_cache',), dict(action='store_true')),
    (('--size_window',), dict(type=int, default=20480)),
    (('--device',), dict(type=str, default='cuda',
                         help="cuda (the default; raises without a card) "
                         "or cpu.")),
]


def parse_args(argv) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description='Linear separability trainer'
                    ' (default test in speaker separability)')
    for flags, kw in _FLAGS:
        parser.add_argument(*flags, **kw)
    args = parser.parse_args(argv)
    if args.nGPU < 0:
        args.nGPU = 1
    if args.nGPU > 1:
        raise NotImplementedError(f"--nGPU {args.nGPU}: not ported to "
                                  f"cpc2_torch (ROADMAP.md item: {_DDP})")
    if args.save_step <= 0:
        args.save_step = args.n_epoch
    args.load = [str(Path(x).resolve()) for x in args.load]
    args.pathCheckpoint = str(Path(args.pathCheckpoint).resolve())
    return args


def select_probe(args, dim_ar: int, dim_enc: int, n_speakers: int,
                 n_phones: int) -> nn.Module:
    """The probe's head from the flags, sized from the features it reads
    (`dim_ar` the context's width, `dim_enc` the encoder's)."""
    if args.pathPhone is None:
        print("Running speaker separability")
        return SpeakerCriterion(dim_ar, n_speakers)
    if args.CTC:
        print("Running phone separability with CTC loss")
        return CTCPhoneCriterion(dim_ar, n_phones,
                                 on_encoder=args.get_encoded)
    print("Running phone separability with aligned phones")
    return PhoneCriterion(dim_ar, dim_enc, n_phones,
                          on_encoder=args.get_encoded)


class ProbeSteps:
    """The probe's train and validation steps on the model's device. The
    model reads the past view of each (B, 2, 1, W) host batch."""

    def __init__(self, model: nn.Module, criterion: nn.Module,
                 optimizer: torch.optim.Optimizer, unfrozen: bool,
                 generator: Optional[torch.Generator] = None):
        self.model = model
        self.criterion = criterion
        self.optimizer = optimizer
        self.unfrozen = unfrozen
        self.generator = generator
        self.device = next(criterion.parameters()).device

    def _stage(self, raw_batch, raw_label) -> Tuple[Tensor, Tensor]:
        audio = np.ascontiguousarray(np.asarray(raw_batch)[:, 0, 0, :],
                                     dtype=np.float32)
        return (torch.from_numpy(audio).to(self.device),
                torch.as_tensor(np.asarray(raw_label)).to(self.device))

    def _features(self, audio: Tensor, train: bool) -> Tuple[Tensor, Tensor]:
        """The context and the encodings: with gradients in `train()` mode
        for an unfrozen training step, else in `eval()` without."""
        grad = train and self.unfrozen
        self.model.train(grad)
        with torch.set_grad_enabled(grad):
            c_feature, encoded, _hidden = self.model(audio, None,
                                                     self.generator)
        return c_feature, encoded

    def train_batch(self, raw_batch, raw_label) -> Tuple[Tensor, Tensor]:
        """One Adam step of the head (and of the model, unfrozen); returns
        (loss, acc), each (1, 1), detached."""
        audio, label = self._stage(raw_batch, raw_label)
        self.criterion.train()
        self.optimizer.zero_grad(set_to_none=True)
        c_feature, encoded = self._features(audio, True)
        loss, acc = self.criterion(c_feature, encoded, label)
        loss.sum().backward()
        self.optimizer.step()
        return loss.detach(), acc.detach()

    @torch.no_grad()
    def val_batch(self, raw_batch, raw_label) -> Tuple[Tensor, Tensor]:
        audio, label = self._stage(raw_batch, raw_label)
        self.criterion.eval()
        c_feature, encoded = self._features(audio, False)
        return self.criterion(c_feature, encoded, label)


def _sweep(steps: ProbeSteps, loader, training: bool, tag: str
           ) -> Tuple[Dict, list]:
    """One pass over a loader: (the epoch's logs, each step's host-clock
    ms, from the batch's copy to its loss on the host). The logs divide by
    the true batch count: the reference divides by the last enumerate
    index (`linear_separability.py:45,69`), which inflates its numbers by
    n / (n - 1) and leaves the best epoch as it is."""
    loss_total, acc_total, batches, step_ms = 0.0, 0.0, 0, []
    for batch_data in loader:
        raw, label = batch_data[0], batch_data[1]
        start = time.perf_counter()
        loss, acc = (steps.train_batch(raw, label) if training
                     else steps.val_batch(raw, label))
        loss_total += float(loss.mean())
        acc_total += float(acc.mean())
        step_ms.append(1000.0 * (time.perf_counter() - start))
        batches += 1
    n = max(batches, 1)
    logs = {f"locLoss_{tag}": np.asarray([loss_total / n]),
            f"locAcc_{tag}": np.asarray([acc_total / n])}
    if training:
        logs["iter"] = batches
    return logs, step_ms


def run(steps: ProbeSteps, train_loader, val_loader, logs: Dict,
        n_epochs: int, path_prefix: str) -> float:
    """Train the probe for the epochs `logs` has not seen yet, validating
    after each; write `<path_prefix>_<epoch>.pt` (the model, the head, the
    best epoch's model) and `<path_prefix>_logs.json` every `saveStep`
    epochs and at the last. Returns the best validation accuracy."""
    best_acc, best_state = -1.0, None
    LAST_RUN.clear()
    LAST_RUN.update(train_step_ms=[], val_step_ms=[])
    t0 = time.time()
    for epoch in range(len(logs["epoch"]), n_epochs):
        train_logs, train_ms = _sweep(steps, train_loader, True, "train")
        val_logs, val_ms = _sweep(steps, val_loader, False, "val")
        LAST_RUN["train_step_ms"] += train_ms
        LAST_RUN["val_step_ms"] += val_ms

        print('')
        print('_' * 50)
        print(f'Ran {epoch + 1} epochs in {time.time() - t0:.2f} seconds')
        show_logs("Training loss", train_logs)
        show_logs("Validation loss", val_logs)
        print('_' * 50)
        print('')

        accuracy = float(val_logs["locAcc_val"][0])
        if accuracy > best_acc:
            best_acc = accuracy
            best_state = to_cpu(steps.model.state_dict())

        logs["epoch"].append(epoch)
        for key, value in dict(train_logs, **val_logs).items():
            logs.setdefault(key, [None] * epoch).append(
                value.tolist() if isinstance(value, np.ndarray) else value)

        if (epoch % logs["saveStep"] == 0 and epoch > 0) \
                or epoch == n_epochs - 1:
            save_checkpoint(steps.model.state_dict(),
                            steps.criterion.state_dict(), {}, best_state,
                            f"{path_prefix}_{epoch}.pt")
            save_logs(logs, f"{path_prefix}_logs.json")
    LAST_RUN["best_acc"] = best_acc
    if LAST_RUN["train_step_ms"]:
        LAST_RUN["median_train_step_ms"] = statistics.median(
            LAST_RUN["train_step_ms"])
    return best_acc


def main(argv) -> float:
    args = parse_args(argv)
    device = resolve_device(args.device)
    logs = {"epoch": [], "iter": [], "saveStep": args.save_step}

    seq_names, speakers = find_all_seqs(args.pathDB,
                                        extension=args.file_extension,
                                        loadCache=not args.ignore_cache)
    model, hidden_gar, hidden_encoder = load_model(
        args.load, loadStateDict=not args.no_pretraining)
    model = model.to(device)

    phone_labels, n_phones = None, 0
    if args.pathPhone is not None:
        phone_labels, n_phones = parse_seq_labels(args.pathPhone)
    criterion = select_probe(args, hidden_gar, hidden_encoder,
                             len(speakers), n_phones).to(device)

    seq_train = filter_seqs(args.pathTrain, seq_names)
    seq_val = filter_seqs(args.pathVal, seq_names)
    if args.debug:
        seq_train, seq_val = seq_train[:1000], seq_val[:100]

    db_train = AudioBatchData(args.pathDB, args.size_window, seq_train,
                              phone_labels, len(speakers))
    db_val = AudioBatchData(args.pathDB, args.size_window, seq_val,
                            phone_labels, len(speakers))
    try:
        batch_size = args.batchSizeGPU * args.nGPU
        train_loader = db_train.getDataLoader(batch_size, "uniform", True)
        val_loader = db_val.getDataLoader(batch_size, 'sequential', False)

        params = list(criterion.parameters())
        if args.unfrozen:
            print("Working in full fine-tune mode")
            params = list(model.parameters()) + params
        else:
            print("Working with frozen features")
        optimizer = torch.optim.Adam(params, lr=args.lr,
                                     betas=(args.beta1, args.beta2),
                                     eps=args.epsilon)
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
        steps = ProbeSteps(model, criterion, optimizer, args.unfrozen,
                           generator)

        out_dir = Path(args.pathCheckpoint)
        out_dir.mkdir(exist_ok=True)
        path_prefix = str(out_dir / "checkpoint")
        with open(f"{path_prefix}_args.json", 'w') as f:
            json.dump(vars(args), f, indent=2)

        with full_fp32():
            best_acc = run(steps, train_loader, val_loader, logs,
                           args.n_epoch, path_prefix)
    finally:
        db_train.close()
        db_val.close()
    print(f"Best validation accuracy: {best_acc}")
    return best_acc


if __name__ == "__main__":
    main(sys.argv[1:])
