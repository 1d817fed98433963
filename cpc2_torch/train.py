"""CPC pretraining on one device (counterpart of `cpc2_tpu/train.py`,
reference `cpc/train.py`).

Run: `python -m cpc2_torch.train --pathDB <corpus> --file_extension .wav`.
It parses the JAX trainer's flags, finds the sequences and splits them
95/5 into train and validation as `cpc2_tpu/train.py:459-495` does, builds
the model, criterion and optimizer on the device, and runs `--nEpoch`
epochs of training steps, each followed by a validation pass. It prints
the reference's per-step loss and accuracy tables and the step times.

With `--pathCheckpoint <dir>` it writes `checkpoint_args.json` at the
start and `checkpoint_<epoch>.pt` (the reference's `{gEncoder,
cpcCriterion, optimizer, best}`) with `checkpoint_logs.json` every
`--save_step` epochs and at the last one. A run whose directory holds a
checkpoint resumes from the newest one (model, criterion, optimizer, the
next epoch) unless `--restart`. `--load <checkpoint>` starts from a
checkpoint's model, and its criterion with `--loadCriterion`.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import check_ported, parse_args
from .data import AudioBatchData, filter_seqs, find_all_seqs
from .feature_loader import build_model, load_model, load_state
from .io.checkpoint import (get_checkpoint_data, load_args,
                            load_torch_checkpoint, save_args,
                            save_checkpoint, save_logs)
from .losses import CPCUnsupervisedCriterion
from .models.encoder import DOWNSAMPLING
from .training import (Trainer, make_lr_schedule, make_optimizer,
                       resolve_device, set_precision)

SAMPLE_RATE = 16000


def show_logs(text: str, logs: Dict[str, np.ndarray]) -> None:
    """The reference's per-prediction-step table (`utils/misc.py:44-60`):
    a 'Step 1..K' header and one 16-wide value row per metric."""
    def row(cells):
        return ' '.join('{:>16}' for _ in cells).format(*cells)

    lines = ["", '-' * 50, text]
    for key, values in logs.items():
        lines.append(row(['Step'] + [str(k) for k in
                                     range(1, values.shape[0] + 1)]))
        lines.append(row([key] + ['{:10.6f}'.format(v) for v in values]))
    lines.append('-' * 50)
    print('\n'.join(lines))


def set_seed(seed: int) -> None:
    """Seed the host-side draws: sequence shuffles, pack order and the
    samplers (which use `random` and `np.random`)."""
    random.seed(seed)
    np.random.seed(seed)


def get_criterion(args) -> CPCUnsupervisedCriterion:
    """Reference `train.py:27-59`, unsupervised CPC branch."""
    return CPCUnsupervisedCriterion(
        n_predicts=args.nPredicts, dim_ar=args.hiddenGar,
        dim_enc=args.hiddenEncoder,
        negative_sampling_ext=args.negativeSamplingExt, dropout=args.dropout,
        size_input_seq=args.sizeWindow // DOWNSAMPLING,
        n_skipped=args.n_skipped)


def _split(args, seq_names):
    seq_train = (filter_seqs(args.pathTrain, seq_names)
                 if args.pathTrain is not None else seq_names)
    if not seq_train:
        raise ValueError("No training sequences can be found. Please check "
                         "that you provided the right path, and specified "
                         "the right audio extension.")
    if args.pathVal is not None:
        seq_val = filter_seqs(args.pathVal, seq_names)
    else:
        print('No validation data specified!')
        if args.samplingType == "temporalsamespeaker":
            blocks, curr = [], None
            for seq_id, seq_path in seq_train:
                if curr != seq_id:
                    blocks.append([(seq_id, seq_path)])
                    curr = seq_id
                else:
                    blocks[-1].append((seq_id, seq_path))
            random.shuffle(blocks)
            seq_train = [item for b in blocks for item in b]
        else:
            random.shuffle(seq_train)
        size_train = int(0.95 * len(seq_train))
        seq_train, seq_val = seq_train[:size_train], seq_train[size_train:]
        print(f'Found files: {len(seq_train)} train, {len(seq_val)} val')
    if args.debug:
        seq_train, seq_val = seq_train[-1000:], seq_val[-100:]
    return seq_train, seq_val


def _to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    x = torch.from_numpy(batch)
    if device.type == "cuda":
        x = x.pin_memory().to(device, non_blocking=True)
    return x


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_epoch(trainer: Trainer, loader, device: torch.device,
                logging_step: int) -> Dict:
    """One epoch of training steps. Each step ends in a device synchronise
    so that its host-clock time is the step's own."""
    sums, n_steps, step_ms = None, 0, []
    window_start, window_steps, last = time.perf_counter(), 0, None
    for batch, _speaker in loader:
        x = _to_device(batch, device)
        start = time.perf_counter()
        losses, accs = trainer.train_step(x)
        _sync(device)
        step_ms.append(1000.0 * (time.perf_counter() - start))
        row = torch.cat([losses, accs]).double().cpu().numpy()  # (2, K)
        sums = row if sums is None else sums + row
        n_steps += 1
        window_steps += 1
        if window_steps >= logging_step:
            elapsed = time.perf_counter() - window_start
            print(f"Update {n_steps}")
            print(f"elapsed: {elapsed:.1f} s")
            print(f"{1000.0 * elapsed / window_steps:.1f} ms per batch")
            window = sums if last is None else sums - last
            show_logs("Training loss", {"locLoss_train": window[0] /
                                        window_steps,
                                        "locAcc_train": window[1] /
                                        window_steps})
            last, window_start, window_steps = sums.copy(), \
                time.perf_counter(), 0
    if sums is None:
        return {"iter": 0, "step_ms": step_ms}
    return {"locLoss_train": sums[0] / n_steps,
            "locAcc_train": sums[1] / n_steps, "iter": n_steps,
            "step_ms": step_ms}


def val_epoch(trainer: Trainer, loader, device: torch.device) -> Dict:
    sums, n_steps = None, 0
    for batch, _speaker in loader:
        losses, accs = trainer.val_step(_to_device(batch, device))
        row = torch.cat([losses, accs]).double().cpu().numpy()
        sums = row if sums is None else sums + row
        n_steps += 1
    if sums is None:
        return {}
    logs = {"locLoss_val": sums[0] / n_steps, "locAcc_val": sums[1] / n_steps}
    show_logs("Validation loss:", logs)
    return logs


# Flags a resumed run keeps from its own command line, not the checkpoint's
# (`cpc2_tpu/train.py:382-388`, plus the port's `--device`).
_RUN_FLAGS = {"nGPU", "pathCheckpoint", "debug", "restart", "max_size_loaded",
              "nEpoch", "save_step", "device"}
_OPTAX = "Optimizer state from optax checkpoints"


def _resume(args) -> Tuple[Dict, bool]:
    """With `--pathCheckpoint` and no `--restart`, take the flags and logs
    of the directory's newest checkpoint and load it as a whole. Returns
    (logs, whether to restore the optimizer)."""
    logs = {"epoch": [], "iter": [], "saveStep": args.save_step,
            "logging_step": args.logging_step}
    cdata = (get_checkpoint_data(args.pathCheckpoint)
             if args.pathCheckpoint is not None and not args.restart
             else None)
    if cdata is None:
        if args.pathDB is None:
            raise ValueError(f"no checkpoint to resume at "
                             f"{args.pathCheckpoint} and no --pathDB")
        return logs, False
    path, logs, loc_args = cdata
    print(f"Checkpoint detected at {path}")
    load_args(args, loc_args, forbidden_attr=_RUN_FLAGS)
    check_ported(args)
    args.load, args.loadCriterion = [path], True
    logs["logging_step"] = args.logging_step
    return logs, True


def _load_optimizer(optimizer: torch.optim.Optimizer, saved) -> None:
    """Restore a torch optimizer state dict; the JAX package's optax
    leaves are not converted."""
    if not (isinstance(saved, dict) and "state" in saved
            and "param_groups" in saved):
        raise NotImplementedError(
            "the checkpoint's optimizer state is not a torch optimizer's "
            "(a cpc2_tpu checkpoint keeps optax leaves): resuming it is not "
            f"ported to cpc2_torch (ROADMAP.md item: {_OPTAX})")
    optimizer.load_state_dict(saved)
    print("Restored optimizer state")


def main(argv: Optional[Sequence[str]]) -> Dict:
    """Train as the flags say; returns the run's record: per-epoch logs,
    every training step's time in ms, its median, and the audio hours
    trained per hour of step time."""
    args = parse_args(argv)
    logs, load_optimizer = _resume(args)
    device = resolve_device(args.device)
    set_precision(args.precision)
    set_seed(args.random_seed)
    torch.manual_seed(args.random_seed)
    print(f'CONFIG:\n{json.dumps(vars(args), indent=4, sort_keys=True)}')
    print('-' * 50)

    seq_names, speakers = find_all_seqs(
        args.pathDB, no_speaker=args.no_speaker, extension=args.file_extension,
        loadCache=not args.ignore_cache, format=args.naming_convention,
        cache_path=args.path_cache)
    print(f'Found files: {len(seq_names)} seqs, {len(speakers)} speakers')
    seq_train, seq_val = _split(args, seq_names)

    print(f'\nLoading audio data at {args.pathDB}')
    train_dataset = AudioBatchData(
        args.pathDB, args.sizeWindow, seq_train, len(speakers),
        nProcessLoader=args.n_process_loader,
        MAX_SIZE_LOADED=args.max_size_loaded,
        keep_temporality=args.samplingType == "temporalsamespeaker")
    val_dataset = (AudioBatchData(args.pathDB, args.sizeWindow, seq_val,
                                  len(speakers),
                                  nProcessLoader=args.n_process_loader)
                   if seq_val else None)

    if args.load is not None:
        model, args.hiddenGar, args.hiddenEncoder = load_model(args.load)
    else:
        model = build_model(args)
    model = model.to(device)
    criterion = get_criterion(args)
    if args.load is not None and args.loadCriterion:
        load_state(criterion, load_torch_checkpoint(args.load[0])[
            "cpcCriterion"], "cpcCriterion")
    criterion = criterion.to(device)
    params = list(model.parameters()) + list(criterion.parameters())
    print(f"Model: {sum(p.numel() for p in params)} parameters on {device}")
    optimizer = make_optimizer(args, params)
    if load_optimizer:
        _load_optimizer(optimizer,
                        load_torch_checkpoint(args.load[0])["optimizer"])
    generator = torch.Generator(device=device)
    generator.manual_seed(args.random_seed)
    trainer = Trainer(model, criterion, optimizer, generator,
                      keep_hidden=getattr(model.gAR, 'keep_hidden', False))
    lr_fn = make_lr_schedule(args.learningRate, args.schedulerStep,
                             args.schedulerRamp)
    batch_size = args.batchSizeGPU

    path_checkpoint = None
    if args.pathCheckpoint is not None:
        os.makedirs(args.pathCheckpoint, exist_ok=True)
        path_checkpoint = os.path.join(args.pathCheckpoint, "checkpoint")
        save_args(args, path_checkpoint + "_args.json")

    step_ms: List[float] = []
    best_acc, best_state = -1.0, None
    start_time = time.time()
    try:
        for epoch in range(len(logs["epoch"]), args.nEpoch):
            print(f"Starting epoch {epoch}")
            trainer.set_learning_rate(lr_fn(epoch))
            # host-side draws re-keyed per epoch, as the JAX trainer does
            set_seed((args.random_seed + 7919 * (epoch + 1)) % (2 ** 31))
            train_loader = train_dataset.getDataLoader(
                batch_size, args.samplingType, True,
                remove_artefacts=args.no_artefacts,
                batch_size_per_gpu=args.batchSizeGPU)
            val_loader = (val_dataset.getDataLoader(batch_size, 'sequential',
                                                    False)
                          if val_dataset is not None else [])
            print("Training dataset %d batches, Validation dataset %d "
                  "batches, batch size %d" % (len(train_loader),
                                              len(val_loader), batch_size))
            loc_train = train_epoch(trainer, train_loader, device,
                                    args.logging_step)
            step_ms += loc_train.pop("step_ms")
            loc_val = (val_epoch(trainer, val_loader, device)
                       if val_dataset is not None else {})
            print(f'Ran {epoch + 1} epochs '
                  f'in {time.time() - start_time:.2f} seconds')
            if "locAcc_val" in loc_val:
                accuracy = float(np.mean(loc_val["locAcc_val"]))
                if accuracy > best_acc:
                    best_acc = accuracy
                    best_state = {k: v.detach().cpu().clone()
                                  for k, v in model.state_dict().items()}
            for key, value in dict(loc_train, **loc_val).items():
                logs.setdefault(key, [None] * epoch).append(
                    value.tolist() if isinstance(value, np.ndarray)
                    else value)
            logs["epoch"].append(epoch)
            if path_checkpoint is not None and (
                    epoch % logs["saveStep"] == 0 or epoch == args.nEpoch - 1):
                save_checkpoint(model.state_dict(), criterion.state_dict(),
                                optimizer.state_dict(), best_state,
                                f"{path_checkpoint}_{epoch}.pt")
                save_logs(logs, path_checkpoint + "_logs.json")
    finally:
        train_dataset.close()
        if val_dataset is not None:
            val_dataset.close()

    record = {"logs": logs, "step_ms": step_ms,
              "param_devices": sorted({str(p.device) for p in params})}
    if step_ms:
        median = statistics.median(step_ms)
        audio_s = batch_size * args.sizeWindow / SAMPLE_RATE
        record["median_step_ms"] = median
        record["audio_hours_per_hour"] = audio_s / (median / 1000.0)
        print(f"{len(step_ms)} training steps: median {median:.3f} ms/step, "
              f"{record['audio_hours_per_hour']:.1f} audio-hours per hour "
              f"(batch {batch_size} x {audio_s / batch_size:.2f} s) "
              f"on {device}")
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
