"""CPC pretraining on one device or data-parallel ranks (counterpart of
`cpc2_tpu/train.py`, reference `cpc/train.py`).

Run: `python -m cpc2_torch.train --pathDB <corpus>` (FLAC by default;
`--file_extension .wav` and the compressed formats of `data/audio_io.py`
read too). It parses the JAX trainer's flags, finds the sequences and
splits them 95/5 into train and validation as `cpc2_tpu/train.py:459-495`
does, builds
the model, criterion and optimizer on the device, and runs `--nEpoch`
epochs of training steps, each followed by a validation pass. It prints
the reference's per-step loss and accuracy tables and the step times.

With `--pathCheckpoint <dir>` it writes `checkpoint_args.json` at the
start and `checkpoint_<epoch>.pt` (the reference's `{gEncoder,
cpcCriterion, optimizer, best}`) with `checkpoint_logs.json` every
`--save_step` epochs and at the last one. A run whose directory holds a
checkpoint resumes from the newest one (model, criterion, optimizer, the
next epoch) unless `--restart`, from either package's checkpoint (the JAX
package's optax leaves become torch Adam's or SGD's state). The port's
checkpoints also keep the state of the generator behind the negatives and
dropout, so a resumed run replays an uninterrupted one. `--load
<checkpoint>` starts from a checkpoint's model, and its criterion with
`--loadCriterion`; several checkpoints train as one concatenated model.
`--profile_dir <dir>` writes a `torch.profiler` trace of the first
epoch's steps 5 to 14 there.

`--supervised` trains the model under a supervised criterion in place of
CPC's: a linear speaker classifier on the last context frame, or with
`--pathPhone <labels>` (lines of `seqName idx idx ...`, one phone every 160
samples) a frame-wise phone classifier (`--nLevelsPhone` layers,
`--onEncoder` on the encodings) or, with `--CTC`, a CTC phone head. The logs
keep the reference's `locLoss_*` and `locAcc_*` keys, one column each.

`--augment_past` / `--augment_future` with `--augment_type ...` augment the
training windows on the host (`data/augmentation.py`; `--pathDBNoise` for
`additive`, `--pathImpulseResponses` for `natural_reverb`, `--meta_aug` to
augment the noise corpus itself); with `--augment_on_device` the types run
on the device instead (`data/augment_device.py`), where a type with no
device version stays on the host ahead of them. The loader runs on a
thread `--host_prefetch` batches ahead of the steps (0: between them).
Validation is never augmented.

The model and criterion modes of the JAX package train too: the
prediction heads of `--rnnMode` (RNN, LSTM, linear, ffd, conv4/8/12) or one
shared trunk (`--multihead_rnn`), `--cpc_mode reverse`, `bert` or `none`,
the MFCC and learned-filterbank front-ends (`--encoder_type mfcc|lfb`),
span masks on the context network's input (`--mask_prob`,
`--mask_length`) and a loss weighted by signal quality
(`--signal_quality_path` with a WAV corpus, `--signal_quality_step`,
`--signal_quality_mode`, `--growth_rate`, `--inflection_point_x`). The
masks are drawn on the loader's side from numpy's global state, one row a
view (2 x batch), for training and validation batches alike, as
`cpc2_tpu/dispatch.py:stack_batch` draws them.

`--corpus_on_device` keeps each split's pack on the device
(`data/device_corpus.py`), the loader sending only window offsets;
`--steps_per_dispatch N` runs N steps per dispatch (`training.MultiStep`:
on a card one CUDA graph replay). Both compose with each other and with
`--augment_on_device`, not with a host augmentation.

`--nGPU N` (and `--data_axis_size`) trains N ranks on this host, one
process each, every rank taking its rows of the loader's global batch;
`--distributed` runs this process as one rank of a torchrun or SLURM
layout, each rank loading its share of the files (`main`). The ranks
average their gradients, metrics and BatchNorm statistics each step
(`parallel/`), route short batches by `train_tails.route`, and rank 0
writes the checkpoints and logs; `--global_negatives` draws the negatives
over every rank's encodings.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import random
import shutil
import statistics
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .config import check_ported, parse_args
from .data import (AudioBatchData, PeakNorm, filter_distributed,
                   filter_seqs, find_all_seqs, parse_seq_labels)
from .data import augment_device
from .data.augmentation import (augmentation_factory,
                                canonical_augment_type, restart)
from .data.dataset import pack_windows
from .data.device_corpus import DeviceCorpus
from .dispatch import EPOCH_END, GroupAssembler
from .feature_loader import build_model, load_model, load_state
from .io.checkpoint import (get_checkpoint_data, load_args,
                            load_torch_checkpoint, save_args,
                            save_checkpoint, save_logs)
from .io.from_jax import jax_param_order, state_dict_from_jax
from .losses import (CPCBertCriterion, CPCUnsupervisedCriterion,
                     CTCPhoneCriterion, NoneCriterion, PhoneCriterion,
                     SpeakerCriterion)
from .models.cpc import compute_bert_mask, compute_mask_indices
from .models.encoder import DOWNSAMPLING, encoded_seq_len
from .ops import _build
from .parallel import (DataParallel, free_port, init_distributed_mode,
                       init_process_group, peek_distributed, rank_device,
                       rank_layout, rank_seed)
from .train_tails import PodTailRunner, TailRunner, route
from .training import (MultiStep, Trainer, make_lr_schedule,
                       make_optimizer, precision, resolve_device)
from .utils.prefetch import PrefetchIterator, prefetch

SAMPLE_RATE = 16000


def show_logs(text: str, logs: Dict[str, np.ndarray]) -> None:
    """The reference's per-prediction-step table (`utils/misc.py:44-60`):
    a 'Step 1..K' header and one 16-wide value row per metric."""
    def row(cells):
        return ' '.join('{:>16}' for _ in cells).format(*cells)

    lines = ["", '-' * 50, text]
    for key, values in logs.items():
        if key == "iter":
            continue
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


def get_criterion(args, n_speakers: int = 0,
                  n_phones: Optional[int] = None) -> nn.Module:
    """Reference `train.py:27-59` (`cpc2_tpu/train.py:get_criterion`): the
    CPC criterion (`--cpc_mode none`: `NoneCriterion`, `bert`: the masked
    criterion), or with `--supervised` the phone criterion (`--pathPhone`;
    the CTC one with `--CTC`) or the speaker one over `n_speakers`. A
    supervised head reads the encodings (`hiddenEncoder` wide) with
    `--onEncoder` where it can, else the context (`hiddenGar` wide); the
    speaker head always reads the last context frame. The CPC criterion's
    transformer heads run in `head_dtype(args)` and draw their negatives
    in groups of `--neg_pool_group` (training and validation alike); the
    other criteria ignore that flag, as the JAX package's do."""
    if not args.supervised and args.cpc_mode == 'none':
        return NoneCriterion()
    if not args.supervised and args.cpc_mode == 'bert':
        return CPCBertCriterion(args.hiddenGar, args.hiddenEncoder,
                                args.negativeSamplingExt)
    if args.supervised:
        if args.pathPhone is None:
            return SpeakerCriterion(args.hiddenGar, n_speakers)
        if args.CTC:
            return CTCPhoneCriterion(args.hiddenGar, n_phones,
                                     on_encoder=args.onEncoder)
        return PhoneCriterion(args.hiddenGar, args.hiddenEncoder, n_phones,
                              on_encoder=args.onEncoder,
                              n_layers=args.nLevelsPhone)
    return CPCUnsupervisedCriterion(
        n_predicts=args.nPredicts, dim_ar=args.hiddenGar,
        dim_enc=args.hiddenEncoder,
        negative_sampling_ext=args.negativeSamplingExt, dropout=args.dropout,
        size_input_seq=args.sizeWindow // DOWNSAMPLING,
        n_skipped=args.n_skipped, mode=args.cpc_mode, rnn_mode=args.rnnMode,
        multihead_rnn=args.multihead_rnn, growth_rate=args.growth_rate,
        inflection_point_x=args.inflection_point_x,
        head_dtype=head_dtype(args),
        neg_pool_group=getattr(args, 'neg_pool_group', 0))


def head_dtype(args) -> Optional[torch.dtype]:
    """The transformer heads' activation dtype: bf16 under `--precision
    bf16` (a resumed run reads it from its `checkpoint_args.json`), else
    None (fp32)."""
    return (torch.bfloat16 if getattr(args, 'precision', None) == 'bf16'
            else None)


def step_mask(args, batch: int) -> Optional[np.ndarray]:
    """The host's draw of a step's mask, (2 x batch, frames) bool, from
    numpy's global state (`cpc2_tpu/dispatch.py:stack_batch`): BERT blocks
    of `nPredicts` frames under `--cpc_mode bert`, spans under
    `--mask_prob`, else None."""
    frames = encoded_seq_len(args.sizeWindow, args.encoder_type)
    if args.cpc_mode == 'bert':
        return compute_bert_mask((2 * batch, frames), 2, args.nPredicts)
    if args.mask_prob > 0:
        return compute_mask_indices((2 * batch, frames), args.mask_prob,
                                    args.mask_length, min_masks=2)
    return None


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


def _dispatch_items(loader, device: torch.device, load_ms: List[float],
                    batch_size: int, groups: Optional[GroupAssembler],
                    offsets: bool, args=None, dp=None):
    """What the stepping thread runs, built on the loader's thread:
    `('steps', [(pack, x, label, quality, mask, kind), ...])`, one step
    each in order, or a full group `('idxgroup', pack, x (N, ...), labels
    (N, ...), n, quality, masks)`, one `MultiStep` dispatch. `x` is a (B,
    2, 1, W) batch, or with `offsets` (`--corpus_on_device`) the batch's
    (B,) window offsets into `pack`, the host pack they were drawn from
    (None for batches); `quality` is the batch's signal quality, the
    loader's last item when the corpus has it (else None), and `mask` the
    step's mask drawn here (`step_mask`, with `args`). Under ranks (`dp`)
    `kind` is the batch's `train_tails.route` against the full
    `batch_size`: a `rows` batch is cut to this rank's rows here
    (`parallel.rank_rows`, the mask's too), an `alone` one stays whole and
    a `tail` one is buffered by the stepping thread. With `groups` (N >
    1) full batches are buffered into groups; a short batch flushes the
    buffer and runs after it, so the steps keep the loader's order. Tensors are pinned for their copy to a card. Each
    loader item's host time (sampling, gather, host augmentation,
    grouping, pinning) is appended to `load_ms`: the work the prefetch
    thread takes off the stepping thread."""
    pin = device.type == "cuda"

    def tensor(a, dtype):
        t = torch.from_numpy(np.asarray(a).astype(dtype, copy=False))
        return t.pin_memory() if pin else t

    def steps(items):
        return ('steps', [(pack, tensor(x, x.dtype), tensor(y, np.int64),
                           None if q is None else tensor(q, np.float32),
                           None if m is None else tensor(m, bool),
                           kind[0] if kind else "whole")
                          for pack, x, y, q, m, *kind in items])

    quality = getattr(loader.dataset, 'signal_quality_path', None) is not None

    def prep(full):
        if full is EPOCH_END:
            flushed = groups.flush() if groups is not None else None
            return None if flushed is None else steps(flushed[1])
        x, label = full[:2]
        item = (loader.dataset.data if offsets else None,
                np.asarray(x, np.int32) if offsets else x, np.asarray(label),
                np.asarray(full[-1], np.float32) if quality else None,
                None if args is None else step_mask(args, x.shape[0]))
        n = item[1].shape[0]
        kind = route(n, batch_size, dp)
        if kind == "rows":
            item = (item[0],) + tuple(None if t is None else dp.rows(t)
                                      for t in item[1:])
        if groups is None or n != batch_size:
            flushed = groups.flush() if groups is not None else None
            return steps(([] if flushed is None else flushed[1])
                         + [item + (kind,)])
        out = groups.add(item)
        return steps(out[1]) if out is not None and out[0] == 'idxpartial' \
            else out

    batches = iter(loader)
    while True:
        start = time.perf_counter()
        full = next(batches, EPOCH_END)
        out = prep(full)
        if full is not EPOCH_END:
            load_ms.append(1000.0 * (time.perf_counter() - start))
        if out is not None:
            yield out
        if full is EPOCH_END:
            return


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# The profiled window of `--profile_dir`: steps 5 to 14 of the first
# epoch, as the JAX trainer's (`cpc2_tpu/train_loop.py:183-195`).
PROFILE_START, PROFILE_STOP = 5, 15
TRACE_NAME = "train_steps.pt.trace.json"


def _start_profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, device: torch.device, profile_dir: str) -> None:
    _sync(device)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(profile_dir, TRACE_NAME))
    print(f"Profiler trace written to {profile_dir}")


def _run_steps(trainer: Trainer, items, device: torch.device,
               corpus: Optional[DeviceCorpus],
               tails: Optional[PodTailRunner] = None,
               tail_runner: Optional[TailRunner] = None
               ) -> Optional[torch.Tensor]:
    """Single steps, in order, of a `('steps', items)` dispatch item: each
    batch gathered from the resident pack (`corpus`) or copied to the
    device; an `alone` batch through `tail_runner`, a `tail` one buffered
    in `tails` (as audio) for the epoch's end. Returns the (n, 2, K)
    losses and accuracies of the steps run, on the device, or None."""
    rows = []
    for pack, x, label, quality, mask, kind in items:
        if kind == "tail":
            if corpus is not None:
                # as audio: the resident pack may change before the end
                x = pack_windows(pack, x, tails.size_window)
            tails.add((x, label, quality, mask))
            continue
        if corpus is not None:
            corpus.ensure(pack)
            x = corpus.put(x)
        else:
            x = x.to(device, non_blocking=True)
        label = (label.to(device, non_blocking=True) if trainer.supervised
                 else None)
        quality, mask = (None if t is None else t.to(device, non_blocking=True)
                         for t in (quality, mask))
        step = (trainer.train_step if kind != "alone" else
                functools.partial(tail_runner.train, trainer))
        rows.append(torch.cat(step(x, label=label, mask=mask,
                                   quality=quality)))
    return torch.stack(rows) if rows else None


def train_epoch(trainer: Trainer, loader, device: torch.device,
                logging_step: int, profile_dir: Optional[str] = None,
                prefetch_depth: int = 0,
                corpus: Optional[DeviceCorpus] = None,
                multi_step: Optional[MultiStep] = None,
                batch_size: int = 0, args=None,
                tails: Optional[PodTailRunner] = None,
                tail_runner: Optional[TailRunner] = None) -> Dict:
    """One epoch of training steps. The loader runs on a thread
    `prefetch_depth` batches ahead (0: on this thread, between the steps)
    and groups its batches there (`_dispatch_items`); this thread issues
    each dispatch: one step, or with `multi_step` (N > 1) a full group of
    N, then one device synchronise and one copy of the losses, so that its
    host-clock time is the dispatch's own. With `corpus`
    (`--corpus_on_device`) the loader yields window offsets and the steps
    gather their batches from the resident pack. A batch other than
    `batch_size` long runs as a single step; under ranks as
    `train_tails.route` says (`tail_runner` for one host's, `tails` for
    the weighted rounds of ranks that load their own files, run after the
    loader's last batch). The record's `step_ms` holds each step's time (a
    dispatch's divided by its steps), `step_losses` each step's per-head
    losses, `dispatch_ms` each dispatch's host time until it returned
    (before the synchronise), `wait_ms`, for each step, its share of the
    host-clock time from the end of the dispatch before (from the epoch's
    start for the first) until its batches were in hand, and `load_ms`
    each batch's host time on the loader's thread. With `profile_dir`, the
    dispatches from the one that holds step PROFILE_START up to step
    PROFILE_STOP - 1 (or to the epoch's end) are traced into it; the
    record's `profiled` says whether a trace was written."""
    sums, n_steps, step_ms, wait_ms, load_ms = None, 0, [], [], []
    dispatch_ms, step_losses = [], []
    window_start, window_steps, last = time.perf_counter(), 0, None
    profiler, profiled = None, False
    groups = (GroupAssembler(multi_step.n_inner, device.type == "cuda")
              if multi_step is not None else None)
    batches = prefetch(_dispatch_items(loader, device, load_ms,
                                       batch_size, groups,
                                       corpus is not None, args,
                                       trainer.dp),
                       prefetch_depth)

    def account(rows, start, wait):
        nonlocal sums, n_steps, window_steps, last, window_start
        rows = rows.double().cpu().numpy()      # (n, 2, K)
        n = rows.shape[0]
        step_ms.extend([1000.0 * (time.perf_counter() - start) / n] * n)
        wait_ms.extend([wait / n] * n)
        for row in rows:
            sums = row if sums is None else sums + row
            step_losses.append(row[0].tolist())
        n_steps += n
        window_steps += n
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

    try:
        ready = time.perf_counter()
        for item in batches:
            wait = 1000.0 * (time.perf_counter() - ready)
            if profile_dir is not None and not profiled:
                if profiler is None and n_steps >= PROFILE_START:
                    profiler = _start_profiler(device)
                elif profiler is not None and n_steps >= PROFILE_STOP:
                    _stop_profiler(profiler, device, profile_dir)
                    profiler, profiled = None, True
            start = time.perf_counter()
            if item[0] == 'idxgroup':
                _, pack, x, labels, _n, quality, masks = item
                if corpus is not None:
                    corpus.ensure(pack)
                rows = torch.stack(multi_step(x, labels, quality, masks),
                                   dim=1)
            else:
                rows = _run_steps(trainer, item[1], device, corpus, tails,
                                  tail_runner)
            if rows is not None:
                dispatch_ms.append(1000.0 * (time.perf_counter() - start))
                account(rows, start, wait)
            ready = time.perf_counter()
    finally:
        if isinstance(batches, PrefetchIterator):
            batches.close()
    if tails is not None:
        with_quality = getattr(loader.dataset, 'signal_quality_path',
                               None) is not None
        # each round timed as a dispatch of its own
        rounds, start = 0, time.perf_counter()
        for _n, losses, accs in tails.run_train(trainer, with_quality):
            dispatch_ms.append(1000.0 * (time.perf_counter() - start))
            account(torch.cat([losses, accs])[None], start, 0.0)
            rounds, start = rounds + 1, time.perf_counter()
        if rounds:
            print(f"(ran {rounds} weighted tail rounds)")
    if profiler is not None:      # the epoch ended inside the window
        _stop_profiler(profiler, device, profile_dir)
        profiled = True
    record = ({} if sums is None else {"locLoss_train": sums[0] / n_steps,
                                       "locAcc_train": sums[1] / n_steps})
    record.update(iter=n_steps, step_ms=step_ms, wait_ms=wait_ms,
                  load_ms=load_ms, dispatch_ms=dispatch_ms,
                  profiled=profiled, step_losses=step_losses)
    return record


def val_epoch(trainer: Trainer, loader, device: torch.device,
              corpus: Optional[DeviceCorpus] = None, args=None,
              batch_size: int = 0, tails: Optional[PodTailRunner] = None,
              tail_runner: Optional[TailRunner] = None) -> Dict:
    """The validation pass; with `corpus` each batch gathered from the
    validation pack on the device. Its masks are drawn as the training
    steps' are (`step_mask`, with `args`), and under ranks its batches
    take `train_tails.route` against `batch_size` as the training steps'
    do. The record's `val_steps` counts its steps."""
    sums, n_steps = None, 0
    quality = getattr(loader.dataset, 'signal_quality_path', None) is not None
    for full in loader:
        x, label = full[:2]
        mask = None if args is None else step_mask(args, x.shape[0])
        label = np.asarray(label)
        q = np.asarray(full[-1], np.float32) if quality else None
        kind = route(x.shape[0], batch_size, trainer.dp)
        if kind == "rows":
            x, label, q, mask = (None if t is None else trainer.dp.rows(t)
                                 for t in (x, label, q, mask))
        if kind == "tail":
            if corpus is not None:
                x = pack_windows(loader.dataset.data, x, tails.size_window)
            tails.add((x, label, q, mask))
            continue
        if corpus is not None:
            corpus.ensure(loader.dataset.data)
            x = corpus.put(x)
        else:
            x = torch.from_numpy(x).to(device)
        label = (torch.from_numpy(label).to(device) if trainer.supervised
                 else None)
        q = None if q is None else torch.from_numpy(q).to(device)
        mask = None if mask is None else torch.from_numpy(mask).to(device)
        step = (trainer.val_step if kind != "alone" else
                functools.partial(tail_runner.val, trainer))
        losses, accs = step(x, label=label, mask=mask, quality=q)
        row = torch.cat([losses, accs]).double().cpu().numpy()
        sums = row if sums is None else sums + row
        n_steps += 1
    for _n, losses, accs in ([] if tails is None else
                             tails.run_val(trainer, quality)):
        row = torch.cat([losses, accs]).double().cpu().numpy()
        sums = row if sums is None else sums + row
        n_steps += 1
    if sums is None:
        return {}
    logs = {"locLoss_val": sums[0] / n_steps, "locAcc_val": sums[1] / n_steps}
    show_logs("Validation loss:", logs)
    return dict(logs, val_steps=n_steps)


# Flags a resumed run keeps from its own command line, not the checkpoint's
# (`cpc2_tpu/train.py:382-388`, plus the port's `--device`), and the rank
# layout's fields (`parallel.init_distributed_mode`).
_RANK_FIELDS = {"is_slurm_job", "n_nodes", "node_id", "local_rank",
                "global_rank", "world_size", "n_gpu_per_node", "is_master",
                "multi_node", "multi_gpu", "is_local_master"}
_RUN_FLAGS = {"nGPU", "pathCheckpoint", "debug", "restart", "max_size_loaded",
              "nEpoch", "save_step", "device"} | _RANK_FIELDS
# Where the port's checkpoints keep the state of the trainer's generator:
# in the optimizer entry, beside torch's own state dict; under ranks also
# every rank's, in rank order, and the tail runner's.
GENERATOR_KEY = "generator_state"
RANK_GENERATORS_KEY = "rank_generator_states"
TAIL_GENERATOR_KEY = "tail_generator_state"


def _resume(args) -> Tuple[Dict, bool, Optional[List[str]]]:
    """With `--pathCheckpoint` and no `--restart`, take the flags and logs
    of the directory's newest checkpoint and load it as a whole. Returns
    (logs, whether to restore the optimizer, the `--load` the run's saved
    flags name: the checkpoints its model was built from)."""
    logs = {"epoch": [], "iter": [], "saveStep": args.save_step,
            "logging_step": args.logging_step}
    cdata = (get_checkpoint_data(args.pathCheckpoint)
             if args.pathCheckpoint is not None and not args.restart
             else None)
    if cdata is None:
        if args.pathDB is None:
            raise ValueError(f"no checkpoint to resume at "
                             f"{args.pathCheckpoint} and no --pathDB")
        return logs, False, args.load
    path, logs, loc_args = cdata
    print(f"Checkpoint detected at {path}")
    load_args(args, loc_args, forbidden_attr=_RUN_FLAGS)
    check_ported(args)
    built_from = args.load
    args.load, args.loadCriterion = [path], True
    logs["logging_step"] = args.logging_step
    return logs, True, built_from


def _leaf_tensor(leaf) -> torch.Tensor:
    """An optax leaf as a tensor: a torch tensor as it is, an array as
    numpy gives it, and a bf16 array (`--adam_mu_dtype bf16`'s mu, numpy's
    `ml_dtypes.bfloat16`, which torch does not take) by its bits."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.as_tensor(arr)


def _optax_moments(optimizer: torch.optim.Optimizer, saved: Dict,
                   modules: Dict[str, nn.Module], norm_mode: str
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """torch optimizer state, by `name.key` of each parameter, from the
    JAX package's `{'format': 'optax_leaves', 'leaves', 'step'}`: the
    leaves of `optax.inject_hyperparams(optax.adam)`'s state (the injected
    count, then b1, b2, eps, eps_root and learning_rate, then Adam's count,
    mu and nu) or of `inject_hyperparams(optax.sgd)`'s (count,
    learning_rate, momentum, the trace), each moment over the param tree
    `{'criterion', 'model'}` in `jax_param_order`. A bf16 mu
    (`--adam_mu_dtype bf16`) comes as its fp32 values, which the optimizer
    stores in its own `exp_avg` dtype on loading."""
    order = jax_param_order(modules)
    adam = isinstance(optimizer, torch.optim.Adam)
    n_scalars, moments = (7, ("mu", "nu")) if adam else (3, ("trace",))
    leaves = list(saved["leaves"])
    want = n_scalars + len(moments) * len(order)
    if len(leaves) != want:
        raise ValueError(
            f"the checkpoint's optax state has {len(leaves)} leaves; this "
            f"model's {type(optimizer).__name__} state takes {want} "
            f"({n_scalars} scalars and {len(moments)} x {len(order)} "
            f"parameters)")
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    for m, moment in enumerate(moments):
        start = n_scalars + m * len(order)
        trees: Dict[str, Dict] = {name: {} for name in modules}
        for (path, shape), leaf in zip(order,
                                       leaves[start:start + len(order)]):
            leaf = _leaf_tensor(leaf)
            if tuple(leaf.shape) != shape:
                raise ValueError(f"optax {moment} leaf {'/'.join(path)}: "
                                 f"shape {tuple(leaf.shape)}, the port's "
                                 f"parameter takes {shape}")
            node = trees[path[0]]
            for part in path[1:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = leaf.float().numpy()
        for name, tree in trees.items():
            for key, value in state_dict_from_jax(tree,
                                                  norm_mode=norm_mode).items():
                state.setdefault(f"{name}.{key}", {})[moment] = value
    if adam:
        count = float(torch.as_tensor(leaves[6]))     # Adam's own count
        return {key: {"step": torch.tensor(count, dtype=torch.float32),
                      "exp_avg": value["mu"], "exp_avg_sq": value["nu"]}
                for key, value in state.items()}
    return {key: {"momentum_buffer": value["trace"]}
            for key, value in state.items()}


def _load_optimizer(optimizer: torch.optim.Optimizer, saved,
                    modules: Dict[str, nn.Module], norm_mode: str
                    ) -> Optional[torch.Tensor]:
    """Restore the optimizer from a checkpoint's `optimizer` entry: torch's
    state dict (the port's and the reference's checkpoints) or the JAX
    package's optax leaves. Returns the saved state of the trainer's
    generator, or None where the checkpoint has none."""
    if isinstance(saved, dict) and saved.get("format") == "optax_leaves":
        by_key = _optax_moments(optimizer, saved, modules, norm_mode)
        params = {f"{name}.{key}": p for name, module in modules.items()
                  for key, p in module.named_parameters()}
        state_dict = optimizer.state_dict()
        ids = dict(zip(map(id, optimizer.param_groups[0]["params"]),
                       state_dict["param_groups"][0]["params"]))
        state_dict["state"] = {ids[id(p)]: by_key[key]
                               for key, p in params.items()}
        optimizer.load_state_dict(state_dict)
        print(f"Restored optimizer state from optax leaves (the JAX "
              f"package's global step {saved.get('step')} is not used)")
        return None
    if not (isinstance(saved, dict) and "state" in saved
            and "param_groups" in saved):
        raise ValueError(
            "the checkpoint's optimizer entry is neither a torch optimizer's "
            "state dict nor the JAX package's optax leaves (a --ckpt_format "
            "orbax run keeps its optimizer state in <checkpoint>.orbax)")
    saved = dict(saved)
    generator_state = saved.pop(GENERATOR_KEY, None)
    saved.pop(RANK_GENERATORS_KEY, None)
    saved.pop(TAIL_GENERATOR_KEY, None)
    # `capturable` and `fused` say how this run's Adam updates (fused, its
    # step count on the device, on a card), not a setting of the saved run
    saved["param_groups"] = [
        dict(group, **{key: mine[key] for key in ("capturable", "fused")
                       if key in mine})
        for group, mine in zip(saved["param_groups"],
                               optimizer.param_groups)]
    optimizer.load_state_dict(saved)
    print("Restored optimizer state")
    return generator_state


def main(argv: Optional[Sequence[str]]) -> Dict:
    """Train as the flags say; returns the run's record (rank 0's under
    ranks): per-epoch logs, every training step's time in ms and losses,
    the median time, and the audio hours trained per hour of step time.

    `--distributed` (or a resume whose saved flags say so,
    `parallel.peek_distributed`) runs this process as one rank of the
    environment's layout (`parallel.init_distributed_mode`: torchrun's or
    SLURM's variables), on `cuda:<local rank>` or the CPU, each rank
    loading its own share of the files. Otherwise `--data_axis_size`
    ranks (-1: `--nGPU`, itself -1 for every visible card) train on this
    host, one process each, spawned here, every rank taking its rows of
    the one loader's global batch of nGPU x batchSizeGPU; the kernels are
    built once before the ranks start."""
    argv = list(sys.argv[1:] if argv is None else argv)
    boot = None
    if peek_distributed(argv):
        boot = argparse.Namespace()
        init_distributed_mode(boot)
    args = parse_args(argv)
    logs, load_optimizer, built_from = _resume(args)
    if args.signal_quality_path is not None and \
            not os.path.exists(args.signal_quality_path):
        raise ValueError("%s can't be found. Are you sure you provided the "
                         "right location ?" % args.signal_quality_path)
    if args.distributed:
        if boot is None:
            boot = argparse.Namespace()
            init_distributed_mode(boot)
        vars(args).update(vars(boot))
        return _rank_run(args, logs, load_optimizer, built_from, pod=True)
    world = _one_host_layout(args)
    if world > 1:
        return _spawn(argv, world, args.device)
    device = resolve_device(args.device)
    with precision(args.precision):
        return _train(args, logs, load_optimizer, built_from, device)


def _one_host_layout(args) -> int:
    """The ranks of a run on this host (`cpc2_tpu/train.py:1050-1055`,
    `:676`): `--nGPU` -1 is every visible card (1 on the CPU), 0 is 1;
    `--data_axis_size` D > 0 ranks, else nGPU, which the visible cards
    must hold and which must divide the global batch nGPU x batchSizeGPU;
    `--dcn_axis_size` must divide them."""
    visible = torch.cuda.device_count() if args.device == "cuda" else 1
    if args.nGPU == 0:
        args.nGPU = 1
    if args.nGPU < 0:
        args.nGPU = max(visible, 1)
    world = args.data_axis_size if args.data_axis_size > 0 else args.nGPU
    if world > 1 and args.device == "cuda" and world > visible:
        raise RuntimeError(f"{world} ranks asked, {visible} CUDA device(s) "
                           f"visible: one rank a card")
    if (args.nGPU * args.batchSizeGPU) % world:
        raise ValueError(f"the global batch nGPU x batchSizeGPU = "
                         f"{args.nGPU * args.batchSizeGPU} does not split "
                         f"over {world} ranks")
    rank_layout(world, args.dcn_axis_size)
    return world


def _spawn(argv: List[str], world: int, device_name: str) -> Dict:
    """`world` rank processes on this host (`_spawn_rank`), rank 0's record
    back through a file."""
    import torch.multiprocessing as mp
    if device_name == "cuda":
        _build.build()
    port = free_port()
    tmp = tempfile.mkdtemp(prefix="cpc2_ranks_")
    try:
        path = os.path.join(tmp, "record.pt")
        mp.start_processes(_spawn_rank, args=(argv, world, port, path),
                           nprocs=world, join=True, start_method="spawn")
        return torch.load(path, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _spawn_rank(rank: int, argv: List[str], world: int, port: int,
                path: str) -> None:
    args = parse_args(argv)
    logs, load_optimizer, built_from = _resume(args)
    _one_host_layout(args)
    vars(args).update(is_slurm_job=False, n_nodes=1, node_id=0,
                      local_rank=rank, global_rank=rank, world_size=world,
                      n_gpu_per_node=world, is_master=rank == 0,
                      multi_node=False, multi_gpu=True)
    record = _rank_run(args, logs, load_optimizer, built_from, pod=False,
                       init_method=f"tcp://127.0.0.1:{port}")
    if rank == 0:
        torch.save(record, path)


def _rank_run(args, logs: Dict, load_optimizer: bool,
              built_from: Optional[List[str]], pod: bool,
              init_method: Optional[str] = None) -> Dict:
    """This process as rank `args.global_rank` of `args.world_size`: its
    device, the process group (left when the run ends, whatever happens),
    the training; ranks above 0 print nothing. `pod`: the ranks load their
    own files (`--distributed`)."""
    rank, world = args.global_rank, args.world_size
    if pod:
        print('Distributed mode, moving to 1 process for data loading')
        args.n_process_loader = 1
        rank_layout(world, args.dcn_axis_size)
    args.is_local_master = rank == 0
    device = rank_device(args.device, args.local_rank)
    per_host = max(1, getattr(args, "n_gpu_per_node", world))
    if device.type == "cpu" and per_host > 1:
        # the host's cores shared out among its ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // per_host))
    elif device.type == "cuda" and pod:
        _build.build()
    stdout = sys.stdout
    init_process_group(rank, world, device, init_method)
    try:
        if rank:
            sys.stdout = open(os.devnull, "w")
        dp = DataParallel(rank, world, device, args.dcn_axis_size,
                          pod=pod and world > 1)
        print(f"Rank {rank} of {world} on {device} ({dp.backend}), nodes x "
              f"ranks {tuple(dp.layout.shape)}")
        with precision(args.precision):
            return _train(args, logs, load_optimizer, built_from, device, dp)
    finally:
        if sys.stdout is not stdout:
            sys.stdout.close()
            sys.stdout = stdout
        dist.destroy_process_group()


def _restore_generators(saved, generator_state, generator: torch.Generator,
                        tail_runner: Optional[TailRunner],
                        dp: Optional[DataParallel]) -> None:
    """The saved states of the trainer's generator (this rank's, where
    the checkpoint holds every rank's of as many ranks) and the tail
    runner's; where a state is missing, its seed's stream starts again."""
    rank, world = (0, 1) if dp is None else (dp.rank, dp.world)
    states = saved.get(RANK_GENERATORS_KEY) if isinstance(saved, dict) \
        else None
    if states is not None and len(states) == world:
        generator_state = states[rank]
    elif rank:
        generator_state = None
    if generator_state is None:
        print("The checkpoint holds no generator state for this rank: the "
              "negatives and dropout draws start again from --random_seed")
    else:
        generator.set_state(generator_state)
        print("Restored the generator state")
    tail_state = saved.get(TAIL_GENERATOR_KEY) if isinstance(saved, dict) \
        else None
    if tail_runner is not None and tail_state is not None:
        tail_runner.generator.set_state(tail_state)


def _best(logs: Dict, path: str) -> Tuple[float, Optional[Dict]]:
    """The best validation accuracy of a resumed run's earlier epochs and
    its checkpoint's `best` weights, so that the resumed run keeps the
    same best as an uninterrupted one."""
    accs = [float(np.mean(v)) for v in logs.get("locAcc_val", [])
            if v is not None]
    if not accs:
        return -1.0, None
    return max(accs), load_torch_checkpoint(path)["best"]


def _noise_dataset(args, generators, shard=None
                   ) -> Optional[AudioBatchData]:
    """The noise corpus of `--pathDBNoise` (`cpc2_tpu/train.py:508-529`):
    windows peak-normalised, and with `--meta_aug` augmented by
    `--meta_aug_type` (both views the same); `shard` keeps a rank's share
    of its files (`--distributed`)."""
    if args.pathDBNoise is None or not (args.augment_past
                                        or args.augment_future):
        return None
    seq_noise, _ = find_all_seqs(args.pathDBNoise,
                                 extension=args.noise_extension,
                                 loadCache=True, speaker_level=0)
    if args.pathSeqNoise is not None:
        seq_noise = filter_seqs(args.pathSeqNoise, seq_noise)
    if args.debug:
        seq_noise = seq_noise[:100]
    if shard is not None:
        seq_noise = shard(seq_noise)
    print(f'\nLoading noise data at {args.pathDBNoise}')
    return AudioBatchData(
        args.pathDBNoise, args.sizeWindow, seq_noise, None, 1,
        nProcessLoader=args.n_process_loader,
        MAX_SIZE_LOADED=args.max_size_loaded, transform=PeakNorm(),
        augment_past=args.meta_aug, augment_future=False,
        augmentation=augmentation_factory(
            args, None, applied_on_noise=True, batch_size=args.batchSizeGPU,
            **generators),
        keep_temporality=(args.naming_convention or '').startswith(
            "id_spkr_onset_offset"),
        past_equal_future=args.meta_aug)


def _split_types(args) -> Tuple[List[str], Optional[List[str]]]:
    """`--augment_on_device`'s split (`cpc2_tpu/train.py:545-621`): the
    types with a device version run on the device, the rest on the host.
    The chain runs host types first, then device types, so a device type
    listed before a host type raises ValueError rather than train on
    another order than the one listed. Returns (device types, host
    types): no device types and `--augment_type` as it is without
    `--augment_on_device`."""
    if not (args.augment_on_device and (args.augment_past
                                        or args.augment_future)):
        return [], args.augment_type
    # 'none' entries are no-ops: dropped before the split, they neither
    # trip the order check nor reach the host factory
    types = [canonical_augment_type(t) for t in args.augment_type or []
             if t != 'none']
    on_device = [t in augment_device.DEVICE_AUGMENTATIONS for t in types]
    dev_types = [t for t, d in zip(types, on_device) if d]
    host_types = [t for t, d in zip(types, on_device) if not d]
    dev_pos = [i for i, d in enumerate(on_device) if d]
    host_pos = [i for i, d in enumerate(on_device) if not d]
    if dev_pos and host_pos and min(dev_pos) < max(host_pos):
        raise ValueError(
            "--augment_on_device runs the chain as host types first, "
            f"then device types ({host_types} -> {dev_types}), which would "
            f"silently reorder the composition you listed ({types}; the "
            "reference applies --augment_type in order). List the "
            "host-only types first, or drop --augment_on_device.")
    if dev_types:
        print("Augmentations run ON DEVICE: %s" % dev_types)
        if host_types:
            print("Augmentations kept ON HOST (no device port): %s"
                  % host_types)
    return dev_types, host_types


def _device_augment(args, dev_types: List[str], noise_dataset
                    ) -> Optional[Tuple]:
    """The trainer's `device_augment` for the device types, or None."""
    chain = augment_device.make_device_augment(
        dev_types, shift_max=int(args.shift_max),
        bandreject_scaler=args.bandreject_scaler, t_ms=args.t_ms,
        noise_dataset=noise_dataset, snr_min=args.min_snr_in_db,
        snr_max=args.max_snr_in_db, batch_size=args.batchSizeGPU,
        ir_paths=args.pathImpulseResponses,
        ir_prob=args.impulse_response_prob, ir_batch_wise=args.ir_batch_wise,
        noise_sampling=("temporalsamespeaker"
                        if args.temporal_additive_noise else "uniform"),
        pitch_algo=args.pitch_algo)
    if chain is None:
        return None
    return (chain, args.augment_past, args.augment_future,
            args.past_equal_future)


def _train(args, logs: Dict, load_optimizer: bool,
           built_from: Optional[List[str]], device: torch.device,
           dp: Optional[DataParallel] = None) -> Dict:
    """The run on `device`; under ranks (`dp`) as one of them: every rank
    builds the same model from the seed and takes rank 0's weights, draws
    its negatives and dropout from a generator of its own (`rank_seed`),
    loads the one loader's global batch and takes its rows, or with
    `dp.pod` loads its share of the files (`filter_distributed`) after the
    ranks checked their loaders' lengths, and only rank 0 writes the
    checkpoints and logs."""
    rank = 0 if dp is None else dp.rank
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
    shard = None
    if dp is not None and dp.pod:
        shard = functools.partial(filter_distributed, rank=rank,
                                  world=dp.world)
        print(f'Initial worker files: {len(seq_train)} train, '
              f'{len(seq_val)} val')
        seq_train, seq_val = shard(seq_train), shard(seq_val)
        print(f'Current worker files: {len(seq_train)} train, '
              f'{len(seq_val)} val')
    phone_labels, n_phones = None, None
    if args.supervised and args.pathPhone is not None:
        print("Loading the phone labels at " + args.pathPhone)
        phone_labels, n_phones = parse_seq_labels(args.pathPhone)
        print(f"{n_phones} phones found")

    dev_types, host_types = _split_types(args)
    # the host augmenters' generators, reseeded at every epoch
    generators = {"rng": np.random.RandomState(args.random_seed),
                  "choice_rng": random.Random(args.random_seed)}
    noise_dataset = _noise_dataset(args, generators, shard)
    device_augment = _device_augment(args, dev_types, noise_dataset)
    use_host_aug = device_augment is None or bool(host_types)
    if args.corpus_on_device:
        host_aug_active = any(t != 'none' for t in (host_types or []))
        if (args.augment_past or args.augment_future) and use_host_aug \
                and host_aug_active:
            raise ValueError(
                "--corpus_on_device needs clean host windows, but "
                f"host-side augmentations are active ({host_types}). "
                "Use --augment_on_device with device-ported types, or "
                "drop --corpus_on_device.")
    train_augment = None
    if use_host_aug:
        train_augment = augmentation_factory(
            argparse.Namespace(**dict(vars(args), augment_type=host_types)),
            noise_dataset, batch_size=args.batchSizeGPU, **generators)

    print(f'\nLoading audio data at {args.pathDB}')
    quality = dict(signal_quality_path=args.signal_quality_path,
                   signal_quality_step=args.signal_quality_step,
                   signal_quality_mode=args.signal_quality_mode)
    train_dataset = AudioBatchData(
        args.pathDB, args.sizeWindow, seq_train, phone_labels, len(speakers),
        nProcessLoader=args.n_process_loader,
        MAX_SIZE_LOADED=args.max_size_loaded,
        keep_temporality=args.samplingType == "temporalsamespeaker",
        augment_past=args.augment_past and use_host_aug,
        augment_future=args.augment_future and use_host_aug,
        augmentation=train_augment,
        past_equal_future=args.past_equal_future and use_host_aug,
        **quality)
    val_dataset = (AudioBatchData(args.pathDB, args.sizeWindow, seq_val,
                                  phone_labels, len(speakers),
                                  nProcessLoader=args.n_process_loader,
                                  **quality)
                   if seq_val else None)

    if args.load is not None:
        model, args.hiddenGar, args.hiddenEncoder = load_model(args.load)
    else:
        model = build_model(args)
    model = model.to(device)
    criterion = get_criterion(args, len(speakers), n_phones)
    if args.load is not None and args.loadCriterion:
        load_state(criterion, load_torch_checkpoint(args.load[0])[
            "cpcCriterion"], "cpcCriterion")
    criterion = criterion.to(device)
    params = list(model.parameters()) + list(criterion.parameters())
    print(f"Model: {sum(p.numel() for p in params)} parameters on {device}")
    spd = max(args.steps_per_dispatch, 1)
    if spd > 1 and model.keeps_hidden:
        print("--steps_per_dispatch > 1 is incompatible with the "
              "sequential-sampling hidden carry; using 1")
        spd = 1
    # the fused, capturable Adam on every card run, N = 1 too: N picks how
    # steps are dispatched, never how Adam rounds
    optimizer = make_optimizer(args, params,
                               capturable=device.type == "cuda")
    generator = torch.Generator(device=device)
    generator.manual_seed(rank_seed(args.random_seed, rank))
    # the one-host ranks' short batches that every rank runs whole, and
    # the weighted rounds of ranks that load their own files
    tail_runner = pod_tails = None
    if dp is not None and not dp.pod and dp.world > 1:
        # a stream that no rank's generator draws
        tail_runner = TailRunner(device, rank_seed(args.random_seed,
                                                   dp.world))
    best_acc, best_state = -1.0, None
    if load_optimizer:
        saved = load_torch_checkpoint(args.load[0])["optimizer"]
        generator_state = _load_optimizer(
            optimizer, saved, {"criterion": criterion, "model": model},
            args.normMode)
        _restore_generators(saved, generator_state, generator, tail_runner,
                            dp)
        best_acc, best_state = _best(logs, args.load[0])
    if dp is not None:
        dp.replicate(model, criterion)
    trainer = Trainer(model, criterion, optimizer, generator,
                      keep_hidden=model.keeps_hidden,
                      device_augment=device_augment,
                      augment_generator=torch.Generator(device=device),
                      dp=dp, global_negatives=args.global_negatives)
    lr_fn = make_lr_schedule(args.learningRate, args.schedulerStep,
                             args.schedulerRamp)
    # the loader's batch: the global one on one host (each rank takes its
    # rows), the rank's own where the ranks load their own files
    batch_size = (args.batchSizeGPU if dp is not None and dp.pod
                  else max(args.nGPU, 1) * args.batchSizeGPU)
    if dp is not None and dp.pod:
        pod_tails = PodTailRunner(
            dp, batch_size, encoded_seq_len(args.sizeWindow,
                                            args.encoder_type),
            args.sizeWindow, args.cpc_mode == 'bert' or args.mask_prob > 0)
    # --corpus_on_device: one resident pack per split, kept across epochs
    corpus_train = corpus_val = None
    if args.corpus_on_device:
        corpus_train = DeviceCorpus(args.sizeWindow, device,
                                    train_dataset.max_pack_samples())
        if val_dataset is not None:
            corpus_val = DeviceCorpus(args.sizeWindow, device,
                                      val_dataset.max_pack_samples())
    multi_step = (MultiStep(trainer, spd, corpus_train) if spd > 1
                  else None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    path_checkpoint = None
    if args.pathCheckpoint is not None and rank == 0:
        os.makedirs(args.pathCheckpoint, exist_ok=True)
        path_checkpoint = os.path.join(args.pathCheckpoint, "checkpoint")
        # `load` stays what the model was built from, so that a
        # concatenated run resumed more than once builds the same model
        save_args(argparse.Namespace(**dict(vars(args), load=built_from)),
                  path_checkpoint + "_args.json")

    step_ms: List[float] = []
    step_losses: List[List[float]] = []
    wait_ms: List[float] = []
    load_ms: List[float] = []
    dispatch_ms: List[float] = []
    val_steps = 0
    start_time = time.time()
    try:
        for epoch in range(len(logs["epoch"]), args.nEpoch):
            print(f"Starting epoch {epoch}")
            trainer.set_learning_rate(lr_fn(epoch))
            # host-side draws re-keyed per epoch, as the JAX trainer does,
            # and the augmentations' with them, so that a resumed run
            # replays an uninterrupted one
            epoch_seed = (args.random_seed + 7919 * (epoch + 1)) % (2 ** 31)
            set_seed(epoch_seed)
            for gen in generators.values():
                gen.seed(epoch_seed)
            trainer.augment_generator.manual_seed(rank_seed(epoch_seed,
                                                            rank))
            if tail_runner is not None:
                tail_runner.augment_generator.manual_seed(
                    rank_seed(epoch_seed, dp.world))
            for dataset in (noise_dataset, train_dataset):
                if dataset is not None:
                    restart(dataset.augmentation)
            train_loader = train_dataset.getDataLoader(
                batch_size, args.samplingType, True,
                remove_artefacts=args.no_artefacts,
                batch_size_per_gpu=args.batchSizeGPU,
                yield_indices=args.corpus_on_device)
            val_loader = (val_dataset.getDataLoader(
                batch_size, 'sequential', False,
                yield_indices=args.corpus_on_device)
                if val_dataset is not None else [])
            print("Training dataset %d batches, Validation dataset %d "
                  "batches, batch size %d" % (len(train_loader),
                                              len(val_loader), batch_size))
            if dp is not None and dp.pod:
                dp.check_lengths([len(train_loader), len(val_loader)],
                                 "loader lengths")
            loc_train = train_epoch(trainer, train_loader, device,
                                    args.logging_step, args.profile_dir,
                                    args.host_prefetch, corpus_train,
                                    multi_step, batch_size, args, pod_tails,
                                    tail_runner)
            step_losses += loc_train.pop("step_losses")
            step_ms += loc_train.pop("step_ms")
            wait_ms += loc_train.pop("wait_ms")
            load_ms += loc_train.pop("load_ms")
            dispatch_ms += loc_train.pop("dispatch_ms")
            if loc_train.pop("profiled"):
                args.profile_dir = None       # one trace per run
            loc_val = (val_epoch(trainer, val_loader, device, corpus_val,
                                 args, batch_size, pod_tails, tail_runner)
                       if val_dataset is not None else {})
            val_steps += loc_val.pop("val_steps", 0)
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
            if dp is not None and dp.world > 1:
                dp.check_replicas(model, criterion)
            if args.pathCheckpoint is not None and (
                    epoch % logs["saveStep"] == 0 or epoch == args.nEpoch - 1):
                states = {GENERATOR_KEY: generator.get_state()}
                if dp is not None:      # every rank joins the gather
                    states[RANK_GENERATORS_KEY] = dp.gather_states(
                        generator.get_state())
                if tail_runner is not None:
                    states[TAIL_GENERATOR_KEY] = \
                        tail_runner.generator.get_state()
                if path_checkpoint is not None:
                    save_checkpoint(model.state_dict(),
                                    criterion.state_dict(),
                                    dict(optimizer.state_dict(), **states),
                                    best_state,
                                    f"{path_checkpoint}_{epoch}.pt")
                    save_logs(logs, path_checkpoint + "_logs.json")
    finally:
        for dataset in (train_dataset, val_dataset, noise_dataset):
            if dataset is not None:
                dataset.close()

    record = {"logs": logs, "step_ms": step_ms, "wait_ms": wait_ms,
              "load_ms": load_ms, "dispatch_ms": dispatch_ms,
              "step_losses": step_losses,
              "steps_per_dispatch": spd, "val_steps": val_steps,
              "dispatch": "eager" if multi_step is None else multi_step.route,
              "param_devices": sorted({str(p.device) for p in params}),
              "ranks": 1 if dp is None else dp.world,
              "backend": None if dp is None else dp.backend}
    if multi_step is not None:
        record["graph_captures"] = multi_step.captures
    if tail_runner is not None:
        record["alone_steps"] = tail_runner.steps
    if device.type == "cuda":
        record["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    if step_ms:
        median = statistics.median(step_ms)
        audio_s = batch_size * args.sizeWindow / SAMPLE_RATE
        record["median_step_ms"] = median
        record["median_wait_ms"] = statistics.median(wait_ms)
        record["median_load_ms"] = statistics.median(load_ms)
        record["median_dispatch_ms"] = statistics.median(dispatch_ms)
        record["audio_hours_per_hour"] = audio_s / (median / 1000.0)
        # the same over the steps and the waits for their batches
        record["audio_hours_per_hour_with_waits"] = (
            audio_s * len(step_ms) / ((sum(step_ms) + sum(wait_ms)) / 1000.0))
        print(f"{len(step_ms)} training steps: median {median:.3f} ms/step, "
              f"{record['audio_hours_per_hour']:.1f} audio-hours per hour "
              f"(batch {batch_size} x {audio_s / batch_size:.2f} s) "
              f"on {device}; the loader's batch: median "
              f"{record['median_load_ms']:.3f} ms of host time, waited for "
              f"{record['median_wait_ms']:.3f} ms (--host_prefetch "
              f"{args.host_prefetch}); with the waits "
              f"{record['audio_hours_per_hour_with_waits']:.1f} audio-hours "
              f"per hour; {len(dispatch_ms)} dispatches of up to {spd} "
              f"steps ({record['dispatch']}), median "
              f"{record['median_dispatch_ms']:.3f} ms to dispatch")
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
