"""Ragged batches under ranks (counterpart of `cpc2_tpu/train_tails.py`).

The reference trains on every batch, whatever its size
(`cpc/train.py:145-187`). Under ranks a batch shorter than the global one
runs by one of two routes:

* `TailRunner`, one host (`--nGPU N`): every rank sees the same loader,
  so a short batch that N divides is split over the ranks like a full one,
  and one that N does not divide runs whole on every rank, at its natural
  size with its pool over the whole tail, from generators (negatives and
  dropout, device augmentation) that every rank holds in the same state.
  Every rank takes the same step, and its reductions still run, so the
  ranks stay one replica even where two cards' results differ (the JAX
  package runs it on one device and copies the state back).
* `PodTailRunner`, ranks that load their own files (`--distributed`):
  each rank buffers its short batches, and at the epoch's end the ranks
  agree on the most any of them buffered (one `all_reduce`) and run that
  many example-weighted steps (`training.Trainer.train_step(...,
  example_weights=)`): each rank pads its i-th short batch to the full
  local batch by repeating its rows cyclically, with weight 1 on the real
  rows and 0 on the copies, and a rank out of short batches sends a
  filler of weight 0 (its last buffered batch again, else zeros). The
  update is the exact mean over the real examples of every rank.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch

from .parallel import DataParallel

Tensor = torch.Tensor


def route(n: int, full: int, dp: Optional[DataParallel]) -> str:
    """How a batch of n rows runs when `full` is the loader's full batch:
    `whole` (no ranks, or ranks that load their own files and a full
    batch), `rows` (split over the ranks), `alone` (whole on every rank,
    `TailRunner`) or `tail` (buffered for `PodTailRunner`)."""
    if dp is None:
        return "whole"
    if dp.pod:
        return "whole" if n == full else "tail"
    return "rows" if n % dp.world == 0 else "alone"


class TailRunner:
    """The one-host ranks' short batches that the ranks do not divide:
    `generator` draws their negatives and dropout, `augment_generator`
    their device augmentation, on every rank alike (each starts from the
    same seed on every rank, `generator` from `seed`, and only such steps
    draw from them). `steps` counts the training steps run."""

    def __init__(self, device: torch.device, seed: int):
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)
        self.augment_generator = torch.Generator(device=device)
        self.augment_generator.manual_seed(seed)
        self.steps = 0

    def train(self, trainer, *args, **kwargs) -> Tuple[Tensor, Tensor]:
        self.steps += 1
        with trainer.alone(self.generator, self.augment_generator):
            return trainer.train_step(*args, **kwargs)

    def val(self, trainer, *args, **kwargs) -> Tuple[Tensor, Tensor]:
        with trainer.alone(self.generator, self.augment_generator):
            return trainer.val_step(*args, **kwargs)


class PodTailRunner:
    """The short batches of ranks that load their own files, run as
    example-weighted steps at the epoch's end. Items are `(x (t, 2, 1, W),
    label, quality, mask)` host arrays or tensors, `mask` (2t, S) with the
    past view's rows first; `local_batch` is the full batch of a rank and
    `frames` the encodings' length."""

    def __init__(self, dp: DataParallel, local_batch: int, frames: int,
                 size_window: int, uses_mask: bool):
        self.dp = dp
        self.local_batch = int(local_batch)
        self.frames = frames
        self.size_window = size_window
        self.uses_mask = uses_mask
        self.items: List[tuple] = []

    def add(self, item) -> None:
        self.items.append(tuple(None if t is None else torch.as_tensor(t)
                                for t in item))

    def padded(self, item) -> tuple:
        """`item` padded to the local batch by cyclic repeat of its rows,
        and its (B,) 0/1 weights."""
        x, label, quality, mask = item
        t, b = x.shape[0], self.local_batch
        idx = torch.arange(b) % t
        valid = (torch.arange(b) < t).to(torch.float32)
        mask_p = None
        if mask is not None:
            mask_p = torch.cat([mask[:t][idx], mask[t:][idx]])
        return (x[idx], label[idx], None if quality is None
                else quality[idx], mask_p, valid)

    def filler(self, with_quality: bool) -> tuple:
        """Weight 0 everywhere: the last buffered item again (real audio
        for the BatchNorm statistics), else zeros."""
        b = self.local_batch
        if self.items:
            x, label, quality, mask, _ = self.padded(self.items[-1])
        else:
            x = torch.zeros((b, 2, 1, self.size_window))
            label = torch.zeros((b,), dtype=torch.int64)
            quality = (torch.zeros((b, self.frames)) if with_quality
                       else None)
            mask = (torch.zeros((2 * b, self.frames), dtype=torch.bool)
                    if self.uses_mask else None)
        return (x, label, quality if with_quality else None, mask,
                torch.zeros((b,)))

    def rounds(self, with_quality: bool):
        """The padded items, then fillers up to the ranks' agreed count.
        Every rank calls it at the same point, even with nothing
        buffered."""
        n = self.dp.host_values([len(self.items)], "max")[0]
        for i in range(n):
            yield (self.padded(self.items[i]) if i < len(self.items)
                   else self.filler(with_quality))
        self.items = []

    def _run(self, step, with_quality: bool) -> Iterator[tuple]:
        device = self.dp.device
        for x, label, quality, mask, valid in self.rounds(with_quality):
            losses, accs = step(
                x.to(device, torch.float32), label=label.to(device),
                quality=None if quality is None else quality.to(device),
                mask=None if mask is None else mask.to(device),
                example_weights=valid.to(device))
            yield int(valid.sum()), losses, accs

    def run_train(self, trainer, with_quality: bool) -> Iterator[tuple]:
        """(real local rows, losses, accs), one weighted training step a
        round, each yielded as soon as its step returns (the caller times
        the rounds apart)."""
        return self._run(trainer.train_step, with_quality)

    def run_val(self, trainer, with_quality: bool) -> Iterator[tuple]:
        """The same for validation."""
        return self._run(trainer.val_step, with_quality)
