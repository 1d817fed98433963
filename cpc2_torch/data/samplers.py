"""Batch samplers, a copy of `cpc2_tpu/data/samplers.py` (reference
`cpc/dataset.py:603-757`).

Host-side index generation; identical batching semantics to the reference:

* `UniformAudioSampler` — random non-overlapping windows over the pack;
* `SequentialSampler`   — strided parallel streams (window b of batch i is
  contiguous with window b of batch i+1), used for validation and for
  stateful-RNN training;
* `SameSpeakerSampler`  — batches drawn within one speaker (or sequence)
  interval;
* `TemporalSameSpeakerSampler` — contiguous same-speaker blocks of
  `batchSize*sizeWindow` samples, preserving temporal order inside a batch.

Randomness comes from the global `random`/`np.random` state, seeded by
`--random_seed` (`cpc2_torch.train`) — mirroring the reference's use of
the global torch RNG.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

import numpy as np


class BatchSampler:
    """Group a flat index sampler into fixed batches (drop_last=True)."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = True):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size


class UniformAudioSampler:
    """`dataset.py:603-622`."""

    def __init__(self, data_size: int, size_window: int, offset: int):
        self.len = data_size // size_window
        self.size_window = size_window
        self.offset = offset
        if self.offset > 0:
            self.len -= 1

    def __iter__(self):
        perm = np.random.permutation(self.len)
        return iter((self.offset + self.size_window * perm).tolist())

    def __len__(self):
        return self.len


class SequentialSampler:
    """`dataset.py:625-645`."""

    def __init__(self, data_size: int, size_window: int, offset: int,
                 batch_size: int):
        self.len = (data_size // size_window) // batch_size
        self.size_window = size_window
        self.offset = offset
        self.start_batches = [x * (data_size // batch_size)
                              for x in range(batch_size)]
        self.batch_size = batch_size
        if self.offset > 0:
            self.len -= 1

    def __iter__(self):
        for idx in range(self.len):
            yield [self.offset + self.size_window * idx + start
                   for start in self.start_batches]

    def __len__(self):
        return self.len


class SameSpeakerSampler:
    """`dataset.py:709-757`."""

    def __init__(self, batch_size: int, sampling_intervals: Sequence[int],
                 size_window: int, offset: int):
        self.sampling_intervals = sampling_intervals
        self.size_window = size_window
        self.batch_size = batch_size
        self.offset = offset

        if self.sampling_intervals[0] != 0:
            raise AttributeError("Sampling intervals should start at zero")

        n_windows = len(self.sampling_intervals) - 1
        self.size_samplers = [
            (self.sampling_intervals[i + 1] - self.sampling_intervals[i])
            // self.size_window for i in range(n_windows)]
        if self.offset > 0:
            self.size_samplers = [max(0, x - 1) for x in self.size_samplers]
        self.build_batches()

    def __len__(self):
        return len(self.batches)

    def get_index(self, x: int, i_interval: int) -> int:
        return (self.offset + x * self.size_window
                + self.sampling_intervals[i_interval])

    def __iter__(self):
        random.shuffle(self.batches)
        return iter(self.batches)

    def build_batches(self):
        order = [(x, np.random.permutation(val).tolist())
                 for x, val in enumerate(self.size_samplers) if val > 0]
        self.batches: List[List[int]] = []
        for index_sampler, randperm in order:
            index_start, size_sampler = 0, len(randperm)
            while index_start < size_sampler:
                index_end = min(size_sampler, index_start + self.batch_size)
                loc_batch = [self.get_index(x, index_sampler)
                             for x in randperm[index_start:index_end]]
                index_start = index_end
                self.batches.append(loc_batch)


class TemporalSameSpeakerSampler:
    """`dataset.py:648-707`: one batch = `batchSize` *consecutive* windows of
    the same speaker, preserving temporal order."""

    def __init__(self, batch_size: int, sampling_intervals: Sequence[int],
                 size_window: int, offset: int,
                 batch_size_per_gpu: Optional[int] = None):
        self.sampling_intervals = sampling_intervals
        self.size_window = size_window
        self.batch_size = batch_size
        self.offset = offset
        self.batch_size_per_gpu = batch_size_per_gpu

        if self.sampling_intervals[0] != 0:
            raise AttributeError("Sampling intervals should start at zero")

        n_windows = len(self.sampling_intervals) - 1
        self.size_samplers = [
            (self.sampling_intervals[i + 1] - self.sampling_intervals[i])
            // (self.size_window * self.batch_size)
            for i in range(n_windows)]
        if self.offset > 0:
            self.size_samplers = [max(0, x - 1) for x in self.size_samplers]
        if sum(self.size_samplers) == 0:
            raise ValueError(
                "No sampling intervals can be found. Try to increase "
                "--max_size_loaded or to reduce the batch size.")
        self.build_batches()

    def __len__(self):
        return len(self.batches)

    def get_indices(self, x: int, i_interval: int):
        beg = (self.offset + x * self.size_window * self.batch_size
               + self.sampling_intervals[i_interval])
        return range(beg, beg + self.size_window * self.batch_size,
                     self.size_window)

    def __iter__(self):
        random.shuffle(self.batches)
        return iter(self.batches)

    def build_batches(self):
        order = [(x, np.random.permutation(val).tolist())
                 for x, val in enumerate(self.size_samplers) if val > 0]
        self.batches = []
        for index_sampler, randperm in order:
            index_start, size_sampler = 0, len(randperm)
            while index_start < size_sampler:
                index_end = min(size_sampler, index_start + self.batch_size)
                for x in randperm[index_start:index_end]:
                    self.batches.append(
                        list(self.get_indices(x, index_sampler)))
                index_start = index_end
