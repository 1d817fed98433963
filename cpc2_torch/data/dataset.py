"""In-RAM chunked audio corpus and its batch loader, a copy of
`cpc2_tpu/data/dataset.py` (reference `cpc/dataset.py:23-600`).

* packs: the sequence list is split so that each pack's total length fits
  `MAX_SIZE_LOADED`; one pack lives in RAM as one float32 array, and the
  next one is decoded on a worker thread while the current one is consumed;
* per-pack prefix sums (`speakerLabel`, `seqLabel`) give each window's
  speaker and the samplers' intervals;
* phone labels (`phoneLabelsDict`, from `corpus.parse_seq_labels`): each
  sequence is cut to its labels' length x 160 samples when its pack is
  parsed, and a window's label is its `sizeWindow // 160` phones, or its
  speaker with `doubleLabels` (the phones then come third);
* a batch is gathered with one fancy index and returned as the reference's
  `(B, 2, 1, W)` past/future views, identical without augmentation; a
  `transform` (the noise corpus's `PeakNorm`) and the host augmentation
  (`data/augmentation.py`) run on each window of the batch, the past views'
  draws before the future views';
* with `yield_indices` the loader yields each batch's window offsets and
  labels (`get_batch_meta`) instead of its audio, for `--corpus_on_device`
  (`data/device_corpus.py`), where the pack lives on the device;
* signal quality (`--signal_quality_path`, a WAV corpus): a `.pt` file
  beside each sequence's relative path (`.wav` replaced by `.pt`) holds
  its (SNR, C50) estimates every `signal_quality_step` samples, and
  `min_max.csv` their ranges; each sequence is cut to its estimates'
  length, the estimates are scaled to [0, 1] and their mean appended, and
  a batch ends with its windows' `sizeWindow // signal_quality_step`
  estimates of `signal_quality_mode`, (B, Q) float32.
"""

from __future__ import annotations

import csv
import functools
import os
import random
import time
from concurrent.futures import ThreadPoolExecutor
from copy import deepcopy
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from .audio_io import audio_info, load_audio
from .samplers import (BatchSampler, SameSpeakerSampler, SequentialSampler,
                       TemporalSameSpeakerSampler, UniformAudioSampler)


def filter_distributed(files: Sequence, rank: int, world: int) -> list:
    """Rank `rank`'s contiguous share of `files` out of `world` ranks, as
    `cpc2_tpu/train.py:531-543` shards a corpus over its hosts: the items
    from len * rank // world up to len * (rank + 1) // world."""
    start = len(files) * rank // world
    end = len(files) * (rank + 1) // world
    return list(files[start:end])


def pack_windows(data, indices: Sequence[int],
                 size_window: int) -> np.ndarray:
    """The (B, 2, 1, W) float32 windows of the flat pack `data` at
    `indices`, the past view duplicated as the future one."""
    idx = np.asarray(indices, dtype=np.int64)
    window = np.arange(size_window, dtype=np.int64)
    wave = np.asarray(data)[idx[:, None] + window[None, :]][:, None, :]
    return np.stack([wave, wave], axis=1).astype(np.float32)


def extract_length(couple) -> int:
    _speaker, loc_path = couple
    n_frames, _sr = audio_info(str(loc_path))
    return n_frames


def load_file(couple, signal_quality_path=None,
              signal_quality_step: int = 1600):
    """Decode one file: (speaker, seqName, waveform float32), and with
    `signal_quality_path` its (n, 2) estimates fourth, the waveform cut to
    n x `signal_quality_step` samples (reference `dataset.py:411-431`)."""
    speaker, full_path = couple
    seq, _sr = load_audio(str(full_path))
    seq = np.asarray(seq, dtype=np.float32)
    if signal_quality_path is None:
        return speaker, Path(full_path).stem, seq
    import torch
    sq = torch.load(signal_quality_path, weights_only=True)
    sq = np.concatenate([np.asarray(t) for t in sq], axis=1)
    return (speaker, Path(full_path).stem,
            seq[:sq.shape[0] * signal_quality_step], sq)


class PeakNorm:
    """Per-window peak normalisation (reference `dataset.py:433-438`)."""

    def __call__(self, x: np.ndarray) -> np.ndarray:
        max_val = np.abs(x).max(axis=-1, keepdims=True)
        return x / (max_val + 1e-8)


class AudioBatchData:

    def __init__(self, path, sizeWindow: int,
                 seqNames: Sequence[Tuple[int, str]],
                 phoneLabelsDict: Optional[dict], nSpeakers: int,
                 nProcessLoader: int = 10, MAX_SIZE_LOADED: int = 4000000000,
                 transform: Optional[Callable] = None,
                 augment_past: bool = False, augment_future: bool = False,
                 augmentation: Optional[Callable] = None,
                 keep_temporality: bool = True,
                 past_equal_future: bool = False,
                 signal_quality_path: Optional[str] = None,
                 signal_quality_step: int = 1600,
                 signal_quality_mode: Optional[str] = None):
        self.MAX_SIZE_LOADED = MAX_SIZE_LOADED
        self.dbPath = Path(path)
        self.sizeWindow = sizeWindow
        self.seqNames = [(s, self.dbPath / x) for s, x in seqNames]
        self.keep_temporality = keep_temporality
        self.signal_quality_path = (Path(signal_quality_path)
                                    if signal_quality_path is not None
                                    else None)
        self.signal_quality_step = signal_quality_step
        self.signal_quality_size = self.sizeWindow // self.signal_quality_step
        self.signal_quality_mode = signal_quality_mode
        if self.signal_quality_path is not None:
            self.init_min_max_signal_quality()
        self.transform = transform
        self.augment_past = augment_past
        self.augment_future = augment_future
        self.augmentation = augmentation
        self.past_equal_future = past_equal_future
        if self.past_equal_future and not self.augment_past:
            raise ValueError(
                "Can only apply the same transformation on past and future "
                "sequences, when past sequence is augmented. Here "
                "--augment_past = False")
        self.doubleLabels = False
        self.reload_pool = ThreadPoolExecutor(max_workers=max(
            1, nProcessLoader))
        self.prepare()
        self.speakers = list(range(nSpeakers))
        self.data = np.zeros(0, dtype=np.float32)
        self.data_quality = np.zeros((0, 3), dtype=np.float32)
        self.phoneSize = 0 if phoneLabelsDict is None else \
            phoneLabelsDict["step"]
        self.phoneStep = 0 if phoneLabelsDict is None else \
            self.sizeWindow // self.phoneSize
        self.phoneLabelsDict = deepcopy(phoneLabelsDict)
        self.loadNextPack(first=True)
        self.loadNextPack()

    def close(self) -> None:
        """Stop the decoding thread pool."""
        self.reload_pool.shutdown(wait=True)

    # ------------------------------------------------------------------
    # Pack management
    # ------------------------------------------------------------------

    def init_min_max_signal_quality(self):
        """The estimates' ranges, from `min_max.csv` in the quality
        directory (keys min_snr, max_snr, min_c50, max_c50)."""
        file_path = self.signal_quality_path / 'min_max.csv'
        if not file_path.is_file():
            raise FileNotFoundError(
                'Can not find file containing min/max values of snr and c50 '
                'under: %s' % file_path)
        with open(file_path, 'r') as fin:
            reader = csv.reader(fin)
            data = dict(zip(next(reader), next(reader)))
        try:
            self.min_snr = float(data['min_snr'])
            self.max_snr = float(data['max_snr'])
            self.min_c50 = float(data['min_c50'])
            self.max_c50 = float(data['max_c50'])
        except Exception:
            raise ValueError(
                "min_max.csv should contain the following keys: min_snr, "
                "max_snr, min_c50, max_c50.")

    def resetPhoneLabels(self, newPhoneLabels, step):
        self.phoneSize = step
        self.phoneStep = self.sizeWindow // self.phoneSize
        self.phoneLabelsDict = deepcopy(newPhoneLabels)
        self.loadNextPack()

    def clear(self):
        self.data = np.zeros(0, dtype=np.float32)
        self.speakerLabel = [0]
        self.seqLabel = [0]
        self.phoneLabels = []

    def prepare(self):
        if self.keep_temporality:
            # Shuffle whole same-session blocks, preserving temporal order
            # inside each block (reference `dataset.py:149-160`).
            blocks = []
            curr = None
            for seq_id, seq_path in self.seqNames:
                if curr != seq_id:
                    blocks.append([(seq_id, seq_path)])
                    curr = seq_id
                else:
                    blocks[-1].append((seq_id, seq_path))
            random.shuffle(blocks)
            self.seqNames = [item for b in blocks for item in b]
        else:
            random.shuffle(self.seqNames)

        if self.signal_quality_path is not None:
            self.signal_quality_names = [
                self.signal_quality_path /
                os.path.relpath(x, self.dbPath).replace('.wav', '.pt')
                for s, x in self.seqNames]

        start_time = time.time()
        print("Checking length...")
        all_length = list(self.reload_pool.map(extract_length, self.seqNames))

        self.seqLengths = all_length
        self.packageIndex, self.totSize = [], 0
        start, package_size = 0, 0
        for index, length in enumerate(all_length):
            package_size += length
            if package_size > self.MAX_SIZE_LOADED:
                self.packageIndex.append([start, index])
                self.totSize += package_size
                start, package_size = index, 0
        if package_size > 0:
            self.packageIndex.append([start, len(self.seqNames)])
            self.totSize += package_size

        print(f'Scanned {len(self.seqNames)} sequences '
              f'in {time.time() - start_time:.2f} seconds')
        print(f"{len(self.packageIndex)} chunks computed")
        self.currentPack = -1
        self.nextPack = 0
        self._future = None

    def max_pack_samples(self) -> int:
        """The largest pack's total sample count, from the scanned lengths
        without loading any pack: what `DeviceCorpus` sizes its slab by."""
        return max(sum(self.seqLengths[a:b]) for a, b in self.packageIndex)

    def loadNextPack(self, first: bool = False):
        self.clear()
        if not first:
            self.currentPack = self.nextPack
            start_time = time.time()
            self.nextData = self._future.result()
            print(f'Joined process, elapsed={time.time()-start_time:.3f} '
                  f'secs')
            self.parseNextDataBlock()
            del self.nextData

        self.nextPack = (self.currentPack + 1) % len(self.packageIndex)
        seq_start, seq_end = self.packageIndex[self.nextPack]
        if self.nextPack == 0 and len(self.packageIndex) > 1:
            self.prepare()
            seq_start, seq_end = self.packageIndex[self.nextPack]
        if self.signal_quality_path is not None:
            loader = functools.partial(
                load_file, signal_quality_step=self.signal_quality_step)
            pairs = list(zip(self.seqNames[seq_start:seq_end],
                             self.signal_quality_names[seq_start:seq_end]))
            self._future = self.reload_pool.submit(
                lambda: [loader(*pair) for pair in pairs])
        else:
            items = self.seqNames[seq_start:seq_end]
            self._future = self.reload_pool.submit(
                lambda: list(map(load_file, items)))

    def parseNextDataBlock(self):
        self.speakerLabel = [0]
        self.seqLabel = [0]
        self.phoneLabels = []
        speaker_size = 0
        index_speaker = 0

        self.nextData.sort(key=lambda x: (x[0], x[1]))
        tmp_data, tmp_quality = [], []
        for speaker, seq_name, seq, *signal_quality in self.nextData:
            while self.speakers[index_speaker] < speaker:
                index_speaker += 1
                self.speakerLabel.append(speaker_size)
            if self.speakers[index_speaker] != speaker:
                raise ValueError(f'{speaker} invalid speaker')
            if self.phoneLabelsDict is not None:
                self.phoneLabels += self.phoneLabelsDict[seq_name]
                seq = seq[:len(self.phoneLabelsDict[seq_name])
                          * self.phoneSize]
            tmp_data.append(seq)
            if signal_quality:
                tmp_quality.append(signal_quality[0])
            self.seqLabel.append(self.seqLabel[-1] + seq.shape[0])
            speaker_size += seq.shape[0]

        self.speakerLabel.append(speaker_size)
        self.data = (np.concatenate(tmp_data, axis=0) if tmp_data
                     else np.zeros(0, np.float32))
        if tmp_quality:
            q = np.concatenate(tmp_quality, axis=0).astype(np.float32)
            q[:, 0] = (q[:, 0] - self.min_snr) / (self.max_snr - self.min_snr)
            q[:, 1] = (q[:, 1] - self.min_c50) / (self.max_c50 - self.min_c50)
            self.data_quality = np.concatenate(
                [q, q.mean(axis=1, keepdims=True)], axis=1)
        self._speaker_label_arr = np.asarray(self.speakerLabel)
        self._phone_label_arr = (np.asarray(self.phoneLabels, dtype=np.int64)
                                 if self.phoneLabels else None)

    # ------------------------------------------------------------------
    # Batch access
    # ------------------------------------------------------------------

    def getPhonem(self, idx: int):
        id_phone = idx // self.phoneSize
        return self.phoneLabels[id_phone:(id_phone + self.phoneStep)]

    def getSignalQuality(self, idx: int) -> np.ndarray:
        """The `signal_quality_mode` estimates of the window at `idx`."""
        i = idx // self.signal_quality_step
        est = self.data_quality[i:i + self.signal_quality_size]
        col = {'snr': 0, 'c50': 1, 'snr_c50': 2}.get(self.signal_quality_mode)
        if col is None:
            raise ValueError(
                "--signal_quality_mode should be in "
                "['snr', 'c50', 'snr_c50'].")
        return est[:, col]

    def __len__(self):
        return self.totSize // self.sizeWindow

    def get_batch(self, indices: Sequence[int]):
        """(batch (B, 2, 1, W) float32, labels int64) for the windows
        starting at `indices`: the past and future views of each window,
        after the transform, each augmented as the flags say (the past views
        first, window by window, then the future ones). The labels are the
        speakers (B,), or with phone labels the phones (B, W // 160); with
        `doubleLabels` the speakers, and the phones third. With signal
        quality, the windows' estimates (B, W // signal_quality_step)
        last."""
        idx = np.asarray(indices, dtype=np.int64)
        window = np.arange(self.sizeWindow, dtype=np.int64)
        wave = self.data[idx[:, None] + window[None, :]][:, None, :]
        speaker, phone = self._labels(idx)
        if self.transform is not None:
            wave = np.stack([self.transform(w) for w in wave])
        past, future = wave, wave
        if self.augment_past and self.augmentation:
            past = np.stack([self.augmentation(w) for w in wave])
        if (not self.past_equal_future and self.augment_future
                and self.augmentation):
            future = np.stack([self.augmentation(w) for w in wave])
        if self.past_equal_future:
            future = past
        out = np.stack([past, future], axis=1)
        return (out,) + self._meta(speaker, phone, idx)

    def _labels(self, idx: np.ndarray):
        """The speakers (B,) of the windows starting at `idx`, and their
        phones (B, W // 160) where the corpus has phone labels (else None)."""
        speaker = (np.searchsorted(self._speaker_label_arr, idx,
                                   side='right') - 1).astype(np.int64)
        phone = None
        if self.phoneSize > 0:
            steps = np.arange(self.phoneStep, dtype=np.int64)
            phone = self._phone_label_arr[(idx // self.phoneSize)[:, None]
                                          + steps[None, :]]
        return speaker, phone

    def _meta(self, speaker, phone, idx: np.ndarray) -> tuple:
        if phone is None:
            meta = (speaker,)
        elif self.doubleLabels:
            meta = (speaker, phone)
        else:
            meta = (phone,)
        if self.signal_quality_path is not None:
            meta += (np.stack([self.getSignalQuality(int(i)) for i in idx]),)
        return meta

    def get_batch_meta(self, indices: Sequence[int]) -> tuple:
        """`get_batch(indices)[1:]` without gathering the windows: the
        labels that cross from the host under `--corpus_on_device`, where
        the audio is resident on the device."""
        idx = np.asarray(indices, dtype=np.int64)
        return self._meta(*self._labels(idx), idx)

    def gather_windows(self, indices: Sequence[int]) -> np.ndarray:
        """The clean (B, 2, 1, W) float32 windows at `indices`, the past
        view duplicated as the future one, without transform or
        augmentation: what `DeviceCorpus.put` gathers on the device. Raises
        for a corpus that transforms or augments its windows on the host."""
        if self.transform is not None or (
                self.augmentation is not None
                and (self.augment_past or self.augment_future)):
            raise ValueError("gather_windows is for clean (untransformed, "
                             "unaugmented-on-host) corpora only")
        return pack_windows(self.data, indices, self.sizeWindow)

    def getBaseSampler(self, type: str, batchSize: int, offset: int,
                       batchSizePerGPU: Optional[int] = None):
        if type == "samespeaker":
            return SameSpeakerSampler(batchSize, self.speakerLabel,
                                      self.sizeWindow, offset)
        if type == "samesequence":
            return SameSpeakerSampler(batchSize, self.seqLabel,
                                      self.sizeWindow, offset)
        if type == "temporalsamespeaker":
            return TemporalSameSpeakerSampler(
                batchSize, self.speakerLabel, self.sizeWindow, offset,
                batch_size_per_gpu=batchSizePerGPU)
        if type == "sequential":
            return SequentialSampler(len(self.data), self.sizeWindow,
                                     offset, batchSize)
        if type == "uniform":
            sampler = UniformAudioSampler(len(self.data), self.sizeWindow,
                                          offset)
            return BatchSampler(sampler, batchSize, True)
        raise ValueError("--samplingType should belong to %s" %
                         ["samespeaker", "samesequence",
                          "temporalsamespeaker", "sequential", "uniform"])

    def getDataLoader(self, batchSize: int, type: str, randomOffset: bool,
                      remove_artefacts: bool = False,
                      batch_size_per_gpu: Optional[int] = None,
                      yield_indices: bool = False):
        """Iterator over the batches of one epoch
        (reference `dataset.py:366-408`); with `yield_indices`, over
        `(offsets, *get_batch_meta(offsets))` instead."""
        tot_size = self.totSize // (self.sizeWindow * batchSize)

        def sampler_call():
            if randomOffset:
                if type == "temporalsamespeaker":
                    offset = random.randint(0, self.sizeWindow * batchSize)
                else:
                    offset = random.randint(0, self.sizeWindow // 2)
            else:
                offset = 0
            return self.getBaseSampler(type, batchSize, offset,
                                       batch_size_per_gpu)

        return AudioLoader(self, sampler_call, len(self.packageIndex),
                           self.loadNextPack, tot_size, remove_artefacts,
                           yield_indices=yield_indices)


class AudioLoader:
    """Loops over packs, yielding `get_batch` results, or with
    `yield_indices` each batch's `(offsets, *get_batch_meta(offsets))`
    (reference `dataset.py:440-600`)."""

    def __init__(self, dataset: AudioBatchData, samplerCall: Callable,
                 nLoop: int, updateCall: Callable, size: int,
                 remove_artefacts: bool = False,
                 yield_indices: bool = False):
        self.samplerCall = samplerCall
        self.updateCall = updateCall
        self.nLoop = nLoop
        self.size = size
        self.dataset = dataset
        self.remove_artefacts = remove_artefacts
        self.yield_indices = yield_indices

    def __len__(self):
        return self.size

    def _remove_artefacts(self, sampler):
        """Shift/drop windows straddling recording boundaries
        (reference `dataset.py:486-526`, bug for bug: only the last
        sequence's out-of-bounds status decides whether a batch is
        deleted)."""
        seq_labels = self.dataset.seqLabel
        window_size = self.dataset.sizeWindow
        new_batches = []
        for batch in sampler.batches:
            new_batch = []
            offset = 0
            delete_batch = False
            for beg_seq in batch:
                beg_seq += offset
                delete_batch = False
                for i in range(1, len(seq_labels)):
                    if seq_labels[i - 1] <= beg_seq < seq_labels[i]:
                        if beg_seq + window_size > seq_labels[i]:
                            if i != len(seq_labels) - 1:
                                new_batch.append(seq_labels[i])
                            else:
                                print("warning, deleting batch because "
                                      "artifact cannot be removed without "
                                      "going out of bounds")
                                delete_batch = True
                            if isinstance(sampler,
                                          TemporalSameSpeakerSampler):
                                offset += seq_labels[i] - beg_seq
                        else:
                            new_batch.append(beg_seq)
            if not delete_batch:
                new_batches.append(new_batch)
        sampler.batches = new_batches
        return sampler

    def _iter_pack(self):
        sampler = self.samplerCall()
        if self.remove_artefacts:
            sampler = self._remove_artefacts(sampler)
        for batch_idx in sampler:
            if len(batch_idx) == 0:
                continue
            if self.yield_indices:
                yield ((np.asarray(batch_idx, dtype=np.int64),)
                       + self.dataset.get_batch_meta(batch_idx))
            else:
                yield self.dataset.get_batch(batch_idx)

    def __iter__(self):
        for i in range(self.nLoop):
            yield from self._iter_pack()
            if i < self.nLoop - 1:
                self.updateCall()
