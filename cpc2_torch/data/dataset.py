"""In-RAM chunked audio corpus and its batch loader, a copy of
`cpc2_tpu/data/dataset.py` (reference `cpc/dataset.py:23-600`) without the
features the port does not have yet: host-side augmentation, phone labels
and signal-quality weights (ROADMAP.md items: Augmentation, Other model and
criterion modes).

* packs: the sequence list is split so that each pack's total length fits
  `MAX_SIZE_LOADED`; one pack lives in RAM as one float32 array, and the
  next one is decoded on a worker thread while the current one is consumed;
* per-pack prefix sums (`speakerLabel`, `seqLabel`) give each window's
  speaker and the samplers' intervals;
* a batch is gathered with one fancy index and returned as the reference's
  `(B, 2, 1, W)` past/future views, identical without augmentation.
"""

from __future__ import annotations

import random
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from .audio_io import audio_info, load_audio
from .samplers import (BatchSampler, SameSpeakerSampler, SequentialSampler,
                       TemporalSameSpeakerSampler, UniformAudioSampler)


def extract_length(couple) -> int:
    _speaker, loc_path = couple
    n_frames, _sr = audio_info(str(loc_path))
    return n_frames


def load_file(couple):
    """Decode one file: (speaker, seqName, waveform float32)."""
    speaker, full_path = couple
    seq, _sr = load_audio(str(full_path))
    return speaker, Path(full_path).stem, np.asarray(seq, dtype=np.float32)


class AudioBatchData:

    def __init__(self, path, sizeWindow: int,
                 seqNames: Sequence[Tuple[int, str]], nSpeakers: int,
                 nProcessLoader: int = 10, MAX_SIZE_LOADED: int = 4000000000,
                 keep_temporality: bool = True):
        self.MAX_SIZE_LOADED = MAX_SIZE_LOADED
        self.dbPath = Path(path)
        self.sizeWindow = sizeWindow
        self.seqNames = [(s, self.dbPath / x) for s, x in seqNames]
        self.reload_pool = ThreadPoolExecutor(max_workers=max(
            1, nProcessLoader))
        self.keep_temporality = keep_temporality
        self.prepare()
        self.speakers = list(range(nSpeakers))
        self.data = np.zeros(0, dtype=np.float32)
        self.loadNextPack(first=True)
        self.loadNextPack()

    def close(self) -> None:
        """Stop the decoding thread pool."""
        self.reload_pool.shutdown(wait=True)

    # ------------------------------------------------------------------
    # Pack management
    # ------------------------------------------------------------------

    def clear(self):
        self.data = np.zeros(0, dtype=np.float32)
        self.speakerLabel = [0]
        self.seqLabel = [0]

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

        start_time = time.time()
        print("Checking length...")
        all_length = list(self.reload_pool.map(extract_length, self.seqNames))

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
        items = self.seqNames[seq_start:seq_end]
        self._future = self.reload_pool.submit(
            lambda: list(map(load_file, items)))

    def parseNextDataBlock(self):
        self.speakerLabel = [0]
        self.seqLabel = [0]
        speaker_size = 0
        index_speaker = 0

        self.nextData.sort(key=lambda x: (x[0], x[1]))
        tmp_data = []
        for speaker, _seq_name, seq in self.nextData:
            while self.speakers[index_speaker] < speaker:
                index_speaker += 1
                self.speakerLabel.append(speaker_size)
            if self.speakers[index_speaker] != speaker:
                raise ValueError(f'{speaker} invalid speaker')
            tmp_data.append(seq)
            self.seqLabel.append(self.seqLabel[-1] + seq.shape[0])
            speaker_size += seq.shape[0]

        self.speakerLabel.append(speaker_size)
        self.data = (np.concatenate(tmp_data, axis=0) if tmp_data
                     else np.zeros(0, np.float32))
        self._speaker_label_arr = np.asarray(self.speakerLabel)

    # ------------------------------------------------------------------
    # Batch access
    # ------------------------------------------------------------------

    def __len__(self):
        return self.totSize // self.sizeWindow

    def get_batch(self, indices: Sequence[int]):
        """(batch (B, 2, 1, W) float32, speaker labels (B,) int64) for the
        windows starting at `indices`; past and future views are the same
        window."""
        idx = np.asarray(indices, dtype=np.int64)
        window = np.arange(self.sizeWindow, dtype=np.int64)
        wave = self.data[idx[:, None] + window[None, :]][:, None, :]
        speaker = (np.searchsorted(self._speaker_label_arr, idx,
                                   side='right') - 1).astype(np.int64)
        return np.stack([wave, wave], axis=1), speaker

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
                      batch_size_per_gpu: Optional[int] = None):
        """Iterator over the batches of one epoch
        (reference `dataset.py:366-408`)."""
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
                           self.loadNextPack, tot_size, remove_artefacts)


class AudioLoader:
    """Loops over packs, yielding `get_batch` results
    (reference `dataset.py:440-600`)."""

    def __init__(self, dataset: AudioBatchData, samplerCall: Callable,
                 nLoop: int, updateCall: Callable, size: int,
                 remove_artefacts: bool = False):
        self.samplerCall = samplerCall
        self.updateCall = updateCall
        self.nLoop = nLoop
        self.size = size
        self.dataset = dataset
        self.remove_artefacts = remove_artefacts

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
            yield self.dataset.get_batch(batch_idx)

    def __iter__(self):
        for i in range(self.nLoop):
            yield from self._iter_pack()
            if i < self.nLoop - 1:
                self.updateCall()
