"""ABX triplet construction, a copy of `cpc2_tpu/eval/abx/abx_iterators.py`
(reference `cpc/eval/ABX/abx_iterators.py`).

Host-side numpy: .item parsing, time->frame mapping, nested
context->speaker->phone grouping, and the within/across triplet iterators.
The feature maker returns numpy features per file; the interval slices
live in one flat (T, D) matrix, and groups are materialized as padded
(N, S_max, D) blocks that also record their rows' offsets in that matrix
for the batched device-side scorer (`abx_group_computation.py`).
"""

from __future__ import annotations

import math
import random
from typing import Callable, Dict, List

import numpy as np


def normalize_with_singularity(x: np.ndarray) -> np.ndarray:
    """Normalize across channels; extend by one dim so the null vector sits
    at maximal cosine distance from any non-null vector
    (reference `abx_iterators.py:11-41`).

    NOTE: the reference's 3-D branch adds 1e-12 to the norm *before* testing
    `norm_x == 0`, so its zero-vector handling never triggers — which
    contradicts the reference's own unit-test expectations
    (`ABX/unit_tests.py:58-82`). We implement the intended behaviour (zero
    detection on the raw norm), which reproduces those expectations."""
    x = np.array(x, dtype=np.float32, copy=True)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    n, s, h = x.shape
    raw_norm = (x ** 2).sum(axis=2, keepdims=True)
    null_frames = (raw_norm == 0).reshape(n, s)
    x /= np.sqrt(raw_norm + 1e-12)
    x[null_frames] = 1 / math.sqrt(h)
    extra_dim = np.full((n, s, 1), 1e-12, dtype=x.dtype)
    extra_dim[null_frames] = -2 * 1e12
    out = np.concatenate([x, extra_dim], axis=2)
    return out[0] if squeeze else out


def load_item_file(path_item_file):
    """Parse a .item triplet file (reference `abx_iterators.py:44-92`).
    Line format: `#file_ID onset offset #phone prev-phone next-phone
    speaker`. Returns per-file interval rows plus the three
    string->dense-id vocabularies (context = prev+next)."""
    def intern(vocab, token):
        if token not in vocab:
            vocab[token] = len(vocab)
        return vocab[token]

    out: Dict[str, List] = {}
    phone_match: Dict[str, int] = {}
    speaker_match: Dict[str, int] = {}
    context_match: Dict[str, int] = {}

    with open(path_item_file, 'r') as f:
        rows = [line.strip('\n') for line in f.readlines()[1:]]

    for row in rows:
        fields = row.split()
        assert len(fields) == 7
        file_id, onset, offset, phone, prev_ph, next_ph, speaker = fields
        out.setdefault(file_id, []).append([
            float(onset), float(offset),
            intern(context_match, prev_ph + '+' + next_ph),
            intern(phone_match, phone),
            intern(speaker_match, speaker)])

    return out, context_match, phone_match, speaker_match


def _split_spans(rows, sorted_idx, key, lo, hi):
    """Boundary spans [lo, hi) partitioned by rows[·][key] (rows already
    sorted): yields (span_lo, span_hi) pairs."""
    spans = []
    span_lo = lo
    for i in range(lo + 1, hi):
        if rows[sorted_idx[i]][key] != rows[sorted_idx[span_lo]][key]:
            spans.append((span_lo, i))
            span_lo = i
    spans.append((span_lo, hi))
    return spans


def get_features_group(in_data, index_order):
    """Nested grouping by the given key order
    (reference `abx_iterators.py:95-126`).

    Returns (sorted index list, nested span lists): sorting is
    lexicographic over `index_order`; the outermost list has one entry per
    distinct first key, each a list per distinct second key, ..., the
    innermost entries being (start, end) spans into the sorted order."""
    sorted_idx = sorted(range(len(in_data)),
                        key=lambda i: [in_data[i][k] for k in index_order])

    def nest(lo, hi, depth):
        spans = _split_spans(in_data, sorted_idx, index_order[depth], lo, hi)
        if depth == len(index_order) - 1:
            return spans
        return [nest(a, b, depth + 1) for a, b in spans]

    return sorted_idx, nest(0, len(in_data), 0)


class ABXFeatureLoader:
    """Extract per-phone-interval feature slices
    (reference `abx_iterators.py:129-261`)."""

    def __init__(self, path_item_file, seqList, featureMaker: Callable,
                 stepFeature: float, normalize: bool):
        files_data, self.context_match, self.phone_match, \
            self.speaker_match = load_item_file(path_item_file)
        self.seqNorm = True
        self.stepFeature = stepFeature
        self.loadFromFileData(files_data, seqList, featureMaker, normalize)

    def loadFromFileData(self, files_data, seqList, feature_maker, normalize):
        # features[i]: [index_start, size, context_id, phone_id, speaker_id]
        self.features = []
        self.INDEX_CONTEXT = 2
        self.INDEX_PHONE = 3
        self.INDEX_SPEAKER = 4
        slices = []
        cursor = 0

        print("Building the input features...")
        for file_id, file_path in seqList:
            if file_id not in files_data:
                continue
            feats = np.asarray(feature_maker(file_path))
            if feats.ndim > 2:
                feats = feats.reshape(feats.shape[1], feats.shape[2])
            for onset, offset, context_id, phone_id, speaker_id \
                    in files_data[file_id]:
                # time -> frame: round interval edges inward by half a frame
                frame_lo = max(0,
                               int(math.ceil(self.stepFeature * onset - 0.5)))
                frame_hi = min(feats.shape[0],
                               int(math.floor(self.stepFeature * offset
                                              - 0.5)))
                if frame_lo >= feats.shape[0] or frame_hi <= frame_lo:
                    continue
                n_frames = frame_hi - frame_lo
                self.features.append([cursor, n_frames, context_id,
                                      phone_id, speaker_id])
                slices.append(feats[frame_lo:frame_hi])
                cursor += n_frames
        print("...done")

        data = np.concatenate(slices, axis=0).astype(np.float32)
        if normalize:
            # row-local math, so normalizing AFTER slicing is bit-identical
            # to the reference's per-file pass — and touches only the
            # interval frames, in one vectorized call instead of one per
            # file
            data = normalize_with_singularity(data)
        self.data = data
        self.feature_dim = self.data.shape[1]

    def get_ids(self, index):
        context_id, phone_id, speaker_id = self.features[index][2:]
        return context_id, phone_id, speaker_id

    def __getitem__(self, index):
        start, size, context_id, phone_id, speaker_id = self.features[index]
        return (self.data[start:start + size], size,
                (context_id, phone_id, speaker_id))

    def __len__(self):
        return len(self.features)

    def get_n_speakers(self):
        return len(self.speaker_match)

    def get_n_context(self):
        return len(self.context_match)

    def get_n_phone(self):
        return len(self.phone_match)

    def get_iterator(self, mode, max_size_group, max_x_across=5):
        if mode == 'within':
            return ABXWithinGroupIterator(self, max_size_group)
        if mode == 'across':
            return ABXAcrossGroupIterator(self, max_size_group, max_x_across)
        raise ValueError(f"Invalid mode: {mode}")


class TokenBlock(np.ndarray):
    """A materialized group block that additionally remembers where its
    token rows live in the loader's flat feature matrix
    (`token_starts`, one offset per block row). Plain ndarray in every
    other respect; views/copies drop the attribute, which downstream
    code treats as 'no gather fast path'."""
    token_starts = None


class ABXIterator:
    """Base class building ABX triplets
    (reference `abx_iterators.py:264-312`)."""

    def __init__(self, abxDataset, max_size_group):
        self.max_size_group = max_size_group
        self.dataset = abxDataset
        self.len = 0
        self.index_csp, self.groups_csp = get_features_group(
            abxDataset.features,
            [abxDataset.INDEX_CONTEXT, abxDataset.INDEX_SPEAKER,
             abxDataset.INDEX_PHONE])

    def get_group(self, i_start, i_end):
        """Materialize span [i_start, i_end) as a zero-padded (n, S_max, D)
        block + true lengths; spans larger than max_size_group are
        subsampled uniformly at random.

        NB: like the reference (`abx_iterators.py:285`), the subsampling
        draws from the UNSEEDED global `random` module — on corpora where
        any group exceeds max_size_group (or across-mode speaker count
        exceeds max_x), ABX scores vary run to run in both frameworks.
        Seed `random` before building the iterator for reproducibility."""
        chosen = list(range(i_start, i_end))
        if len(chosen) > self.max_size_group:
            chosen = random.sample(chosen, k=self.max_size_group)
        rows = [self.dataset[self.index_csp[i]] for i in chosen]
        group_id = rows[-1][2]
        longest = max(size for _, size, _ in rows)

        block = np.zeros((len(rows), longest, self.dataset.feature_dim),
                         dtype=np.float32).view(TokenBlock)
        lengths = np.zeros(len(rows), dtype=np.int64)
        for j, (slice_, size, _) in enumerate(rows):
            block[j, :size] = slice_
            lengths[j] = size
        # Row offsets into the loader's flat (T, D) feature matrix: the
        # device scorer gathers the block from a device-resident copy of
        # that matrix instead of uploading the materialized values
        # (`get_abx_scores_dtw_on_group`). The materialized values stay
        # the source of truth for the host path.
        block.token_starts = np.asarray(
            [self.dataset.features[self.index_csp[i]][0] for i in chosen],
            dtype=np.int64)
        return block, lengths, group_id

    def __len__(self):
        return self.len

    def get_board_size(self):
        pass


class ABXWithinGroupIterator(ABXIterator):
    """Within-speaker triplets (reference `abx_iterators.py:315-364`):
    for each (context, speaker) cell with >1 phone, every ordered phone
    pair (A != B) where A has >= 2 tokens yields one symmetric A/B/X item
    (X drawn from A's own group)."""

    def __init__(self, abxDataset, max_size_group):
        super().__init__(abxDataset, max_size_group)
        self.symmetric = True
        for by_speaker in self.groups_csp:
            for phones in by_speaker:
                if len(phones) > 1:
                    for lo, hi in phones:
                        if hi - lo > 1:
                            self.len += len(phones) - 1

    def __iter__(self):
        for by_speaker in self.groups_csp:
            for phones in by_speaker:
                if len(phones) == 1:
                    continue
                for a, (lo_a, hi_a) in enumerate(phones):
                    if hi_a - lo_a == 1:
                        continue
                    for b, (lo_b, hi_b) in enumerate(phones):
                        if b == a:
                            continue
                        data_b, size_b, id_b = self.get_group(lo_b, hi_b)
                        data_a, size_a, id_a = self.get_group(lo_a, hi_a)
                        coords = id_a[2], id_a[1], id_b[1], id_a[0]
                        yield coords, (data_a, size_a), (data_b, size_b), \
                            (data_a, size_a)

    def get_board_size(self):
        return (self.dataset.get_n_speakers(), self.dataset.get_n_phone(),
                self.dataset.get_n_phone(), self.dataset.get_n_context())


class ABXAcrossGroupIterator(ABXIterator):
    """Across-speaker triplets (reference `abx_iterators.py:367-448`):
    X comes from up to `max_x_across` other speakers with the same
    (context, phone) as A."""

    def __init__(self, abxDataset, max_size_group, max_x_across):
        super().__init__(abxDataset, max_size_group)
        self.symmetric = False
        self.get_speakers_from_cp = {}
        self.max_x = max_x_across

        for by_speaker in self.groups_csp:
            for phones in by_speaker:
                for lo, hi in phones:
                    c_id, p_id, s_id = self.dataset.get_ids(
                        self.index_csp[lo])
                    self.get_speakers_from_cp.setdefault(c_id, {}) \
                        .setdefault(p_id, {})[s_id] = (lo, hi)

        for by_speaker in self.groups_csp:
            for phones in by_speaker:
                if len(phones) > 1:
                    for lo, hi in phones:
                        c_id, p_id, s_id = self.dataset.get_ids(
                            self.index_csp[lo])
                        n_other = len(
                            self.get_speakers_from_cp[c_id][p_id]) - 1
                        self.len += (len(phones) - 1) * min(self.max_x,
                                                            n_other)

    def get_other_speakers_in_group(self, i_start_group):
        c_id, p_id, s_id = self.dataset.get_ids(
            self.index_csp[i_start_group])
        return [span for spk, span
                in self.get_speakers_from_cp[c_id][p_id].items()
                if spk != s_id]

    def get_abx_triplet(self, span_a, span_b, span_x):
        data_a, size_a, id_a = self.get_group(*span_a)
        data_b, size_b, id_b = self.get_group(*span_b)
        data_x, size_x, id_x = self.get_group(*span_x)
        coords = id_a[2], id_a[1], id_b[1], id_a[0], id_x[2]
        return coords, (data_a, size_a), (data_b, size_b), (data_x, size_x)

    def __iter__(self):
        for by_speaker in self.groups_csp:
            for phones in by_speaker:
                if len(phones) == 1:
                    continue
                for a, span_a in enumerate(phones):
                    others = self.get_other_speakers_in_group(span_a[0])
                    if len(others) > self.max_x:
                        others = random.sample(others, k=self.max_x)
                    for span_x in others:
                        for b, span_b in enumerate(phones):
                            if b == a:
                                continue
                            yield self.get_abx_triplet(span_a, span_b,
                                                       span_x)

    def get_board_size(self):
        return (self.dataset.get_n_speakers(), self.dataset.get_n_phone(),
                self.dataset.get_n_phone(), self.dataset.get_n_context(),
                self.dataset.get_n_speakers())
