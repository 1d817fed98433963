"""CTC decoding and PER scoring, a copy of `cpc2_tpu/losses/seq_alignment.py`
(reference `cpc/criterion/seq_alignment.py`).

Host-side, variable-length, data-dependent algorithms in numpy: they run on
the host after the posteriorgram comes back from the device; the beam
search bounds their throughput.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _host(x) -> np.ndarray:
    """A numpy array of `x`, a tensor (on any device) or an array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def beam_search(score_preds: np.ndarray, n_keep: int,
                blank_label: int) -> List[Tuple[float, List[int]]]:
    """CTC prefix beam search (reference `seq_alignment.py:11-61`).
    `score_preds`: (T, P) posteriorgram (probabilities, not logs)."""
    t_steps, n_labels = score_preds.shape
    beams = set([''])
    pb_t_1 = {"": 1.0}
    pnb_t_1 = {"": 0.0}

    def last_number(b):
        return int(b.split(',')[-1])

    all_preds: List[Tuple[float, str]] = []
    for t in range(t_steps):
        next_beams = set()
        pb_t, pnb_t = {}, {}
        for b in beams:
            if b not in pb_t:
                pb_t[b] = 0.0
                pnb_t[b] = 0.0
            if len(b) > 0:
                pnb_t[b] += pnb_t_1[b] * score_preds[t, last_number(b)]
            pb_t[b] = (pnb_t_1[b] + pb_t_1[b]) * score_preds[t, blank_label]
            next_beams.add(b)

            for c in range(n_labels):
                if c == blank_label:
                    continue
                b_ = b + "," + str(c)
                if b_ not in pb_t:
                    pb_t[b_] = 0.0
                    pnb_t[b_] = 0.0
                if b != "" and last_number(b) == c:
                    pnb_t[b_] += pb_t_1[b] * score_preds[t, c]
                else:
                    pnb_t[b_] += (pb_t_1[b] + pnb_t_1[b]) * score_preds[t, c]
                next_beams.add(b_)

        all_preds = [(pb_t[b] + pnb_t[b], b) for b in next_beams]
        all_preds.sort(reverse=True)
        beams = [x[1] for x in all_preds[:n_keep]]
        pb_t_1 = dict(pb_t)
        pnb_t_1 = dict(pnb_t)

    output = []
    for score, x in all_preds[:n_keep]:
        output.append((score, [int(y) for y in x.split(',') if len(y) > 0]))
    return output


def collapse_label_chain(input_labels: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Collapse runs of equal labels (reference `seq_alignment.py:64-86`).
    Input (N, T) -> (padded (N, maxSize), sizes (N,))."""
    input_labels = np.asarray(input_labels)
    n, t = input_labels.shape
    out_sizes = np.zeros(n, dtype=np.int64)
    output = []
    for l in range(n):
        status = input_labels[l, :-1] - input_labels[l, 1:]
        status = np.concatenate([np.ones(1, dtype=status.dtype), status])
        keep = status != 0
        out_sizes[l] = keep.sum()
        output.append(input_labels[l][keep])
    max_size = int(out_sizes.max()) if n > 0 else 0
    padded = np.zeros((n, max_size), dtype=np.int64)
    for l in range(n):
        padded[l, :out_sizes[l]] = output[l]
    return padded, out_sizes


# Reference-spelled alias.
collapseLabelChain = collapse_label_chain


def needleman_wunsch_align_score(seq1: Sequence[int], seq2: Sequence[int],
                                 d: float, m: float, r: float,
                                 normalize: bool = True) -> float:
    """Alignment score -> PER (reference `seq_alignment.py:89-112`),
    vectorized over the inner loop."""
    seq1 = np.asarray(seq1)
    seq2 = np.asarray(seq2)
    n1, n2 = len(seq1), len(seq2)
    prev = np.arange(n2 + 1, dtype=np.float64) * d
    for i in range(n1):
        match = np.where(seq2 == seq1[i], r, m)
        cur = np.empty(n2 + 1, dtype=np.float64)
        cur[0] = (i + 1) * d
        diag = prev[:-1] + match
        up = prev[1:] + d
        # Left-dependency is sequential; do it with a running scan.
        best = np.maximum(diag, up)
        for j in range(n2):
            cur[j + 1] = max(best[j], cur[j] + d)
        prev = cur
    res = -prev[n2]
    if normalize:
        res /= float(n1)
    return res


def get_seq_PER(seq_labels: Sequence[int],
                detected_labels: Sequence[int]) -> float:
    return needleman_wunsch_align_score(seq_labels, detected_labels,
                                        -1, -1, 0, normalize=True)


def getPER(data_loader, feature_maker, blank_label: int,
           n_keep_beam_search: int = 100) -> float:
    """Average PER over a loader (reference `seq_alignment.py:120-163`).

    `feature_maker(data)` must return a (N, T, P) posteriorgram (a numpy
    array or a tensor, on any device: it is brought to the host). Serial
    host loop (no device work in the beam search)."""
    out = 0.0
    n_items = 0
    for data in data_loader:
        output = _host(feature_maker(data))
        labels = _host(data[1])
        labels, target_sizes = collapse_label_chain(labels)
        n = output.shape[0]
        for rank in range(n):
            s = int(target_sizes[rank])
            seq_labels = labels[rank, :s]
            preds = beam_search(output[rank], n_keep_beam_search,
                                blank_label)[0][1]
            out += get_seq_PER(seq_labels, preds)
        n_items += n
    return out / n_items


# reference-spelled alias (`seq_alignment.py:89`)
NeedlemanWunschAlignScore = needleman_wunsch_align_score
