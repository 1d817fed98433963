"""Groups of `--steps_per_dispatch` steps (counterpart of
`cpc2_tpu/dispatch.py:GroupAssembler` and `EPOCH_END`).

The assembler runs on the loader's thread: it buffers each full batch's
window offsets (`--corpus_on_device`; else the batch itself), labels, and
signal quality and masks where the run has them, and when N of them from
one pack are in hand it stacks them into (N, B) int32 offsets, (N, ...)
labels, (N, B, Q) quality and (N, 2B, S) masks, pinned for their copy to a
card. A pack swap flushes the buffered batches as a partial group
(offsets index the pack they were drawn from), and so does the `EPOCH_END`
sentinel at the epoch's end. A partial group runs through the single step.
"""

from __future__ import annotations

import numpy as np
import torch

EPOCH_END = object()       # the loader's last item: flush the buffer


class GroupAssembler:
    """Items are `(pack, offsets, labels[, quality, mask])`: the host pack
    the offsets index (held, so that a swap is seen by identity), the (B,)
    int32 offsets (or a (B, 2, 1, W) batch, with no pack), the batch's
    labels, and its (B, Q) signal quality and (2B, S) mask or None, numpy
    arrays. `add` returns `('idxgroup', pack, offsets (N, B), labels (N,
    ...), n_examples, quality (N, B, Q) or None, masks (N, 2B, S) or
    None)`, tensors, when a group completes,
    `('idxpartial', items)` when the pack swaps mid-group, or None while
    buffering; `flush` returns what is buffered, a partial group when it is
    short of N (None when empty)."""

    def __init__(self, spd: int, pin: bool = False):
        self._spd = spd
        self._pin = pin
        self._buf = []

    def add(self, item):
        flushed = None
        if self._buf and self._buf[0][0] is not item[0]:
            flushed = self.flush()        # pack swapped mid-group
        self._buf.append(item)
        if flushed is not None:
            return flushed
        if len(self._buf) == self._spd:
            return self.flush()
        return None

    def flush(self):
        if not self._buf:
            return None
        items = list(self._buf)
        self._buf.clear()
        if len(items) < self._spd:
            return ('idxpartial', items)
        stacked = []
        for j in range(1, 5):
            if len(items[0]) <= j or items[0][j] is None:
                stacked.append(None)
                continue
            t = torch.from_numpy(np.stack([b[j] for b in items]))
            stacked.append(t.pin_memory() if self._pin else t)
        offsets, labels, quality, masks = stacked
        n_ex = sum(b[1].shape[0] for b in items)
        return ('idxgroup', items[0][0], offsets, labels, n_ex, quality,
                masks)
