"""The device-resident corpus of `--corpus_on_device` on one device
(counterpart of `cpc2_tpu/parallel/mesh.py:pcm16_wire`,
`device_gather_windows` and `DeviceCorpus`).

Each data pack's flat waveform goes to the device once, as int16 when every
sample sits on the PCM16 grid (which decoded 16-bit audio does), and a step's
batch is gathered there from a (B,) vector of window offsets: per step the
host sends B offsets instead of the (B, 2, 1, W) audio batch. The gathered
batch is bit for bit the host loader's (`AudioBatchData.get_batch` without
augmentation), so training follows the same trajectory.

The pack lives in a slab sized to the largest pack of the corpus
(`AudioBatchData.max_pack_samples`), and a pack swap copies the next pack
into it in place: a CUDA graph that gathers from the slab
(`training.MultiStep`) stays valid across packs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor


def pcm16_wire(arr):
    """If every value of `arr` (float32) sits exactly on the PCM16 grid
    (value * 32768 an integer in [-32768, 32767]), the int16 wire array and
    True; else `arr` unchanged and False. The int16 wire is lossless: the
    device's rescale gives back `arr` bit for bit."""
    scaled = arr * 32768.0
    rounded = np.rint(scaled)
    if (np.array_equal(rounded, scaled)
            and float(rounded.min(initial=0.0)) >= -32768.0
            and float(rounded.max(initial=0.0)) <= 32767.0):
        return rounded.astype(np.int16), True
    return arr, False


def device_gather_windows(corpus: Tensor, indices: Tensor, size_window: int,
                          length: Optional[Tensor] = None) -> Tensor:
    """The (B, 2, 1, W) float32 batch of the windows of the flat waveform
    `corpus` starting at `indices` (B,): int16 rescaled by 1 / 32768, the
    past view duplicated as the future one. As `lax.dynamic_slice` in the
    JAX package, a negative start counts from the waveform's end and a
    start is clamped to its last full window; `length` (a device scalar)
    is the waveform's length where it fills only the front of `corpus`.
    Plain torch on the corpus's device."""
    if length is None:
        length = torch.tensor(corpus.shape[0], device=corpus.device)
    start = indices.to(torch.int64)
    start = torch.where(start < 0, start + length, start)
    start = torch.minimum(start, (length - size_window).clamp(min=0))
    start = start.clamp(min=0)
    window = torch.arange(size_window, device=corpus.device)
    win = corpus[start[:, None] + window[None, :]]
    if corpus.dtype == torch.int16:
        win = win.to(torch.float32) / 32768.0
    x = win[:, None, None, :]
    return torch.cat([x, x], dim=1)


class DeviceCorpus:
    """One split's pack resident on `device` (`--corpus_on_device`).

    `ensure(data)` uploads the pack `data` (the dataset's flat float32
    waveform) unless it is the resident one. Residency is keyed on a strong
    reference to the host pack, not its `id()`: after a swap frees the old
    array, a new pack allocated at the recycled address must not pass for
    the resident one. The upload goes into a slab of `capacity` samples
    (at least the pack's), int16 when the pack is on the PCM16 grid; a
    pack that needs another dtype or more room gets a new slab. `resident`
    is the slab, and `put(indices)` gathers a batch from it."""

    def __init__(self, size_window: int, device: torch.device,
                 capacity: int = 0):
        self._w = int(size_window)
        self._device = torch.device(device)
        self._capacity = int(capacity)
        self._host_data = None
        self._corpus: Optional[Tensor] = None
        self._length: Optional[Tensor] = None

    def ensure(self, data) -> None:
        """Upload `data` (the pack's flat 1-D waveform) if not resident."""
        if data is self._host_data:
            return
        arr = np.asarray(data, np.float32)
        if arr.size >= 2 ** 31:
            raise ValueError(
                "--corpus_on_device indexes packs with int32 offsets; "
                f"pack has {arr.size} samples (>= 2**31). Lower "
                "--max_size_loaded.")
        wire, _i16 = pcm16_wire(arr)
        src = torch.from_numpy(np.ascontiguousarray(wire))
        if (self._corpus is None or self._corpus.dtype != src.dtype
                or self._corpus.shape[0] < src.shape[0]):
            self._corpus = torch.zeros(max(self._capacity, src.shape[0]),
                                       dtype=src.dtype, device=self._device)
            self._length = torch.zeros((), dtype=torch.int64,
                                       device=self._device)
        self._corpus[:src.shape[0]].copy_(src)
        self._length.fill_(src.shape[0])
        self._host_data = data

    @property
    def resident(self) -> Optional[Tensor]:
        """The device slab holding the resident pack (None before the first
        `ensure`)."""
        return self._corpus

    def put(self, indices) -> Tensor:
        """The (B, 2, 1, W) float32 batch at the window starts `indices`
        (a host array or a tensor) of the resident pack. Offsets buffered
        before a swap never reach it: the trainer ensures each batch's own
        pack just before its step, on the stream the steps run on."""
        if self._corpus is None:
            raise RuntimeError("DeviceCorpus.put before ensure()")
        idx = torch.as_tensor(np.asarray(indices, np.int32)
                              if not isinstance(indices, Tensor) else indices)
        return device_gather_windows(
            self._corpus, idx.to(self._device, non_blocking=True), self._w,
            self._length)
