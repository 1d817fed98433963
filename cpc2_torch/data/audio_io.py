"""WAV reading and writing with numpy alone (a copy of the WAV part of
`cpc2_tpu/data/audio_io.py`).

Loaders return (waveform float32 in [-1, 1] shaped (T,), sample_rate);
multi-channel audio is averaged to mono like the reference
(`cpc/dataset.py:425`). FLAC and compressed formats are not ported yet and
raise `NotImplementedError` (ROADMAP.md item: FLAC and compressed audio).
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np


class AudioFormatError(ValueError):
    pass


def _parse_wav_header(data: bytes):
    if len(data) < 44 or data[:4] != b'RIFF' or data[8:12] != b'WAVE':
        raise AudioFormatError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack('<I', data[pos + 4:pos + 8])[0]
        body = pos + 8
        if cid == b'fmt ':
            (audio_fmt, n_ch, sr, _br, _ba, bits) = struct.unpack(
                '<HHIIHH', data[body:body + 16])
            fmt = (audio_fmt, n_ch, sr, bits)
        elif cid == b'data':
            if fmt is None:
                raise AudioFormatError("data chunk before fmt chunk")
            return fmt, body, size
        pos = body + size + (size & 1)
    raise AudioFormatError("no data chunk found")


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    with open(path, 'rb') as f:
        data = f.read()
    (audio_fmt, n_ch, sr, bits), off, size = _parse_wav_header(data)
    raw = data[off:off + size]
    if audio_fmt in (1, 0xFFFE):  # PCM / extensible
        if bits == 16:
            x = np.frombuffer(raw, '<i2').astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, '<i4').astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, 'u1').astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, 'u1').reshape(-1, 3)
            x = (b[:, 0].astype(np.int32)
                 | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            x = np.where(x >= 1 << 23, x - (1 << 24), x)
            x = x.astype(np.float32) / float(1 << 23)
        else:
            raise AudioFormatError(f"unsupported PCM bit depth {bits}")
    elif audio_fmt == 3:  # IEEE float
        dt = '<f4' if bits == 32 else '<f8'
        x = np.frombuffer(raw, dt).astype(np.float32)
    else:
        raise AudioFormatError(f"unsupported WAV format code {audio_fmt}")
    if n_ch > 1:
        x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch).mean(axis=1)
    return x, sr


def wav_info(path: str) -> Tuple[int, int]:
    """(num_frames, sample_rate) from the header only."""
    with open(path, 'rb') as f:
        data = f.read(65536)
    (_audio_fmt, n_ch, sr, bits), _off, size = _parse_wav_header(data)
    return size // ((bits // 8) * n_ch), sr


def save_wav(path: str, x: np.ndarray, sample_rate: int) -> None:
    """Write mono/multi-channel PCM16 WAV."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    elif x.ndim == 2 and x.shape[0] < x.shape[1]:
        x = x.T  # (C, T) -> (T, C)
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype('<i2')
    n_ch = pcm.shape[1]
    data = pcm.tobytes()
    with open(path, 'wb') as f:
        f.write(b'RIFF')
        f.write(struct.pack('<I', 36 + len(data)))
        f.write(b'WAVEfmt ')
        f.write(struct.pack('<IHHIIHH', 16, 1, n_ch, sample_rate,
                            sample_rate * n_ch * 2, n_ch * 2, 16))
        f.write(b'data')
        f.write(struct.pack('<I', len(data)))
        f.write(data)


def _check_wav(path: str) -> str:
    path = str(path)
    ext = os.path.splitext(path)[1].lower()
    if ext != '.wav':
        raise NotImplementedError(
            f"{path}: cpc2_torch reads WAV only (ROADMAP.md item: FLAC and "
            f"compressed audio)")
    return path


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    return load_wav(_check_wav(path))


def audio_info(path: str) -> Tuple[int, int]:
    """(num_frames, sample_rate) without decoding the samples."""
    return wav_info(_check_wav(path))
