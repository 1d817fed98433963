"""Audio reading and writing (a copy of `cpc2_tpu/data/audio_io.py`).

* WAV is parsed with numpy alone;
* FLAC is decoded by the port's copy of the native decoder
  (`cpc2_torch/csrc/host/flacdec.cc`) through ctypes;
* mp3 and the other `_COMPRESSED_EXTS` go through the FFmpeg-backed shim
  (`cpc2_torch/csrc/host/audiodec.cc`), which builds only where FFmpeg's
  development headers exist; elsewhere they raise `AudioFormatError`.

The native libraries are built with `g++` at first use
(`cpc2_torch/ops/_build.py:build_host`). Loaders return (waveform float32
in [-1, 1] shaped (T,), sample_rate); multi-channel audio is averaged to
mono like the reference (`cpc/dataset.py:425`).
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Tuple

import numpy as np

from ..ops import _build


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


# ---------------------------------------------------------------------------
# FLAC (native decoder, csrc/host/flacdec.cc)
# ---------------------------------------------------------------------------

def load_flac(path: str) -> Tuple[np.ndarray, int]:
    lib = _build.host_library("flacdec")
    sr = ctypes.c_int(0)
    ch = ctypes.c_int(0)
    n = lib.flac_info_file(str(path).encode(), ctypes.byref(sr),
                           ctypes.byref(ch))
    if n < 0:
        raise AudioFormatError(f"cannot parse FLAC file {path} (err {n})")
    buf = np.empty(int(n) * max(ch.value, 1), dtype=np.float32)
    got = lib.flac_decode_file(
        str(path).encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), buf.size,
        ctypes.byref(sr), ctypes.byref(ch))
    if got < 0:
        raise AudioFormatError(f"FLAC decode failed for {path} (err {got})")
    x = buf[:int(got) * ch.value]
    if ch.value > 1:
        x = x.reshape(-1, ch.value).mean(axis=1)
    return x, sr.value


def flac_info(path: str) -> Tuple[int, int]:
    lib = _build.host_library("flacdec")
    sr = ctypes.c_int(0)
    ch = ctypes.c_int(0)
    n = lib.flac_info_file(str(path).encode(), ctypes.byref(sr),
                           ctypes.byref(ch))
    if n < 0:
        raise AudioFormatError(f"cannot parse FLAC header of {path}")
    return int(n), sr.value


# ---------------------------------------------------------------------------
# mp3 / other compressed formats (csrc/host/audiodec.cc, libavformat-backed)
# ---------------------------------------------------------------------------

_MP3_HELP = (
    "mp3 decoding needs the native FFmpeg-backed shim "
    "(csrc/audiodec.cc), which requires the libavformat/libavcodec dev "
    "libraries at build time; they are missing here. Convert first, "
    "e.g.: ffmpeg -i in.mp3 -ar 16000 -ac 1 out.wav")

# Extensions routed through the FFmpeg-backed shim. WAV and FLAC keep
# their dedicated fast paths.
_COMPRESSED_EXTS = frozenset(
    ('.mp3', '.ogg', '.opus', '.m4a', '.aac', '.wma', '.mp4', '.webm'))


def compressed_available() -> bool:
    """Whether the FFmpeg-backed shim can be built here."""
    return _build.host_buildable("audiodec")


def _audec(path: str):
    if not compressed_available():
        raise AudioFormatError(f"{path}: {_MP3_HELP}")
    return _build.host_library("audiodec")


def load_compressed(path: str) -> Tuple[np.ndarray, int]:
    """Decode mp3 (or any other container/codec the system FFmpeg
    libraries know) via the native shim. Mono-averaged like the other
    loaders."""
    lib = _audec(path)
    out = ctypes.POINTER(ctypes.c_float)()
    sr = ctypes.c_int(0)
    ch = ctypes.c_int(0)
    n = lib.audec_decode_file(str(path).encode(), ctypes.byref(out),
                              ctypes.byref(sr), ctypes.byref(ch))
    if n < 0:
        raise AudioFormatError(f"cannot decode {path} (audiodec err {n})")
    try:
        x = np.ctypeslib.as_array(out, shape=(int(n) * ch.value,)).copy()
    finally:
        lib.audec_free(out)
    if ch.value > 1:
        x = x.reshape(-1, ch.value).mean(axis=1)
    return x, sr.value


def compressed_info(path: str) -> Tuple[int, int]:
    """(estimated num_frames, sample_rate) from container metadata only:
    for CBR mp3 without a Xing header the count may be off by a frame; the
    data layer uses it for pack-size budgeting only."""
    lib = _audec(path)
    sr = ctypes.c_int(0)
    ch = ctypes.c_int(0)
    n = lib.audec_info_file(str(path).encode(), ctypes.byref(sr),
                            ctypes.byref(ch))
    if n < 0:
        raise AudioFormatError(f"cannot parse {path} (audiodec err {n})")
    return int(n), sr.value


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _ext(path: str) -> str:
    return os.path.splitext(str(path))[1].lower()


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    ext = _ext(path)
    if ext == '.flac':
        return load_flac(str(path))
    if ext in _COMPRESSED_EXTS:
        return load_compressed(str(path))
    return load_wav(str(path))


def save_audio(path: str, x: np.ndarray, sample_rate: int) -> None:
    if _ext(path) != '.wav':
        raise AudioFormatError("only WAV writing is supported")
    save_wav(str(path), x, sample_rate)


def audio_info(path: str) -> Tuple[int, int]:
    """(num_frames, sample_rate) without decoding the samples. For
    compressed formats the count is the container's duration estimate."""
    ext = _ext(path)
    if ext == '.flac':
        return flac_info(str(path))
    if ext in _COMPRESSED_EXTS:
        return compressed_info(str(path))
    return wav_info(str(path))
