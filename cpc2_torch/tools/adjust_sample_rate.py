"""Resample audio files matched to a transcript list (counterpart of
`cpc2_tpu/tools/adjust_sample_rate.py`, reference
`cpc/eval/utils/adjust_sample_rate.py`; host code, the same flags).

The reference used torchaudio's sinc resampler on Common Voices mp3;
here, as in the JAX package, resampling is a polyphase scipy filter. mp3
input is decoded by the port's FFmpeg-backed shim
(`cpc2_torch/csrc/host/audiodec.cc`) where FFmpeg's headers exist; on
machines without them, `.mp3` fails fast with a conversion hint rather
than crashing mid-decode.

Run: ``python -m cpc2_torch.tools.adjust_sample_rate <path_db>
<path_phone_files> <path_out> [--out_sample_rate 16000]``
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from pathlib import Path

import numpy as np
from scipy import signal as sps

from ..data.audio_io import load_audio, save_wav


def resample(data: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample to target_sr (identity when rates match)."""
    if sr == target_sr:
        return data
    g = math.gcd(sr, target_sr)
    return sps.resample_poly(data, target_sr // g, sr // g).astype(
        np.float32)


def convert_one(src: str, dst: str, target_sr: int) -> None:
    """Decode -> resample -> write one file as 16-bit wav at target_sr."""
    data, sr = load_audio(src)
    save_wav(dst, resample(np.asarray(data), sr, target_sr), target_sr)


def adjust_sample_rate(path_db, file_list, path_db_out, target_sr):
    """Convert every `file_list` entry under `path_db` into
    `path_db_out/<stem>.wav` at `target_sr`."""
    for i, rel in enumerate(file_list, start=1):
        convert_one(os.path.join(path_db, rel),
                    os.path.join(path_db_out,
                                 str(Path(rel).with_suffix('.wav'))),
                    target_sr)
        if i % 100 == 0:
            print(f"  {i}/{len(file_list)}")


def get_names_list(path_tsv_file):
    """First whitespace-separated column of a transcript table — the
    audio file names that have a transcription."""
    with open(path_tsv_file) as f:
        return [line.split()[0] for line in f if line.strip()]


def transcribed_audio(path_db: str, extension: str,
                      transcript_tsv: str) -> list:
    """Audio files in `path_db` (non-recursive, `extension`) whose stem
    appears in the transcript table, sorted."""
    with_transcript = {Path(n).stem
                      for n in get_names_list(transcript_tsv)} \
        | set(get_names_list(transcript_tsv))
    found = [f for f in os.listdir(path_db)
             if Path(f).suffix == extension]
    print(f"Found {len(found)} in the dataset")
    keep = sorted(f for f in found
                  if Path(f).stem in with_transcript
                  or f in with_transcript)
    return keep


def parse_args(argv):
    parser = argparse.ArgumentParser(
        description='Adjust the sample rate of a given group of audio files')
    parser.add_argument('path_db', type=str)
    parser.add_argument("path_phone_files", type=str)
    parser.add_argument("path_out", type=str)
    parser.add_argument("--out_sample_rate", type=int, default=16000)
    parser.add_argument('--file_extension', type=str, default='.mp3',
                        choices=['.wav', '.flac', '.mp3'],
                        help="input format; .mp3 needs the native "
                             "FFmpeg-backed decoder (built when the "
                             "libav* dev libraries are present)")
    return parser.parse_args(argv)


def main(argv):
    args = parse_args(argv)
    if args.file_extension == '.mp3':
        from ..data.audio_io import _MP3_HELP, compressed_available
        if not compressed_available():
            raise SystemExit(f"--file_extension .mp3: {_MP3_HELP}")
    targets = transcribed_audio(args.path_db, args.file_extension,
                                args.path_phone_files)
    print(f"Converting {len(targets)} files")
    Path(args.path_out).mkdir(parents=True, exist_ok=True)
    adjust_sample_rate(args.path_db, targets, args.path_out,
                       args.out_sample_rate)


if __name__ == '__main__':
    main(sys.argv[1:])
