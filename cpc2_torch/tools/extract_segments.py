"""RTTM voice-type annotations -> trimmed wav segment corpora (counterpart
of `cpc2_tpu/tools/extract_segments.py`; host code, the same flags).

Behavioral spec (reference ``data/extract_segments.py``): read RTTM files,
keep segments whose speaker class is requested and long enough, and cut
them out of the source recordings into nested duration tiers
(``<output>/<N>h/<class>/``). Segments are drawn either at random with
probability proportional to their duration, or longest-first. Each cut is
named ``<recording>_<class>_<onset>_<offset>.wav``; after sampling, every
smaller tier is included into every bigger tier via symlinks.

The reference shells out to sox for trimming; here the trim uses the
bundled wav IO (no external binaries).

Run: ``python -m cpc2_torch.tools.extract_segments --audio_path ...
--rttm_path ... --classes KCHI FEM --durations 100 200 --sampling random
--output_path ...``
"""

from __future__ import annotations

import argparse
import functools
import glob
import os
import sys
import time
from pathlib import Path

import numpy as np

from ..data.audio_io import load_audio, save_wav

# RTTM is a 9-column space-separated format:
# SPEAKER <uri> <chan> <onset> <duration> <NA> <NA> <speaker> <NA> <NA>
_RTTM_ONSET, _RTTM_DURATION, _RTTM_SPEAKER = 3, 4, 7


def _tier_name(target_seconds: float) -> str:
    return f"{int(target_seconds) // 3600}h"


def load_all_rttm(rttm_path, classes, regex, min_dur, path_audios):
    """Collect ``[audio_path, onset, duration, speaker]`` records for every
    annotated segment with a wanted class, lasting at least ``min_dur``
    seconds, whose source recording exists under ``path_audios``."""
    t0 = time.time()
    print("Loading rttm files.")
    segments = []
    n_annotated = 0
    # NB: stdlib glob, not pathlib — an empty regex yields the pattern
    # "**.rttm", which pathlib rejects but glob treats as "*.rttm".
    pattern = os.path.join(str(rttm_path), f"*{regex}*.rttm")
    for rttm_file in sorted(Path(p) for p in glob.glob(pattern)):
        recording = Path(path_audios) / (rttm_file.stem + ".wav")
        if not recording.is_file():
            continue
        n_annotated += 1
        for line in rttm_file.read_text().splitlines():
            fields = line.split(' ')
            if len(fields) <= _RTTM_SPEAKER:
                continue
            onset = float(fields[_RTTM_ONSET])
            duration = float(fields[_RTTM_DURATION])
            speaker = fields[_RTTM_SPEAKER]
            if speaker in classes and duration >= min_dur:
                segments.append([str(recording), onset, duration, speaker])
    print("Found %d .rttm files" % n_annotated)
    print("Loaded %d segments in %.2f sec" % (len(segments),
                                              time.time() - t0))
    return segments


@functools.lru_cache(maxsize=4)
def _cached_recording(audio_file):
    """Whole-recording decode, cached because consecutive cuts usually hit
    the same source file."""
    return load_audio(audio_file)


def cut_wave_file(audio_file, onset, duration, spkr, output_path):
    """Write the ``[onset, onset+duration)`` slice of ``audio_file`` to
    ``<output_path>/<spkr>/<base>_<spkr>_<onset>_<offset>.wav``."""
    onset, duration = float(onset), float(duration)
    stem = Path(audio_file).stem
    name = "%s_%s_%.2f_%.2f.wav" % (stem, spkr, onset, onset + duration)
    samples, sr = _cached_recording(audio_file)
    lo = int(onset * sr)
    hi = lo + int(duration * sr)
    save_wav(os.path.join(output_path, spkr, name), samples[lo:hi], sr)


class _TierWriter:
    """Routes cuts into nested duration tiers.

    Every cut lands in the smallest tier still being filled; once the
    cumulative duration reaches that tier's target, writing moves on to the
    next bigger tier (``create_symlink`` later nests the finished tiers
    into the bigger ones). Once every target is met, further cuts keep
    landing in the largest tier.
    """

    def __init__(self, output_path, targets_seconds):
        self._root = output_path
        self._targets = sorted(float(t) for t in targets_seconds)
        self._tier = 0
        self._total = 0.0

    @property
    def satisfied(self) -> bool:
        return self._tier >= len(self._targets)

    def add(self, segment) -> None:
        audio_file, onset, duration, speaker = segment[:4]
        tier = min(self._tier, len(self._targets) - 1)
        out_dir = os.path.join(self._root, _tier_name(self._targets[tier]))
        cut_wave_file(audio_file, onset, duration, speaker, out_dir)
        self._total += float(duration)
        while (self._tier < len(self._targets) - 1
               and self._total >= self._targets[self._tier]):
            print("Done creating the %s tier"
                  % _tier_name(self._targets[self._tier]))
            self._tier += 1
        if (self._tier == len(self._targets) - 1
                and self._total >= self._targets[self._tier]):
            self._tier += 1


def uniform_segment_sampler(all_segments, durations, output_path):
    """Sample without replacement, probability proportional to duration,
    until every tier target is met (or segments run out)."""
    writer = _TierWriter(output_path, durations)
    remaining = list(all_segments)
    weights = np.asarray([seg[2] for seg in remaining], dtype=np.float64)
    while not writer.satisfied and remaining:
        pick = int(np.random.choice(len(remaining),
                                    p=weights / weights.sum()))
        writer.add(remaining.pop(pick))
        weights = np.delete(weights, pick)


def longest_segment_sampler(all_segments, durations, output_path):
    """Deterministic longest-first pass over every segment."""
    writer = _TierWriter(output_path, durations)
    for segment in sorted(all_segments, key=lambda seg: -seg[2]):
        writer.add(segment)


def segment_sampler(all_segments, durations, type, output_path):
    """Validate the request, lay out the tier directories, and dispatch to
    the chosen sampling strategy."""
    available = sum(seg[2] for seg in all_segments)
    biggest = max(durations)
    if available < biggest:
        raise ValueError(
            "Requested %d h of segments but the annotations only cover "
            "%.2f h." % (biggest // 3600, available / 3600))

    speakers = sorted({seg[3] for seg in all_segments})
    for target in durations:
        for speaker in speakers:
            os.makedirs(os.path.join(output_path, _tier_name(target),
                                     speaker))

    if type == 'random':
        uniform_segment_sampler(all_segments, durations, output_path)
    elif type == 'longest':
        longest_segment_sampler(all_segments, durations, output_path)
    else:
        raise ValueError("Only 'random' or 'longest' type of sampler is "
                         "accepted.")


def create_symlink(output_path, durations, classes):
    """Nest every smaller tier into every bigger tier via symlinks.

    Tier contents are snapshotted before any link is created, so a tier
    never re-exports links it received from an even smaller tier.
    """
    targets = sorted(float(d) for d in durations)
    snapshot = {}
    for target in targets:
        for speaker in classes:
            folder = os.path.join(output_path, _tier_name(target), speaker)
            snapshot[(target, speaker)] = sorted(
                Path(folder).glob("*.wav")) if os.path.isdir(folder) else []

    for i, small in enumerate(targets):
        for big in targets[i + 1:]:
            for speaker in classes:
                dest_dir = os.path.join(output_path, _tier_name(big),
                                        speaker)
                for src in snapshot[(small, speaker)]:
                    os.symlink(src.resolve(),
                               os.path.join(dest_dir, src.name))


def _class_hours(segments, speaker):
    return sum(seg[2] for seg in segments if seg[3] == speaker) / 3600.0


def main(argv):
    parser = argparse.ArgumentParser(
        description='This scripts extracts audio segments (.wav) according '
                    'to their annotations (.rttm)')
    parser.add_argument('--audio_path', type=str, required=True)
    parser.add_argument("--rttm_path", type=str, required=True)
    parser.add_argument("--classes", nargs='+', type=str, required=True,
                        help='Labels to extract (KCHI, CHI, MAL, FEM, '
                             'SPEECH...)')
    parser.add_argument("--durations", nargs='+', type=int, required=True,
                        help='Cumulated durations (hours) to extract; '
                             'nested tiers.')
    parser.add_argument("--sampling", type=str, required=True,
                        choices=['random', 'longest'])
    parser.add_argument('--output_path', type=str, required=True)
    parser.add_argument('--regex', type=str, default='Bergelson')
    parser.add_argument('--min_dur', type=float, default=0)
    args = parser.parse_args(argv)

    print("Extracting %s hours of %s segments from %s"
          % (args.durations, args.classes,
             os.path.basename(args.audio_path)))

    if os.path.isdir(args.output_path):
        raise ValueError("%s already exists" % args.output_path)
    os.makedirs(args.output_path)

    all_segments = load_all_rttm(rttm_path=args.rttm_path,
                                 classes=args.classes, regex=args.regex,
                                 min_dur=args.min_dur,
                                 path_audios=args.audio_path)
    fem_h = _class_hours(all_segments, 'FEM')
    mal_h = _class_hours(all_segments, 'MAL')
    print("FEM_dur : %.2f" % fem_h)
    print("MAL_dur : %.2f" % mal_h)
    print("TOT_dur : %.2f" % (fem_h + mal_h))

    targets = np.asarray([hours * 3600 for hours in args.durations])
    segment_sampler(all_segments=all_segments, durations=targets,
                    type=args.sampling, output_path=args.output_path)
    create_symlink(output_path=args.output_path, durations=targets,
                   classes=args.classes)


if __name__ == "__main__":
    main(sys.argv[1:])
