"""Power-of-two curriculum training sets (counterpart of
`cpc2_tpu/tools/build_power_two_training.py`, reference
`data/build_power_two_training.py`; host code, the same flags).

Splits a corpus into N mutually-exclusive packets of at least `duration`
seconds each, then merges packets pairwise into 2x, 4x, ... tiers. Every
tier is a directory of symlinks (`<hours>h/<packet>/<original subpath>`),
so no audio is copied and a curriculum of nested training sets costs no
disk.

Run: `python -m cpc2_torch.tools.build_power_two_training --audio_path ...
--nb_packets 16 --output_path ... --duration 28800`
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from ..data.audio_io import audio_info


def get_audio_duration(audio_path: str) -> float:
    n_frames, sr = audio_info(audio_path)
    return n_frames / sr


def _tier_dir(output_path: str, seconds: float) -> str:
    return os.path.join(output_path, f'{int(seconds / 3600)}h')


def _link_into(packet_dir: str, src: str, subpath: str) -> None:
    dst = os.path.join(packet_dir, subpath)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    os.symlink(src, dst)


def create_min_dur_packets(audio_path, output_path, target_dur, nb_packets):
    """Fill `nb_packets` disjoint packets with >= target_dur seconds each
    (reference `build_power_two_training.py:32-47`). Files are consumed in
    glob order; a packet stops filling once within 1% of the target."""
    print("Start creating small packets of audio")
    files = glob.glob(os.path.join(audio_path, '**/*.wav'), recursive=True)
    queue = iter(files)
    tier = _tier_dir(output_path, target_dur)
    for packet_idx in range(nb_packets):
        packet_dir = os.path.join(tier, str(packet_idx))
        filled = 0.0
        for src in queue:
            _link_into(packet_dir, src, os.path.relpath(src, audio_path))
            filled += get_audio_duration(src)
            if filled >= 0.99 * target_dur:
                break
    print("Done creating %d packets of %d hours"
          % (nb_packets, target_dur // 3600))


def gather_small_packets(output_path, target_dur, nb_packets):
    """Merge packet pairs into a doubled-duration tier, repeatedly, until a
    single packet remains (reference `build_power_two_training.py:50-68`)."""
    print("Start gathering small packets to create bigger packets")
    while nb_packets > 1:
        src_tier = _tier_dir(output_path, target_dur)
        dst_tier = _tier_dir(output_path, 2 * target_dur)
        for pair in range(nb_packets // 2):
            dst_dir = os.path.join(dst_tier, str(pair))
            for half in (2 * pair, 2 * pair + 1):
                src_dir = os.path.join(src_tier, str(half))
                for f in glob.glob(os.path.join(src_dir, '**/*.wav'),
                                   recursive=True):
                    _link_into(dst_dir, f, os.path.relpath(f, src_dir))
        nb_packets //= 2
        target_dur *= 2
        print("Done creating %d packets of %d hours"
              % (nb_packets, target_dur // 3600))


def main(argv):
    parser = argparse.ArgumentParser(
        description='Build nested power-of-two training subsets out of '
                    'mutually exclusive audio packets.')
    parser.add_argument('--audio_path', type=str, required=True)
    parser.add_argument("--duration", type=int, required=True,
                        default=8 * 3600,
                        help='Seconds of audio per base packet '
                             '(default 8 hours).')
    parser.add_argument("--nb_packets", type=int, required=True)
    parser.add_argument('--output_path', type=str, required=True)
    args = parser.parse_args(argv)

    if os.path.isdir(args.output_path):
        raise ValueError("%s already exists" % args.output_path)
    os.makedirs(args.output_path)

    create_min_dur_packets(args.audio_path, args.output_path, args.duration,
                           args.nb_packets)
    gather_small_packets(args.output_path, args.duration, args.nb_packets)


if __name__ == "__main__":
    main(sys.argv[1:])
