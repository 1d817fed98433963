"""Corpus discovery and filtering, a copy of `cpc2_tpu/data/corpus.py`
(reference `cpc/dataset.py:771-978`).

Pure host-side filesystem logic: recursive walk, speaker-level labelling, the
seven long-form "naming conventions" with temporal sorting, the torch-pickle
sequence cache (kept for interop with caches produced by the reference), and
the sorted-merge `filter_seqs`.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple


def _load_cache(cache_path: str):
    import torch
    return torch.load(cache_path, weights_only=False)


def _save_cache(cache_path: str, payload) -> None:
    import torch
    torch.save(payload, cache_path)


def find_all_seqs(dir_name: str,
                  no_speaker: bool = False,
                  extension: str = '.flac',
                  loadCache: bool = False,
                  speaker_level: int = 1,
                  format: Optional[str] = None,
                  cache_path: Optional[str] = None
                  ) -> Tuple[List[Tuple[int, str]], List[str]]:
    """List all sequences under `dir_name` (reference `dataset.py:771-948`).

    Returns (sequences [(speaker_idx, rel_path)], speakers). When `format`
    names a long-form convention, sequences are sorted temporally and speaker
    ids become recording/session ids.
    """
    if cache_path is None:
        cache_path = str(Path(dir_name) / '_seqs_cache.txt')
    if loadCache:
        try:
            out_sequences, speakers = _load_cache(cache_path)
            print(f'Loaded from cache {cache_path} successfully')
            return out_sequences, speakers
        except OSError as err:
            print(f'Ran in an error while loading {cache_path}: {err}')
            print('Could not load cache, rebuilding')
        except Exception as err:  # corrupt / missing file
            print(f'Could not load cache ({err}), rebuilding')

    if dir_name[-1] != os.sep:
        dir_name += os.sep
    prefix_size = len(dir_name)
    speakers_target: Dict[str, int] = {}
    out_sequences: List[Tuple[int, str]] = []

    out_sequences_ids: List[Tuple[int, str]] = []
    out_ids: List[str] = []
    ids_target: Dict[str, int] = {}

    for root, dirs, filenames in os.walk(dir_name, followlinks=True):
        filtered = [f for f in filenames if f.endswith(extension)]
        if not filtered:
            continue
        speaker_str = os.sep.join(
            root[prefix_size:].split(os.sep)[:speaker_level])
        if speaker_str not in speakers_target:
            speakers_target[speaker_str] = len(speakers_target)
        speaker = speakers_target[speaker_str]

        for filename in filtered:
            full_path = os.path.join(root[prefix_size:], filename)
            out_sequences.append((speaker, full_path))
            if format is not None:
                id_str = _extract_id(filename, format, no_speaker)
                if id_str not in ids_target:
                    ids_target[id_str] = len(ids_target)
                    out_ids.append(id_str)
                out_sequences_ids.append((ids_target[id_str], full_path))

    out_speakers: List[str] = [None] * len(speakers_target)
    for key, index in speakers_target.items():
        out_speakers[index] = key

    if format is not None:
        sorting_func = _sorting_func(format, extension)
        out_sequences_ids = sorted(out_sequences_ids, key=sorting_func)
        if format == "no_speaker" or no_speaker:
            out_sequences_ids = [(0, v) for _, v in out_sequences_ids]
        out_sequences = out_sequences_ids
        out_speakers = out_ids
    try:
        _save_cache(cache_path, (out_sequences, out_speakers))
        print(f'Saved cache file at {cache_path}')
    except OSError as err:
        print(f'Ran in an error while saving {cache_path}: {err}')
    return out_sequences, out_speakers


def _extract_id(filename: str, format: str, no_speaker: bool) -> str:
    """Recording/session id per naming convention
    (reference `dataset.py:849-872`)."""
    if format == "id_spkr_onset_offset":
        id_str = '_'.join(filename.split('_')[0:-2])
    elif format == "id_spkr_onset_offset_spkr_onset_offset":
        id_str = '_'.join(filename.split('_')[0:-5])
    elif format == "spkr-id":
        id_str = '-'.join(filename.split('-')[0:2])
    elif format == "spkr_id_nb":
        id_str = '_'.join(filename.split('_')[0:-1])
    elif format == "spkr-id-nb":
        id_str = '-'.join(filename.split('-')[0:-1])
    elif format == "full_seedlings":
        splitted = filename.split('_')
        id_str = '_'.join(splitted[0:-2] + [splitted[-1]])
    elif format != "no_speaker":
        raise ValueError("%s format unknown" % format)
    if format == "no_speaker" or no_speaker:
        id_str = 'anonymous'
    return id_str


def _sorting_func(format: str, extension: str):
    """Temporal sort keys per naming convention
    (reference `dataset.py:879-937`)."""
    def get_id_spkr_onset(x):
        s = x[1].split('_')
        return '_'.join(s[0:-2]), float(s[-2])

    def get_id_spkr_onset2(x):
        s = x[1].split('_')
        return '_'.join(s[0:-5]), float(s[-5])

    def get_spkr_id(x):
        s = x[1].split('-')
        return s[0], int(s[1])

    def get_spkr_id2(x):
        s = x[1].replace(extension, '').split('_')
        return s[0:-1], int(s[-1])

    def get_spkr_id3(x):
        s = x[1].replace(extension, '').split('-')
        return s[0:-1], int(s[-1])

    def get_spkr_id_full_seedlings(x):
        s = x[1].split('_')
        return s[0:-2] + [s[-1]], int(s[-2])

    def get_no_speaker(x):
        s = x[1].replace(extension, '').split('_')
        return s[0:-1], int(s[-1])

    table = {
        "id_spkr_onset_offset": get_id_spkr_onset,
        "id_spkr_onset_offset_spkr_onset_offset": get_id_spkr_onset2,
        "spkr-id": get_spkr_id,
        "spkr_id_nb": get_spkr_id2,
        "spkr-id-nb": get_spkr_id3,
        "full_seedlings": get_spkr_id_full_seedlings,
        "no_speaker": get_no_speaker,
    }
    if format not in table:
        raise ValueError("can't find sorting func from %s" % format)
    return table[format]


def filter_seqs(path_txt: str, seq_couples: List[Tuple[int, str]]
                ) -> List[Tuple[int, str]]:
    """Keep sequences whose basename appears in `path_txt`
    (reference `dataset.py:963-978`, sorted-merge)."""
    with open(path_txt, 'r') as f:
        in_seqs = [p.replace('\n', '') for p in f.readlines()]

    in_seqs.sort()
    seq_couples.sort(
        key=lambda x: os.path.basename(os.path.splitext(x[1])[0]))
    output, index = [], 0
    for x in seq_couples:
        seq = os.path.basename(os.path.splitext(x[1])[0])
        while index < len(in_seqs) and seq > in_seqs[index]:
            index += 1
        if index == len(in_seqs):
            break
        if seq == in_seqs[index]:
            output.append(x)
    return output

