"""ABX discriminability evaluation (counterpart of
`cpc2_tpu/eval/eval_ABX.py`, reference `cpc/eval/eval_ABX.py`).

Scores are accumulated per (speaker, phoneA, phoneB, context[, speakerX])
cell, averaged over contexts, then over speaker and phone pairs
(`eval_ABX.py:44-97`); the reference's sparse torch tensors become numpy
scatter-adds into small dense boards.

Run, on the card unless `--device cpu`:
    python -m cpc2_torch.eval.eval_ABX from_checkpoint <checkpoint.pt> \
        <file.item> <corpus> [--file_extension .wav]
    python -m cpc2_torch.eval.eval_ABX from_pre_computed <file.item> \
        <features dir> [--file_extension .npy|.pt]
Both write `ABX_scores.json` and `ABX_args.json`.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..data.corpus import find_all_seqs
from ..feature_loader import (FeatureModule, build_feature,
                              build_feature_files, load_model)
from ..training import resolve_device
from .abx import abx_group_computation as abx_g
from .abx import abx_iterators as abx_it

# Seconds spent building the features and scoring, flushes and DTW pairs,
# of the last `ABX` call.
LAST_RUN = {}


def reduce_sparse_data(quotient, divisor):
    return quotient / (1e-08 * (divisor == 0) + divisor)


def _scatter_dense(coords, values, board_size):
    dense = np.zeros(board_size, dtype=np.float64)
    counts = np.zeros(board_size, dtype=np.float64)
    if len(values) == 0:
        return dense, counts
    np.add.at(dense, tuple(coords.T), values)
    np.add.at(counts, tuple(coords.T), 1.0)
    return dense, counts


def _pooled_error(totals, counts):
    """Two-stage average of a scored board down to one error rate.

    Boards are (speaker, phoneA, phoneB, context[, speakerX]). Stage 1
    averages each cell over its contexts (axis 3); stage 2 averages the
    occupied cells over every remaining axis but the phone pair: axis 0
    for 'within', axes 0 and 3 (speaker X) for 'across', as the reference's
    two sparse reductions do (`eval_ABX.py:44-97`).
    """
    per_cell_n = counts.sum(axis=3)
    per_cell = reduce_sparse_data(totals.sum(axis=3), per_cell_n)
    occupied = per_cell_n > 0
    pool_axes = tuple(a for a in range(per_cell.ndim) if a not in (1, 2))
    per_pair_n = occupied.sum(axis=pool_axes)
    per_pair = reduce_sparse_data(per_cell.sum(axis=pool_axes), per_pair_n)
    return float(per_pair.sum() / (per_pair_n > 0).sum())


def ABX(feature_function, path_item_file, seq_list, distance_mode,
        step_feature, modes, cuda=False, max_x_across=5, max_size_group=30,
        normalize=True, device="cuda"):
    """Reference `eval_ABX.py:20-99`, scored on `device`.
    `cuda` is kept for the reference's signature. Records its timings in
    `LAST_RUN`."""
    start = time.perf_counter()
    dataset = abx_it.ABXFeatureLoader(path_item_file, seq_list,
                                      feature_function, step_feature,
                                      normalize)
    features_s = time.perf_counter() - start
    dist_fn = abx_g.get_distance_function_from_name(distance_mode)
    counts = dict(abx_g.COUNTS)
    start = time.perf_counter()
    scores = {}
    for mode in ('within', 'across'):
        if mode not in modes:
            continue
        print(f"Computing ABX {mode} speakers...")
        extra = {'max_x_across': max_x_across} if mode == 'across' else {}
        group_it = dataset.get_iterator(mode, max_size_group, **extra)
        coords, values, board = abx_g.get_abx_scores_dtw_on_group(
            group_it, dist_fn, group_it.symmetric, device=device)
        scores[mode] = _pooled_error(*_scatter_dense(coords, values, board))
        print(f"...done. ABX {mode} : {scores[mode]}")
    LAST_RUN.clear()
    LAST_RUN.update(features_s=features_s,
                    scoring_s=time.perf_counter() - start,
                    **{k: abx_g.COUNTS[k] - counts[k] for k in counts})
    print(f"features {features_s:.3f} s, scoring {LAST_RUN['scoring_s']:.3f}"
          f" s in {LAST_RUN['flushes']} flushes of "
          f"{LAST_RUN['dtw_pairs']} DTW pairs on {device}")
    return scores


def update_base_parser(parser):
    parser.add_argument('--debug', action='store_true')
    parser.add_argument('--feature_size', type=float, default=0.01,
                        help="Size (in s) of one feature")
    parser.add_argument('--cuda', action='store_true',
                        help="(kept for CLI parity; --device chooses)")
    parser.add_argument('--device', type=str, default='cuda',
                        choices=['cuda', 'cpu'],
                        help="Where to extract features and score. cuda "
                        "raises when no card is present; cpu runs the "
                        "kernels' plain versions.")
    parser.add_argument('--mode', type=str, default='all',
                        choices=['all', 'within', 'across'],
                        help="Type of ABX score to compute")
    parser.add_argument("--max_size_group", type=int, default=20,
                        help="Max size of a group while computing the ABX "
                        "score")
    parser.add_argument("--max_x_across", type=int, default=5,
                        help="When computing the ABX across score, maximum "
                        "number of speaker X to sample per couple A,B")
    parser.add_argument("--out", type=str, default=None,
                        help="Path where the results should be saved")
    parser.add_argument("--level_gru", type=int, default=None)
    parser.add_argument("--abx_seed", type=int, default=None,
                        help="Seed the triplet-group subsampler, which "
                        "otherwise draws from the unseeded global `random` "
                        "as the reference does (`abx_iterators.py:285`).")


def parse_args(argv):
    base_parser = argparse.ArgumentParser(description='ABX metric')
    subparsers = base_parser.add_subparsers(dest='load')
    parser_checkpoint = subparsers.add_parser('from_checkpoint')
    update_base_parser(parser_checkpoint)
    parser_checkpoint.add_argument('path_checkpoint', type=str,
                                   help="Path to the model's checkpoint")
    parser_checkpoint.add_argument('path_item_file', type=str,
                                   help="Path to the ABX .item file")
    parser_checkpoint.add_argument('path_dataset', type=str,
                                   help="Path to the dataset")
    parser_checkpoint.add_argument('--seq_norm', action='store_true',
                                   help='Normalize each batch of features '
                                   'across the time channel before ABX.')
    parser_checkpoint.add_argument('--max_size_seq', default=64000, type=int)
    parser_checkpoint.add_argument('--strict', action='store_true')
    parser_checkpoint.add_argument('--file_extension', type=str,
                                   default='.wav')
    parser_checkpoint.add_argument('--get_encoded', action='store_true')
    parser_checkpoint.add_argument('-n', '--num_processes', type=int,
                                   default=40,
                                   help='(kept for CLI parity)')

    parser_db = subparsers.add_parser('from_pre_computed')
    update_base_parser(parser_db)
    parser_db.add_argument('path_item_file', type=str)
    parser_db.add_argument('path_dataset', type=str,
                           help="Path to pre-computed features "
                           "(.pt or .npy)")
    parser_db.add_argument('--file_extension', type=str, default='.pt')
    return base_parser.parse_args(argv)


def main(argv):
    args = parse_args(argv)
    device = resolve_device(args.device)

    seq_list, _ = find_all_seqs(args.path_dataset,
                                extension=args.file_extension)
    seq_list = [(str(Path(x).stem), str(Path(args.path_dataset) / x))
                for (_, x) in seq_list]
    if args.debug:
        seq_list = seq_list[:1000]

    if args.load == 'from_checkpoint':
        update_config = None
        if args.level_gru is not None:
            update_config = argparse.Namespace(nLevelsGRU=args.level_gru)
        model = load_model([args.path_checkpoint],
                           updateConfig=update_config)[0].to(device)
        feature_maker = FeatureModule(model, args.get_encoded,
                                      keep_hidden=True)
        cache = {}

        def feature_function(x):
            # The first call extracts, batched across files of equal
            # length, every file the .item file names (an item file over
            # a held-out split does not extract the whole corpus).
            if not cache:
                needed = set(abx_it.load_item_file(args.path_item_file)[0])
                paths = [p for (stem, p) in seq_list if stem in needed]
                cache.update(build_feature_files(
                    feature_maker, paths, seqNorm=args.seq_norm,
                    strict=args.strict, maxSizeSeq=args.max_size_seq))
            if str(x) in cache:
                return cache[str(x)]
            return build_feature(feature_maker, x, seqNorm=args.seq_norm,
                                 strict=args.strict,
                                 maxSizeSeq=args.max_size_seq)
    else:
        def feature_function(x):
            if str(x).endswith('.npy'):
                return np.load(x)
            return torch.load(x, map_location='cpu',
                              weights_only=False).numpy()

    modes = ["within", "across"] if args.mode == 'all' else [args.mode]
    if args.abx_seed is not None:
        random.seed(args.abx_seed)

    if args.out is not None:
        out_dir = Path(args.out)
    elif args.load == 'from_checkpoint':
        out_dir = Path(args.path_checkpoint).parent
    else:
        out_dir = Path(args.path_dataset)
    # made before the scoring pass, so that an unwritable --out fails
    # before the work and not after it
    out_dir.mkdir(parents=True, exist_ok=True)

    scores = ABX(feature_function, args.path_item_file, seq_list, 'cosine',
                 1 / args.feature_size, modes, cuda=args.cuda,
                 max_x_across=args.max_x_across,
                 max_size_group=args.max_size_group, device=device)
    with open(out_dir / 'ABX_scores.json', 'w') as f:
        json.dump(scores, f, indent=2)
    with open(out_dir / 'ABX_args.json', 'w') as f:
        json.dump(vars(args), f, indent=2)
    return scores


if __name__ == "__main__":
    main(sys.argv[1:])
