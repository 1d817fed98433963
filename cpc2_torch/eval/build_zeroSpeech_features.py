"""ZeroSpeech Track-1 feature export (counterpart of
`cpc2_tpu/eval/build_zeroSpeech_features.py`, reference
`cpc/eval/build_zeroSpeech_features.py`: the same CLI and on-disk formats).

Per corpus file, the CPC features (context or encoder) are written as one
of:

* ``fea``: text lines ``<t> <f_1> ... <f_D>``;
* ``npz``: arrays ``time``, ``features``, ``totTime``;
* ``npy``: the (T, D) matrix;
* ``af``: arrayfire containers of the npz's three arrays (`arrayfire` is
  imported when that format is written).

Frame times are mid-frame, ``t = step/2 + i*step`` with ``step =
160/16000`` (the encoder's downsampling). Heads on the feature maker, each
optional: the phone classifier of a `--supervised --pathPhone` checkpoint
(``--addCriterion``), a PCA/SFA projection (``--dimReduction``), k-means
posteriors or one-hots (``--clusters``).

Run, on the card unless `--device cpu`:
    python -m cpc2_torch.eval.build_zeroSpeech_features <corpus> <out dir> \
        <checkpoint.pt> [--format fea|npz|npy|af] [--clusters <ck.pt>]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..data.corpus import find_all_seqs
from ..feature_loader import (FeatureModule, ModelClusterCombined,
                              ModelPhoneCombined, build_feature,
                              load_model, load_supervised_criterion)
from ..models.encoder import DOWNSAMPLING
from ..training import resolve_device


def _write_fea(path, times, values, tot_time):
    with open(path, 'w') as f:
        for t, row in zip(times, values):
            f.write(' '.join(str(v) for v in [t] + row.tolist()) + '\n')


def _write_npz(path, times, values, tot_time):
    with open(path, 'wb') as f:
        np.savez(f, time=times, features=values, totTime=tot_time)


def _write_npy(path, times, values, tot_time):
    with open(path, 'wb') as f:
        np.save(f, values)


def _write_af(path, times, values, tot_time):
    import arrayfire as af
    af.save_array("time", af.Array(times, dtype=af.Dtype.f32), path)
    af.save_array("totTime", af.interop.from_ndarray(tot_time), path,
                  append=True)
    af.save_array("features", af.interop.from_ndarray(values), path,
                  append=True)


_WRITERS = {'fea': _write_fea, 'npz': _write_npz, 'npy': _write_npy,
            'af': _write_af}


def export_file(feature_fn, in_path, out_path, fmt, step_size,
                strict=False, max_size_seq=64000, seq_norm=False,
                feats=None):
    """One file's features (unless `feats` holds them already), written in
    `fmt`."""
    if feats is None:
        feats = build_feature(feature_fn, in_path, strict=strict or seq_norm,
                              maxSizeSeq=max_size_seq, seqNorm=seq_norm)
    feats = np.asarray(feats)[0]
    n_steps = feats.shape[0]
    times = [step_size / 2 + i * step_size for i in range(n_steps)]
    tot_time = np.array([step_size * n_steps], dtype=np.float32)
    _WRITERS[fmt](out_path, times, feats.astype(np.float32), tot_time)


class _Projected:
    """A feature maker with a dim-reduction projection on top."""

    def __init__(self, base, project):
        self.base = base
        self.project = project

    def __call__(self, data):
        return self.project(self.base(data))

    def get_downsampling_factor(self):
        return self.base.get_downsampling_factor()

    getDownsamplingFactor = get_downsampling_factor


def assemble_feature_fn(args, device="cuda"):
    """The feature maker the flags describe, on `device`: the CPC features,
    then the phone, dim-reduction and cluster heads asked for."""
    model = load_model([args.pathCheckpoint])[0].to(device)
    fn = FeatureModule(model, args.getEncoded, train_mode=args.train_mode)
    fn.collapse = False

    if args.addCriterion:
        criterion, _ = load_supervised_criterion(args.pathCheckpoint)
        fn = ModelPhoneCombined(fn, criterion.to(device), args.oneHot)

    if args.dimReduction is not None:
        from ..research.dim_reduction import loadDimReduction
        fn = _Projected(fn, loadDimReduction(args.dimReduction,
                                             args.centroidLimits))

    if args.clusters is not None:
        from ..clustering.clustering import kMeanCluster
        payload = torch.load(args.clusters, map_location='cpu',
                             weights_only=False)
        print(f"{payload['n_clusters']} clusters found")
        fn = ModelClusterCombined(
            fn, kMeanCluster(payload['state_dict']['Ck']).to(device),
            payload['n_clusters'], 'oneHot' if args.oneHot else 'softmax')
    return fn


def parse_export_args(argv):
    p = argparse.ArgumentParser(
        'Build features for zerospeech Track1 evaluation')
    p.add_argument('pathDB', help='Path to the reference dataset')
    p.add_argument('pathOut', help='Path to the output features')
    p.add_argument('pathCheckpoint', help='Checkpoint to load')
    p.add_argument('--extension', type=str, default='.wav')
    p.add_argument('--addCriterion', action='store_true')
    p.add_argument('--oneHot', action='store_true')
    p.add_argument('--maxSizeSeq', default=64000, type=int)
    p.add_argument('--train_mode', action='store_true')
    p.add_argument('--format', default='fea', type=str,
                   choices=sorted(_WRITERS))
    p.add_argument('--strict', action='store_true')
    p.add_argument('--dimReduction', type=str, default=None)
    p.add_argument('--centroidLimits', type=int, nargs=2, default=None)
    p.add_argument('--getEncoded', action='store_true')
    p.add_argument('--clusters', type=str, default=None)
    p.add_argument('--seqNorm', action='store_true')
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help="Where to extract the features; cuda raises when "
                   "no card is present.")
    return p.parse_args(argv)


def main(argv):
    args = parse_export_args(argv)
    device = resolve_device(args.device)

    os.makedirs(args.pathOut, exist_ok=True)
    sidecar = os.path.join(os.path.dirname(args.pathOut),
                           os.path.basename(args.pathOut) + '.json')
    with open(sidecar, 'w') as f:
        json.dump(vars(args), f, indent=2)

    rel_paths = [rel for _, rel in
                 find_all_seqs(args.pathDB, extension=args.extension,
                               loadCache=False)[0]]
    step_size = DOWNSAMPLING / 16000
    print(f"stepSize : {step_size}")
    feature_fn = assemble_feature_fn(args, device)

    # The plain feature maker: files of equal length run as one batch
    # (`build_feature_files`), each file's features those of the per-file
    # path. A maker with a head, and `--train_mode` (each forward draws its
    # own dropout masks), keep the per-file loop.
    cache = None
    if hasattr(feature_fn, 'reset_hidden') and not args.train_mode:
        from ..feature_loader import build_feature_files
        paths = [os.path.join(args.pathDB, rel) for rel in rel_paths]
        cache = build_feature_files(feature_fn, paths,
                                    maxSizeSeq=args.maxSizeSeq,
                                    seqNorm=args.seqNorm,
                                    strict=args.strict or args.seqNorm)
    for i, rel in enumerate(rel_paths):
        stem = os.path.basename(os.path.splitext(rel)[0])
        in_path = os.path.join(args.pathDB, rel)
        export_file(feature_fn, in_path,
                    os.path.join(args.pathOut, f'{stem}.{args.format}'),
                    args.format, step_size, strict=args.strict,
                    max_size_seq=args.maxSizeSeq, seq_norm=args.seqNorm,
                    feats=None if cache is None else cache[in_path])
        if (i + 1) % 100 == 0:
            print(f"  {i + 1}/{len(rel_paths)} files")


if __name__ == "__main__":
    main(sys.argv[1:])
