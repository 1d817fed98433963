"""Clustering CLI (counterpart of `cpc2_tpu/clustering/clustering_script.py`,
reference `cpc/clustering/clustering_script.py:174-304`).

Fits k-means or DP-means centroids over the features of a CPC checkpoint
and writes the reference's clustering checkpoints (`checkpoint_<it>.pt`
with `--save`'s intermediate ones, `checkpoint_last.pt`) and an `args.json`
snapshot of the flags, which the quantization and unit-ABX CLIs of either
package read. The stages are the JAX package's: sequence selection, the
corpus and its uniform-window loader (`--batchSizeGPU` windows a batch, on
one card), the feature maker, the fit, the save.

Run, on the card unless `--device cpu`:
    python -m cpc2_torch.clustering.clustering_script <cpc_checkpoint.pt> \
        <output dir> <corpus> [-k 50] [--DPMean -l 11] [--load <ck.pt>]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from random import shuffle

import numpy as np
import torch

from .clustering import (distanceEstimation, fastDPMean, kMeanGPU,
                         save_clustering_checkpoint)

# (flags, kwargs): the JAX package's table, names, defaults and help, plus
# `--device`.
_FLAG_TABLE = [
    (("pathCheckpoint",),
     dict(type=str, help="Path to the checkpoint of CPC module.")),
    (("dirOutput",),
     dict(type=str, help="Path to the output clustering checkpoint.")),
    (("pathDB",),
     dict(type=str, help="Path to the root directory containing the audio "
          "files to process")),
    (("-k", "--nClusters"),
     dict(type=int, default=50,
          help="Number of clusters for kmeans algorithm (default: 50).")),
    (("-g", "--nGroups"),
     dict(type=int, default=1,
          help="Number of groups for kmeans algorithm (default: 1).")),
    (("-n", "--MAX_ITER"),
     dict(type=int, default=100,
          help="Number of iterations (default: 100).")),
    (("--recursionLevel",),
     dict(type=int, default=2,
          help="The speaker recursionLevel in the training dataset "
          "(default: 2).")),
    (("--extension",),
     dict(type=str, default=".flac",
          help="The audio file extension (default: .flac).")),
    (("--seqList",),
     dict(type=str, default=None,
          help="Specific the training sequence list (default: None).")),
    (("--sizeWindow",),
     dict(type=int, default=10240,
          help="The size of the window when loading audio data "
          "(default: 10240).")),
    (("--debug",),
     dict(action="store_true",
          help="Debug mode, only use a small number of training data.")),
    (("--encoder_layer",),
     dict(action="store_true",
          help="Whether to use the output of the encoder for the "
          "clustering.")),
    (("--level_gru",),
     dict(type=int, default=None,
          help="Specify the LSTM hidden level to take the representation "
          "(default: None).")),
    (("--batchSizeGPU",),
     dict(type=int, default=50,
          help="Batch size of each GPU (default: 50).")),
    (("--DPMean",),
     dict(action="store_true",
          help="Activate DPMeans training instead of Kmeans.")),
    (("-l", "--DPLambda"),
     dict(type=float, default=11,
          help="Lambda parameter of DPMeans algo (default: 11).")),
    (("--perIterSize",),
     dict(type=int, default=-1,
          help="Number of items per iteration (default: -1).")),
    (("--train_mode",),
     dict(action="store_true", help="Activate training CPC module too.")),
    (("--dimReduction",),
     dict(type=str, default=None,
          help="Dimentionality reduction (default: None)")),
    (("--centroidLimits",),
     dict(type=int, nargs=2, default=None,
          help="centroidLimits when using dimentionality reduction "
          "(default: None)")),
    (("--getDistanceEstimation",),
     dict(action="store_true", help="Get distance estimation")),
    (("--save",),
     dict(action="store_true", help="Save the intermediate checkpoints.")),
    (("--load",),
     dict(type=str, help="Restart from the given checkpoint")),
    (("--save-last",),
     dict(type=int, default=5,
          help="Number of last checkpoints to be saved (default: 5).")),
    (("--max-size-loaded",),
     dict(type=int, default=400000000,
          help="Maximal amount of data held in memory at any given time")),
    (("--device",),
     dict(type=str, default="cuda", choices=["cuda", "cpu"],
          help="Where to extract the features and fit; cuda raises when "
          "no card is present.")),
]


def parseArgs(argv):
    parser = argparse.ArgumentParser(
        description="Clustering module using kmeans or dpmeans.")
    for flags, kwargs in _FLAG_TABLE:
        parser.add_argument(*flags, **kwargs)
    args = parser.parse_args(argv)
    for attr in ("pathCheckpoint", "dirOutput", "pathDB"):
        setattr(args, attr, Path(getattr(args, attr)).resolve())
    return args


def getQuantile(sorted_data, percent):
    return sorted_data[int(percent * len(sorted_data))]


def _select_sequences(args):
    """Stage 1: the corpus's files (a list's, with `--seqList`), a random
    subset with `--debug` or `--getDistanceEstimation`."""
    from ..data.corpus import filter_seqs, find_all_seqs

    names, speakers = find_all_seqs(str(args.pathDB),
                                    speaker_level=args.recursionLevel,
                                    extension=args.extension,
                                    loadCache=True)
    if args.seqList is not None:
        names = filter_seqs(args.seqList, names)
    cap = None
    if args.debug:
        cap = 1000
    elif args.getDistanceEstimation:
        cap = 5000
    if cap is not None:
        print(f"[clustering] subsampling corpus to <= {cap} sequences")
        shuffle(names)
        names = names[:cap]
    return names, speakers


def _make_loader(args, seq_names, speakers):
    """Stage 2: the corpus in memory and its uniform-window loader,
    `--batchSizeGPU` windows a batch (one card)."""
    from ..data.dataset import AudioBatchData

    t0 = time.time()
    corpus = AudioBatchData(args.pathDB, args.sizeWindow, seq_names, None,
                            len(speakers),
                            MAX_SIZE_LOADED=args.max_size_loaded)
    loader = corpus.getDataLoader(args.batchSizeGPU, "uniform", False)
    print(f"[clustering] corpus ready: {len(seq_names)} files, "
          f"{len(loader)} batches of {args.batchSizeGPU} windows "
          f"({time.time()-t0:.1f}s)")
    return corpus, loader


def _make_feature_fn(args, device):
    """Stage 3: the checkpoint's feature maker on `device` (the context, or
    the encoder's output), with a saved dim-reduction projection on top."""
    from ..feature_loader import FeatureModule, load_model

    override = None
    if args.level_gru is not None:
        override = argparse.Namespace(nLevelsGRU=args.level_gru)
    model = load_model([str(args.pathCheckpoint)],
                       updateConfig=override)[0].to(device)
    fn = FeatureModule(model, args.encoder_layer, train_mode=args.train_mode)
    if args.dimReduction is not None:
        from ..research.dim_reduction import loadDimReduction
        project = loadDimReduction(args.dimReduction, args.centroidLimits)
        raw_fn = fn
        fn = lambda data: project(raw_fn(data))  # noqa: E731
    print(f"[clustering] feature model ready ({args.pathCheckpoint.name})")
    return fn


def _snapshot_config(args):
    args.dirOutput.mkdir(parents=True, exist_ok=True)
    serializable = {k: (str(v) if isinstance(v, Path) else v)
                    for k, v in vars(args).items()}
    (args.dirOutput / "args.json").write_text(
        json.dumps(serializable, indent=2))


def _run_distance_estimation(args, feature_fn, loader, device):
    """--getDistanceEstimation: the sampled pairwise-distance distribution
    and its deciles (the DP-means lambda is picked from them)."""
    print("[clustering] estimating the feature distance distribution")
    dists = distanceEstimation(feature_fn, loader, device=device)
    deciles = {x: getQuantile(dists, x) for x in np.arange(0, 1.0, 0.1)}
    (args.dirOutput / "quantiles.json").write_text(
        json.dumps(deciles, indent=2))
    with open(args.dirOutput / "raw.npy", "wb") as f:
        np.save(f, dists)


def _resume_centroids(path):
    ck = torch.load(path, map_location="cpu", weights_only=False)
    centroids = ck["state_dict"]["Ck"]
    print(f"[clustering] resuming from {path}: centroids "
          f"{tuple(centroids.shape)}")
    return centroids


def _fit(args, loader, feature_fn, start_centroids, device):
    """Stage 4: the fit (Lloyd k-means or DP-means); the centroids
    (1, k, D) on the CPU."""
    if args.DPMean:
        clusters = fastDPMean(loader, feature_fn, args.DPLambda,
                              MAX_ITER=args.MAX_ITER,
                              perIterSize=args.perIterSize,
                              save_dir=args.dirOutput,
                              save_last=args.save_last,
                              mu_start=start_centroids, device=device)
        args.nClusters = int(clusters.shape[1])
    else:
        clusters = kMeanGPU(loader, feature_fn, args.nClusters,
                            args.nGroups, perIterSize=args.perIterSize,
                            MAX_ITER=args.MAX_ITER,
                            save_dir=args.dirOutput,
                            save_last=args.save_last,
                            start_clusters=start_centroids, device=device)
    return clusters.cpu()


def main(argv):
    from ..training import resolve_device

    args = parseArgs(argv)
    device = resolve_device(args.device)
    if not args.load and args.dirOutput.is_dir():
        print(f"[clustering] refusing to overwrite existing output dir "
              f"{args.dirOutput} (use --load to resume)")
        sys.exit()

    seq_names, speakers = _select_sequences(args)
    corpus, loader = _make_loader(args, seq_names, speakers)
    try:
        feature_fn = _make_feature_fn(args, device)
        _snapshot_config(args)

        if args.getDistanceEstimation:
            _run_distance_estimation(args, feature_fn, loader, device)
            sys.exit()

        start_centroids = (_resume_centroids(args.load)
                           if args.load is not None else None)

        t0 = time.time()
        clusters = _fit(args, loader, feature_fn, start_centroids, device)
    finally:
        corpus.close()
    print(f"[clustering] fit done in {time.time() - t0:.2f}s "
          f"-> {clusters.shape[1]} clusters")
    save_clustering_checkpoint(clusters,
                               args.dirOutput / "checkpoint_last.pt")
    return clusters


if __name__ == "__main__":
    main(sys.argv[1:])
