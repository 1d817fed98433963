"""Quantization CLI (counterpart of
`cpc2_tpu/clustering/clustering_quantization.py`, reference
`cpc/clustering/clustering_quantization.py`): per corpus file, the features
of the CPC checkpoint a clustering run was fit on, then each frame's nearest
centroid, written as ``quantized_outputs.txt`` lines ``name\\tid,id,...``
('-'-joined across the groups of a multi-group clustering).

Run, on the card unless `--device cpu`:
    python -m cpc2_torch.clustering.clustering_quantization \
        <clustering checkpoint.pt> <corpus> <output dir> [--nobatch]
The clustering run's `args.json` (of either package) must lie beside its
checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .clustering import load_clustering_checkpoint


def parseArgs(argv):
    parser = argparse.ArgumentParser(
        description="Quantize audio files using CPC Clustering Module.")
    parser.add_argument("pathCheckpoint", type=str,
                        help="Path to the clustering checkpoint.")
    parser.add_argument("pathDB", type=str,
                        help="Path to the dataset that we want to quantize.")
    parser.add_argument("pathOutput", type=str,
                        help="Path to the output directory.")
    parser.add_argument("--split", type=str, default=None,
                        help="If you want to divide the dataset in small "
                        "splits, specify it with idxSplit-numSplits "
                        "(idxSplit > 0), eg. --split 1-20.")
    parser.add_argument("--file_extension", type=str, default=".flac",
                        help="Extension of the audio files in the dataset "
                        "(default: .flac).")
    parser.add_argument("--max_size_seq", type=int, default=10240,
                        help="Maximal number of frames to consider when "
                        "computing a batch of features (defaut: 10240).")
    parser.add_argument("--batch_size", type=int, default=8,
                        help="Batch size used to compute features when "
                        "computing each file (defaut: 8).")
    parser.add_argument("--strict", type=bool, default=True,
                        help="If activated, each batch of feature will "
                        "contain exactly max_size_seq frames (defaut: True).")
    parser.add_argument("--debug", action="store_true",
                        help="Load only a very small amount of files for "
                        "debugging purposes.")
    parser.add_argument("--nobatch", action="store_true",
                        help="Don't use batch implementation when building "
                        "features (uses stateful RNN carry instead).")
    parser.add_argument("--recursionLevel", type=int, default=1,
                        help="Speaker level in pathDB (defaut: 1).")
    parser.add_argument("--separate-speaker", action="store_true",
                        help="Separate each speaker with a different "
                        "output file.")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="Where to extract the features and quantize; "
                        "cuda raises when no card is present.")
    return parser.parse_args(argv)


def split_slice(n_files: int, spec: str):
    """Range of file indices for a ``idxSplit-numSplits`` spec (1-based;
    the last split absorbs the remainder)."""
    parts = spec.split("-")
    if len(parts) != 2 or not (int(parts[1]) >= int(parts[0]) >= 1):
        raise ValueError("SPLIT must be under the form idxSplit-numSplits")
    idx, total = map(int, parts)
    per = n_files // total
    start = per * (idx - 1)
    end = n_files if idx == total else min(per * idx, n_files)
    return start, end, idx, total


def feature_fn_for_clustering(clustering_args, nobatch: bool,
                              device="cuda"):
    """The feature maker the centroids were fit with, on `device`: the CPC
    checkpoint named in the clustering run's args.json, its `level_gru`,
    its encoder or context choice, its `train_mode` (the dropout on while
    the features are made) and any dim-reduction projection."""
    from ..feature_loader import FeatureModule, load_model

    override = None
    if getattr(clustering_args, 'level_gru', None) is not None:
        override = argparse.Namespace(
            nLevelsGRU=clustering_args.level_gru)
    model = load_model([clustering_args.pathCheckpoint],
                       updateConfig=override)[0].to(device)
    fn = FeatureModule(
        model, clustering_args.encoder_layer, keep_hidden=nobatch,
        train_mode=getattr(clustering_args, 'train_mode', False))
    if getattr(clustering_args, 'dimReduction', None) is not None:
        from ..research.dim_reduction import loadDimReduction
        project = loadDimReduction(clustering_args.dimReduction,
                                   clustering_args.centroidLimits)
        base = fn
        return lambda data: project(base(data))
    return fn


def ids_line(feats, cluster_module) -> str:
    """Features (1, frames, D) -> the file's quantized line: per frame, the
    nearest centroid of each group, '-'-joined across groups, ','-joined
    over time. The distances are taken where `cluster_module` lies."""
    dim = cluster_module.Ck.shape[-1]
    groups = feats.shape[-1] // dim
    x = feats if isinstance(feats, torch.Tensor) else torch.as_tensor(
        np.asarray(feats))
    ids = cluster_module(x.reshape(1, -1, dim)).argmin(dim=-1)[0]
    ids = ids.reshape(-1, groups).tolist()
    return ",".join("-".join(str(v) for v in row) for row in ids)


def quantize_file(path, feature_fn, cluster_module, args) -> str:
    """One file -> its quantized line (the per-file extraction)."""
    from ..feature_loader import build_feature, build_feature_batch

    if args.nobatch:
        feats = build_feature(feature_fn, path, seqNorm=False,
                              strict=args.strict,
                              maxSizeSeq=args.max_size_seq)
    else:
        feats = build_feature_batch(feature_fn, path, seqNorm=False,
                                    strict=args.strict,
                                    maxSizeSeq=args.max_size_seq,
                                    batch_size=args.batch_size)
    return ids_line(feats, cluster_module)


def write_quantized(out_dir, out_name, entries, by_speaker_level=None):
    """`entries` = [(rel_path, line)]. One combined file, or with
    `by_speaker_level` one ``<speaker>_<out_name>`` per speaker (the path
    component at that level), as the JAX package writes them."""
    def fmt(rel, line):
        return os.path.splitext(os.path.basename(rel))[0] + "\t" + line

    if by_speaker_level is None:
        target = os.path.join(out_dir, out_name)
        with open(target, "w") as f:
            f.write("\n".join(fmt(rel, ln) for rel, ln in entries))
        print(f"wrote {target}")
        return
    grouped = {}
    for rel, ln in entries:
        speaker = rel.split("/")[by_speaker_level - 1]
        grouped.setdefault(speaker, []).append(fmt(rel, ln))
    for speaker, lines in grouped.items():
        target = os.path.join(out_dir, f"{speaker}_{out_name}")
        with open(target, "w") as f:
            f.write("\n".join(lines))
        print(f"wrote {target}")


def main(argv):
    from ..data.corpus import find_all_seqs
    from ..training import resolve_device

    args = parseArgs(argv)
    device = resolve_device(args.device)
    os.makedirs(args.pathOutput, exist_ok=True)

    files, speakers = find_all_seqs(args.pathDB,
                                    speaker_level=args.recursionLevel,
                                    extension=args.file_extension,
                                    loadCache=True)
    print(f"Quantizing {len(files)} files ({len(speakers)} speakers) "
          f"from {args.pathDB}")

    out_name = "quantized_outputs.txt"
    if args.split:
        start, end, idx, total = split_slice(len(files), args.split)
        files = files[start:end]
        out_name = f"quantized_outputs_split_{idx}-{total}.txt"
        print(f"split {idx}/{total}: files [{start}, {end})")
    if args.debug:
        files = files[:20]

    if not args.separate_speaker:
        target = os.path.join(args.pathOutput, out_name)
        if os.path.exists(target):
            raise FileExistsError(f"Output file {target} already exists !!!")

    if not args.pathCheckpoint.endswith(".pt"):
        raise ValueError("expected a .pt clustering checkpoint")
    with open(os.path.join(os.path.dirname(args.pathCheckpoint),
                           "args.json")) as f:
        clustering_args = argparse.Namespace(**json.load(f))
    print("clustering run args: "
          + json.dumps(vars(clustering_args), sort_keys=True))

    cluster_module = load_clustering_checkpoint(args.pathCheckpoint).to(
        device)
    feature_fn = feature_fn_for_clustering(clustering_args, args.nobatch,
                                           device)

    t0 = time.time()
    entries = []
    # --nobatch with the plain feature maker: files of equal length run as
    # one batch, the context network's state carried across their chunks
    # (`feature_loader.build_feature_files`), each file's features those of
    # `build_feature`. A projected maker keeps the per-file loop.
    cache = None
    if args.nobatch and hasattr(feature_fn, 'reset_hidden'):
        from ..feature_loader import build_feature_files
        paths = [os.path.join(args.pathDB, rel) for _, rel in files]
        cache = build_feature_files(feature_fn, paths, seqNorm=False,
                                    strict=args.strict,
                                    maxSizeSeq=args.max_size_seq)
    for i, (_, rel) in enumerate(files):
        path = os.path.join(args.pathDB, rel)
        if cache is not None:
            entries.append((rel, ids_line(cache[path], cluster_module)))
        else:
            entries.append((rel, quantize_file(path, feature_fn,
                                               cluster_module, args)))
        if (i + 1) % 100 == 0:
            print(f"  {i + 1}/{len(files)} files")
    print(f"quantized {len(entries)} files in {time.time() - t0:.1f}s")

    write_quantized(args.pathOutput, out_name, entries,
                    by_speaker_level=(args.recursionLevel
                                      if args.separate_speaker else None))
    return entries


if __name__ == "__main__":
    main(sys.argv[1:])
