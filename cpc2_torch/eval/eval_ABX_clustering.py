"""ABX discriminability of discrete units (counterpart of
`cpc2_tpu/eval/eval_ABX_clustering.py`, reference
`cpc/eval/eval_ABX_clustering.py`): score either

* a clustering checkpoint applied to the CPC features as they are made
  (``--clustering``): hard one-hot unit indicators, or the distances to the
  centroids with ``--soft-clustering``; or
* a ``quantized_outputs.txt`` table (``--quantized``).

Both go through the port's `eval_ABX.ABX` on `--device`. The four layouts of
a multi-group clustering (seq, concat, combine, onehot) are small functions
of the (T, G) id matrix (`GROUP_MERGERS`), as in the JAX package.

Run, on the card unless `--device cpu`:
    python -m cpc2_torch.eval.eval_ABX_clustering --clustering <ck.pt> \
        --path_audio_data <corpus> --path_abx_item <file.item>
(or ``--quantized quantized_outputs.txt ...``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

from ..clustering.clustering import load_clustering_checkpoint
from ..feature_loader import FeatureModule, build_feature, load_model
from ..training import resolve_device
from .eval_ABX import ABX


# ---------------------------------------------------------------------------
# small pure helpers
# ---------------------------------------------------------------------------

def indicator(ids: np.ndarray, width: int) -> np.ndarray:
    """(T,) int ids -> (T, width) float32 one-hot rows."""
    return np.eye(width, dtype=np.float32)[np.asarray(ids, np.int64)]


def load_pair_vocabulary(path) -> dict:
    """Multi-group token vocabulary: each nonempty line is ``token ...``;
    the token (e.g. ``65-241``) maps to its line rank."""
    vocab = {}
    with open(path, "r") as f:
        for line in f:
            fields = line.split()
            if fields:
                vocab[fields[0]] = len(vocab)
    return vocab


def parse_quantized_table(path) -> dict:
    """``quantized_outputs.txt`` -> {file stem: raw comma-joined frames}."""
    table = {}
    with open(path, "r") as f:
        for line in f:
            name, _, frames = line.rstrip("\n").partition("\t")
            table[Path(name).stem] = frames
    return table


def _stack_groups(ids: np.ndarray, n_groups: int) -> np.ndarray:
    """(T*G,) interleaved ids -> (T, G)."""
    return np.asarray(ids, np.int64).reshape(-1, n_groups)


# Multi-group layouts: each maps the (T, G) id matrix to the 2-D features
# ABX reads; `vocab` is used by 'onehot' alone.
#   seq     - groups unrolled along time: (T*G, n_units), frame rate x G
#   concat  - the G indicators side by side: (T, G*n_units)
#   combine - the union of the G indicators in one n_units-wide row
#   onehot  - each id tuple one token of a given vocabulary
def _merge_seq(idm, n_units, vocab):
    return indicator(idm.reshape(-1), n_units)


def _merge_concat(idm, n_units, vocab):
    return indicator(idm.reshape(-1), n_units).reshape(idm.shape[0], -1)


def _merge_combine(idm, n_units, vocab):
    per_group = [indicator(idm[:, g], n_units) for g in range(idm.shape[1])]
    out = per_group[0]
    for other in per_group[1:]:
        out = np.maximum(out, other)
    return out


def _merge_onehot(idm, n_units, vocab):
    tokens = ["-".join(str(v) for v in row) for row in idm]
    return indicator(np.array([vocab[t] for t in tokens]), len(vocab))


GROUP_MERGERS = {
    "seq": _merge_seq,
    "concat": _merge_concat,
    "combine": _merge_combine,
    "onehot": _merge_onehot,
}


def _find_run_config(checkpoint: Path) -> Path:
    """The clustering run's flags beside its checkpoint (``args.json``, or
    a training run's ``checkpoint_args.json``)."""
    for candidate in ("args.json", "checkpoint_args.json"):
        p = checkpoint.parent / candidate
        if p.is_file():
            return p
    raise RuntimeError(
        f"No args.json / checkpoint_args.json next to {checkpoint}: "
        f"cannot recover the clustering run's configuration")


def read_args(pathArgs):
    print(f"Loading args from {pathArgs}")
    with open(pathArgs, "r") as f:
        return argparse.Namespace(**json.load(f))


def write_json(filepath, scores):
    Path(filepath).parent.mkdir(parents=True, exist_ok=True)
    with open(filepath, "w") as f:
        json.dump(scores, f, indent=2)


def load_cpc_feature_maker(CPC_path_checkpoint, encoder_layer=False,
                           keepHidden=True, gru_level=-1, device="cuda"):
    """A CPC checkpoint's feature maker on `device`, optionally cut to an
    intermediate recurrent level (`gru_level`)."""
    overrides = None
    if gru_level is not None and gru_level > 0:
        overrides = argparse.Namespace(nLevelsGRU=gru_level)
    model = load_model([CPC_path_checkpoint], loadStateDict=True,
                       updateConfig=overrides)[0].to(device)
    print(f"Feature maker ready ({CPC_path_checkpoint})")
    return FeatureModule(model, get_encoded=encoder_layer,
                         keep_hidden=keepHidden)


# ---------------------------------------------------------------------------
# feature sources
# ---------------------------------------------------------------------------

class ClusteringFeatures:
    """CPC features quantized through a clustering checkpoint as they are
    made, the distances taken on `device` (reference
    ``eval_ABX_clustering.py`` ClusteringFeatures)."""

    def __init__(self, clustering_path_checkpoint, soft_clustering=False,
                 encoder_layer=False, keepHidden=True, group_modes="concat",
                 onehot_dict=None, device="cuda"):
        if group_modes not in GROUP_MERGERS:
            raise ValueError(f"Unknown group mode {group_modes!r}; "
                             f"expected one of {sorted(GROUP_MERGERS)}")
        ckpt = Path(clustering_path_checkpoint)
        if ckpt.suffix != ".pt":
            raise ValueError(f"Expected a .pt clustering checkpoint, "
                             f"got {ckpt}")
        self.group_modes = group_modes
        self.soft_clustering = soft_clustering

        run_args = read_args(_find_run_config(ckpt))
        print("\nClustering args:\n"
              + json.dumps(vars(run_args), indent=4, sort_keys=True))
        print("-" * 50)

        self.featureMaker = load_cpc_feature_maker(
            run_args.pathCheckpoint, encoder_layer=encoder_layer,
            keepHidden=keepHidden,
            gru_level=vars(run_args).get("level_gru", None), device=device)
        self.clusterModule = load_clustering_checkpoint(ckpt).to(device)

        feat_dim = self.featureMaker.out_feature_dim
        self.dim_clusters = self.clusterModule.Ck.shape[-1]
        if feat_dim % self.dim_clusters:
            raise ValueError(
                f"Feature dim {feat_dim} is not a multiple of the cluster "
                f"dim {self.dim_clusters}: no group split")
        self.n_groups = feat_dim // self.dim_clusters

        self.pair2idx = None
        if self.n_groups > 1 and self.group_modes == "onehot":
            assert onehot_dict is not None, (
                "onehot grouping over multiple groups needs --onehot-dict "
                "(the unit-tuple vocabulary)")
            self.pair2idx = load_pair_vocabulary(onehot_dict)
        self._cpc_cache = {}

    def prime(self, paths):
        """The CPC features of `paths` up front, files of equal length as
        one batch (`build_feature_files`), each file's those of the per-file
        path."""
        from ..feature_loader import build_feature_files
        self._cpc_cache.update(build_feature_files(
            self.featureMaker, paths, seqNorm=False, strict=True,
            maxSizeSeq=64000))

    def feature_function(self, x):
        cached = self._cpc_cache.get(str(x))
        feats = (cached if cached is not None
                 else build_feature(self.featureMaker, x, seqNorm=False,
                                    strict=True, maxSizeSeq=64000))
        # the feature channels regrouped into the clusters' spaces
        dists = self.clusterModule(np.asarray(feats).reshape(
            1, -1, self.dim_clusters))
        if self.soft_clustering:
            return dists[0].cpu().numpy()
        units = dists.argmin(dim=-1)[0].cpu().numpy()
        n_units = self.clusterModule.Ck.shape[1]
        if self.n_groups > 1:
            merger = GROUP_MERGERS[self.group_modes]
            flat = merger(_stack_groups(units, self.n_groups), n_units,
                          self.pair2idx)
        else:
            flat = indicator(units, n_units)
        return flat[None]

    @property
    def step_feature_multiplication(self):
        # 'seq' unrolls the G groups along time: G times the frame rate
        return self.n_groups if self.group_modes == "seq" else 1


class QuantizedClustering:
    """Unit ids replayed from a ``quantized_outputs.txt`` (reference
    ``eval_ABX_clustering.py`` QuantizedClustering). Multi-group tables
    hold ``-``-joined tuples and need the vocabulary file."""

    def __init__(self, quantized_file, onehot_dict=None):
        raw = parse_quantized_table(quantized_file)
        sample = next(iter(raw.values())).split(",")[0]
        multi_group = not sample.isdigit()
        assert not multi_group or onehot_dict is not None, (
            "multi-group quantized outputs (tokens like '65-241') need "
            "--onehot-dict to map tuples to unit ids")

        vocab = None
        if onehot_dict:
            print(f"\nLoading onehot dictionary from {onehot_dict}...")
            vocab = load_pair_vocabulary(onehot_dict)

        self.frames_dict = {}
        top = -1
        for stem, frames in raw.items():
            tokens = frames.split(",")
            ids = ([vocab[t] for t in tokens] if vocab
                   else [int(t) for t in tokens])
            top = max(top, max(ids))
            self.frames_dict[stem] = ids
        self.n_units = top + 1
        print(f"\nNumber of quantized units: {self.n_units}")

    def feature_function(self, x):
        ids = self.frames_dict[Path(str(x)).stem]
        return indicator(np.asarray(ids), self.n_units)[None]

    @property
    def step_feature_multiplication(self):
        return 1


# ---------------------------------------------------------------------------
# scoring and the command line
# ---------------------------------------------------------------------------

def eval_ABX_Librispeech(path_data, path_item_file, feature_function,
                         modes="within", feature_size=0.01,
                         distance_mode="cosine", file_extension=".flac",
                         debug=False, path_output=None, device="cuda"):
    """Score one feature source over a corpus on `device`; write the JSON
    with `path_output` (reference ``eval_ABX_clustering.py``
    eval_ABX_Librispeech: its kwargs and JSON layout)."""
    if modes not in ("within", "across", "all"):
        raise ValueError(f"bad mode {modes!r}")
    if distance_mode not in ("cosine", "euclidian"):
        raise ValueError(f"bad distance {distance_mode!r}")
    if path_output is not None and os.path.exists(path_output):
        raise FileExistsError(
            f"Refusing to overwrite existing output {path_output}")

    mode_list = ["within", "across"] if modes == "all" else [modes]

    found = sorted(Path(path_data).glob(f"**/*{file_extension}"))
    if debug:
        found = found[:100]
    seq_list = [(p.stem, str(p)) for p in found]

    # A source that can extract up front (ClusteringFeatures) does every
    # file the item file names in batches.
    owner = getattr(feature_function, '__self__', None)
    if hasattr(owner, 'prime'):
        from .abx.abx_iterators import load_item_file
        needed = set(load_item_file(path_item_file)[0].keys())
        owner.prime([p for stem, p in seq_list if stem in needed])

    scores = ABX(feature_function, path_item_file, seq_list, distance_mode,
                 1.0 / feature_size, mode_list, cuda=False, max_x_across=5,
                 max_size_group=10, normalize=True, device=device)

    if path_output is not None:
        scores["args"] = {"modes": mode_list, "feature_size": feature_size,
                          "distance_mode": distance_mode,
                          "path_data": str(path_data),
                          "file_extension": file_extension, "debug": debug}
        if debug:
            scores["args"]["debug_size"] = len(seq_list)
        write_json(path_output, scores)
    return scores


def _build_feature_source(args, device):
    if args.clustering:
        return ClusteringFeatures(
            args.clustering, soft_clustering=args.soft_clustering,
            encoder_layer=False, keepHidden=True,
            group_modes=args.group_modes, onehot_dict=args.onehot_dict,
            device=device)
    return QuantizedClustering(args.quantized, onehot_dict=args.onehot_dict)


def parse_args(argv):
    parser = argparse.ArgumentParser(
        description="ABX over discrete units: quantize through a clustering "
                    "checkpoint (--clustering) or replay a precomputed "
                    "table (--quantized)")
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--quantized", type=str, default=None)
    source.add_argument("--clustering", type=str, default=None)
    parser.add_argument("--name-output", type=str, default=None)
    parser.add_argument("--modes", choices=["all", "within", "across"],
                        default="all")
    parser.add_argument("--feature-size", type=float, default=0.01)
    parser.add_argument("--gru", type=int, default=-1)
    parser.add_argument("--file-extension", type=str, default=".flac")
    parser.add_argument("--soft-clustering", "-s", action="store_true")
    parser.add_argument("--group-modes", choices=sorted(GROUP_MERGERS),
                        default="onehot")
    parser.add_argument("--onehot-dict", type=str, default=None)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--no-save", action="store_true")
    parser.add_argument("--path_audio_data", type=str, required=True)
    parser.add_argument("--path_abx_item", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="Where to extract, quantize and score; cuda "
                        "raises when no card is present.")
    return parser.parse_args(argv)


def main(argv):
    args = parse_args(argv)
    device = resolve_device(args.device)
    source = _build_feature_source(args, device)

    print("\nFeature function args:\n"
          + json.dumps(vars(args), indent=4, sort_keys=True))
    print("-" * 50)

    # 'seq' grouping makes G frames a model frame: the item file's times
    # map at that rate
    rate_divisor = source.step_feature_multiplication
    return eval_ABX_Librispeech(
        path_data=args.path_audio_data, path_item_file=args.path_abx_item,
        feature_function=source.feature_function, modes=args.modes,
        feature_size=args.feature_size / max(rate_divisor, 1),
        distance_mode="cosine", file_extension=args.file_extension,
        debug=args.debug, path_output=args.name_output, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
