"""Fit a CCA projection between the representation spaces of two CPC
checkpoints (counterpart of `cpc2_tpu/research/train_cca.py`, reference
`cpc/criterion/cca/train_cca.py`: the same flags and artifacts, and
`--device`).

The projection aligns model X's feature space with model Y's; at
inference `FeatureModule(cca_projection=...)` applies the X side. Both
views are extracted on the device, and the fit (`research/cca.py:fit_cca`,
scikit-learn's algorithm in float64) runs there too. Artifacts written to
--path_output:

* ``cca_model_n_components_<n>.pkl``: the pickled `CCAProjection`;
* ``CCA_info_args.json``: the CLI arguments of the fit.

Run, on the card unless `--device cpu` (or `--cpu`):
    python -m cpc2_torch.research.train_cca --path_cp_X <a.pt> \
        --path_cp_Y <b.pt> --path_db <corpus> --path_output <dir>
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

import numpy as np

from ..training import resolve_device
from .cca import fit_cca


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description='Fit a CCA aligning the representations of two CPC '
                    'checkpoints over a shared corpus.')
    p.add_argument('--path_cp_X', type=str,
                   help='Checkpoint whose features form the X view.')
    p.add_argument('--path_cp_Y', type=str,
                   help='Checkpoint whose features form the Y view.')
    p.add_argument('--path_db', type=str,
                   help='Audio corpus both views are extracted from.')
    p.add_argument('--path_output', type=str,
                   help='Directory for the pickled CCA + args record.')
    p.add_argument('--n_components', type=int, default=100,
                   help='Dimension of the shared CCA space.')
    p.add_argument('--file_extension', type=str, default=".wav")
    p.add_argument('--max_size_seq', type=int, default=10240,
                   help='Chunk length (samples) for feature extraction.')
    p.add_argument('--batch_size', type=int, default=8,
                   help='Chunks per forward in the batched extractor.')
    p.add_argument('--strict', type=bool, default=True)
    p.add_argument('--debug', action='store_true',
                   help='Cap the corpus at 1000 files.')
    p.add_argument('--no_batch', action='store_true',
                   help='Chunk-sequential extraction with hidden carry '
                   'instead of the batched splitter.')
    p.add_argument('--cpu', action='store_true',
                   help='Run on the CPU (the same as --device cpu).')
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help="Where to extract the features and fit; cuda "
                   "raises when no card is present.")
    return p


def corpus_files(path_db: str, extension: str):
    """All corpus files (relative paths), tolerating a stale
    `_seqs_cache.txt` written for another extension: if the cached list's
    entries do not carry `extension`, the tree is scanned again."""
    from ..data.corpus import find_all_seqs

    found, _ = find_all_seqs(path_db, speaker_level=0, extension=extension,
                             loadCache=True)
    stale = found and not os.path.splitext(found[0][1])[1].endswith(
        extension)
    if stale or not found:
        found, _ = find_all_seqs(path_db, speaker_level=0,
                                 extension=extension, loadCache=False)
    return [rel for _, rel in found]


def checkpoint_extractor(cp_path: str, *, no_batch: bool, strict: bool,
                         max_size_seq: int, batch_size: int,
                         device="cuda"):
    """`extract(file_path) -> (T, D)` features of one checkpoint, on
    `device`. The checkpoint's own training flags (the sibling
    ``checkpoint_args.json``) decide whether they come from the context
    network or the encoder (`onEncoder`)."""
    from ..feature_loader import (FeatureModule, build_feature,
                                  build_feature_batch, load_model)

    if not cp_path.endswith('.pt'):
        raise ValueError(f"expected a .pt checkpoint, got {cp_path}")
    if not os.path.exists(cp_path):
        raise FileNotFoundError(cp_path)
    cfg_path = os.path.join(os.path.dirname(cp_path),
                            "checkpoint_args.json")
    with open(cfg_path) as f:
        on_encoder = json.load(f).get('onEncoder', False)

    model = load_model([cp_path])[0].to(device)
    module = FeatureModule(model, on_encoder, keep_hidden=no_batch)

    def extract(file_path: str) -> np.ndarray:
        if no_batch:
            feats = build_feature(module, file_path, seqNorm=False,
                                  strict=strict)
        else:
            feats = build_feature_batch(module, file_path, seqNorm=False,
                                        strict=strict,
                                        maxSizeSeq=max_size_seq,
                                        batch_size=batch_size)
        return feats[0]                       # (1, T, D) -> (T, D)

    return extract


def main(argv):
    args = build_parser().parse_args(argv)
    device = resolve_device('cpu' if args.cpu else args.device)

    os.makedirs(args.path_output, exist_ok=True)
    with open(os.path.join(args.path_output, "CCA_info_args.json"),
              'w') as f:
        json.dump(vars(args), f, indent=2)

    files = corpus_files(args.path_db, args.file_extension)
    if args.debug:
        files = files[:1000]
    if not files:
        raise RuntimeError(
            f"no {args.file_extension} files under {args.path_db} to fit "
            "the CCA on")
    print(f"CCA fit over {len(files)} files from {args.path_db}")

    opts = dict(no_batch=args.no_batch, strict=args.strict,
                max_size_seq=args.max_size_seq,
                batch_size=args.batch_size, device=device)
    extract_x = checkpoint_extractor(args.path_cp_X, **opts)
    extract_y = checkpoint_extractor(args.path_cp_Y, **opts)

    t0 = time.time()
    views = {'x': [], 'y': []}
    for rel in files:
        path = os.path.join(args.path_db, rel)
        views['x'].append(extract_x(path))
        views['y'].append(extract_y(path))
    mat_x = np.vstack(views['x'])
    mat_y = np.vstack(views['y'])
    print(f"extracted {mat_x.shape[0]} frames per view "
          f"in {time.time() - t0:.1f}s")

    t0 = time.time()
    cca = fit_cca(mat_x, mat_y, args.n_components, device=device)
    print(f"fitted {args.n_components} components on {device} in "
          f"{time.time() - t0:.1f}s")

    out = os.path.join(args.path_output,
                       f"cca_model_n_components_{args.n_components}.pkl")
    with open(out, 'wb') as f:
        pickle.dump(cca, f)
    print(f"wrote {out}")
    return cca


if __name__ == "__main__":
    main(sys.argv[1:])
