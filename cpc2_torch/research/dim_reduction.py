"""Streaming PCA and Slow Feature Analysis over CPC features (counterpart of
`cpc2_tpu/research/dim_reduction.py`, reference
`cpc/criterion/research/dim_reduction.py`).

The moments accumulate in float64 on the features' device; `eigh`,
`cholesky` and the inverse are solved on the CPU in float64, as numpy does
them in the JAX package; a projection runs in fp32 where its input lies.
The state dicts keep the JAX package's names and dtypes (var, mean, PCA_mul,
PCA_values, covar_speed, ...), so a checkpoint `{state_dict, inDim, type}`
loads in either package.

Run, on the card unless `--device cpu`:
    python -m cpc2_torch.research.dim_reduction <checkpoint.pt> <out.pt> \
        --pathDB <corpus> [--mode PCA|SFA]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np
import torch

from ..training import full_fp32

Tensor = torch.Tensor


def _tensor(x, dtype=torch.float64, device=None) -> Tensor:
    t = x if isinstance(x, Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device if device is not None else t.device, dtype)


class _Reduction:
    """What PCA and SFA share: a state of named tensors on one device, moved
    where a projection's input lies."""

    _KEYS = ()

    def to(self, device) -> "_Reduction":
        for key in self._KEYS:
            setattr(self, key, getattr(self, key).to(device))
        return self

    def _on(self, x) -> Tensor:
        x = _tensor(x, torch.float32)
        if getattr(self, self._KEYS[0]).device != x.device:
            self.to(x.device)
        return x

    def state_dict(self) -> Dict[str, Tensor]:
        return {key: getattr(self, key) for key in self._KEYS}

    def load_state_dict(self, sd) -> None:
        for key in self._KEYS:
            if key in sd:
                old = getattr(self, key)
                setattr(self, key, _tensor(sd[key], old.dtype, old.device))


class PCA(_Reduction):
    """Streaming-moment PCA (reference `dim_reduction.py:13-62`)."""

    _KEYS = ('var', 'mean', 'PCA_mul', 'PCA_values')

    def __init__(self, k: int, device="cpu"):
        self.building = True
        self.var = torch.zeros((k, k), dtype=torch.float64, device=device)
        self.mean = torch.zeros(k, dtype=torch.float64, device=device)
        self.PCA_mul = torch.zeros((1, k, k), device=device)
        self.PCA_values = torch.zeros(k, device=device)
        self.N = 0
        self.normalize = True

    def update(self, x) -> None:
        x = _tensor(x, torch.float64, self.var.device)
        if x.ndim == 3:
            x = x.reshape(-1, x.shape[2])
        assert x.ndim == 2 and x.shape[1] == self.mean.shape[0]
        self.var += x.T @ x
        self.mean += x.sum(dim=0)
        self.N += x.shape[0]

    def build(self, normalize: bool = True) -> None:
        self.normalize = normalize
        self.var = self.var / self.N
        self.mean = self.mean / self.N
        self.var = self.var - torch.outer(self.mean, self.mean)
        k = self.var.shape[0]
        e_vals, e_vects = torch.linalg.eigh(self.var.cpu())
        self.PCA_mul = e_vects.T.reshape(1, k, k).float().to(self.var.device)
        self.PCA_values = e_vals.float().to(self.var.device)
        self.building = False

    def __call__(self, x) -> Tensor:
        assert not self.building
        x = self._on(x)
        reshape = x.ndim == 3
        if reshape:
            b, s, _ = x.shape
            x = x.reshape(b * s, -1)
        with full_fp32():
            x = (x - self.mean.float()) @ self.PCA_mul[0].T
        if reshape:
            x = x.reshape(b, s, -1)
        return x


class SFALinear(_Reduction):
    """Slow Feature Analysis with a Cholesky-whitened speed covariance
    (reference `dim_reduction.py:65-148`)."""

    _KEYS = ('covar_speed', 'mean_x', 'square_x', 'covar_x', 'normalizer',
             'PCA_mul', 'PCA_values', 'projection')

    def __init__(self, k: int, device="cpu"):
        f64 = dict(dtype=torch.float64, device=device)
        self.covar_speed = torch.zeros((k, k), **f64)
        self.mean_x = torch.zeros(k, **f64)
        self.square_x = torch.zeros(k, **f64)
        self.covar_x = torch.zeros((k, k), **f64)
        self.normalizer = torch.zeros((1, k, k), device=device)
        self.PCA_mul = torch.zeros((1, k, k), device=device)
        self.PCA_values = torch.zeros(k, device=device)
        self.projection = torch.zeros((1, k, k), device=device)
        self.N_speed = 0
        self.N_x = 0
        self.k = k
        self.building = True

    def update(self, x) -> None:
        x = _tensor(x, torch.float64, self.covar_x.device)
        assert x.ndim == 3 and x.shape[2] == self.k
        n, s, k = x.shape
        x = x[:, 1:]
        xt = (x[:, 1:] - x[:, :-1]).reshape(-1, k)
        self.covar_speed += xt.T @ xt
        self.N_speed += n * (s - 1)
        self.mean_x += x.sum(dim=(0, 1))
        self.square_x += (x ** 2).sum(dim=(0, 1))
        xp = x.reshape(-1, k)
        self.covar_x += xp.T @ xp
        self.N_x += n * s

    def build(self) -> None:
        device = self.covar_x.device
        mean_x = self.mean_x.cpu() / self.N_x
        covar_x = self.covar_x.cpu() / self.N_x - torch.outer(mean_x, mean_x)
        square_x = torch.sqrt(torch.clamp(
            self.square_x.cpu() / self.N_x - mean_x * mean_x, min=0))
        inv_square_x = 1 / (square_x + 1e-08)

        covar_x_normalized = (inv_square_x[:, None] * covar_x
                              * inv_square_x[None, :])
        l_ = torch.linalg.inv(torch.linalg.cholesky(covar_x_normalized))
        covar_speed = self.covar_speed.cpu() / self.N_speed
        covar_speed = (inv_square_x[:, None] * covar_speed
                       * inv_square_x[None, :])
        covar_speed = l_ @ covar_speed @ l_.T
        e_vals, e_vects = torch.linalg.eigh(covar_speed)

        k = self.k
        self.mean_x, self.covar_x, self.square_x = (
            mean_x.to(device), covar_x.to(device), square_x.to(device))
        self.covar_speed = covar_speed.to(device)
        self.normalizer = l_.reshape(1, k, k).float().to(device)
        self.PCA_mul = e_vects.T.reshape(1, k, k).float().to(device)
        self.PCA_values = e_vals.float().to(device)
        self.building = False
        self.projection = self.PCA_mul.clone()

    def selectDimensions(self, index_vector) -> None:
        keep = _tensor(index_vector, torch.float64, torch.device("cpu")) > 0
        self.projection = self.PCA_mul[0][keep.to(self.PCA_mul.device)
                                          ].reshape(1, -1, self.k)

    def __call__(self, x) -> Tensor:
        assert not self.building
        x = self._on(x)
        n, s, k = x.shape
        x = x.reshape(-1, k)
        with full_fp32():
            x = x - self.mean_x.float()[None, :]
            x = x / (self.square_x.float()[None, :] + 1e-08)
            x = x @ self.normalizer[0].T
            x = x @ self.projection[0].T
        return x.reshape(n, s, -1)


def buildPCA(dataLoader, featureMaker, k, normalize=False,
             device="cpu") -> PCA:
    """The moments on `device` (where the features lie, best)."""
    out = PCA(k, device=device)
    print("Performing the PCA...")
    with torch.no_grad():
        for index, data in enumerate(dataLoader):
            out.update(featureMaker(data))
    out.build(normalize=normalize)
    return out


def buildSFA(dataLoader, featureMaker, k, device="cpu") -> SFALinear:
    out = SFALinear(k, device=device)
    if hasattr(featureMaker, 'collapse'):
        featureMaker.collapse = False
    print("Performing the SFA...")
    with torch.no_grad():
        for index, data in enumerate(dataLoader):
            out.update(featureMaker(data))
    out.build()
    return out


def loadDimReduction(path, centroidLimits):
    """A dim-reduction checkpoint of either package, on the CPU
    (reference `dim_reduction.py:186-201`)."""
    state_dict = torch.load(path, map_location='cpu', weights_only=False)
    if state_dict["type"] == "PCA":
        dim_red = PCA(state_dict["inDim"])
    elif state_dict["type"] == "SFA":
        dim_red = SFALinear(state_dict["inDim"])
    else:
        raise ValueError(f"Invalid module type {state_dict['type']}")
    dim_red.load_state_dict(state_dict["state_dict"])
    dim_red.building = False
    if centroidLimits is not None:
        centroids_vals = np.asarray(state_dict["centroid_values"])
        dim_red.selectDimensions(
            (centroids_vals > centroidLimits[0])
            * (centroids_vals < centroidLimits[1]))
    return dim_red


def parse_args(argv) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description='Dim reduction. Performing either a PCA or a SFA')
    parser.add_argument('pathCheckpoint', type=str)
    parser.add_argument('pathOut', type=str)
    parser.add_argument('--pathDB', type=str, required=True)
    parser.add_argument('--seqList', type=str, default=None)
    parser.add_argument('--recursionLevel', type=int, default=2)
    parser.add_argument('--extension', type=str, default='.flac')
    parser.add_argument('--mode', type=str, default='SFA',
                        choices=['PCA', 'SFA'])
    parser.add_argument('--debug', action='store_true')
    parser.add_argument('--batchSize', type=int, default=8)
    parser.add_argument('--sizeWindow', type=int, default=20480)
    parser.add_argument('--device', type=str, default='cuda',
                        choices=['cuda', 'cpu'],
                        help="Where to extract the features and accumulate "
                        "the moments; cuda raises when no card is present.")
    return parser.parse_args(argv)


def main(argv):
    """The reference's `dim_reduction.py` __main__ block: the features of
    a sequential pass over the corpus (the context network's state carried
    from batch to batch), their PCA or SFA, saved with the run's flags
    beside it (`<out>_args.json`)."""
    from random import shuffle

    from ..data.corpus import filter_seqs, find_all_seqs
    from ..data.dataset import AudioBatchData
    from ..feature_loader import FeatureModule, load_model
    from ..io.checkpoint import get_checkpoint_data
    from ..training import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)

    seqNames, speakers = find_all_seqs(args.pathDB,
                                       speaker_level=args.recursionLevel,
                                       extension=args.extension)
    if args.seqList is not None:
        seqNames = filter_seqs(args.seqList, seqNames)
    if args.debug:
        shuffle(seqNames)
        seqNames = seqNames[:100]

    dataset = AudioBatchData(args.pathDB, args.sizeWindow, seqNames, None,
                             len(speakers))
    train_loader = dataset.getDataLoader(args.batchSize, "sequential", False)

    model = load_model([args.pathCheckpoint])[0].to(device)
    feature_maker = FeatureModule(model, False, keep_hidden=True)

    out_dim = get_checkpoint_data(
        os.path.dirname(args.pathCheckpoint))[2].hiddenGar

    try:
        if args.mode == 'SFA':
            feature_maker.collapse = False
            dim_reduction = buildSFA(train_loader, feature_maker, out_dim,
                                     device=device)
        else:
            dim_reduction = buildPCA(train_loader, feature_maker, out_dim,
                                     device=device)
    finally:
        dataset.close()

    out_state_dict = {"state_dict": {k: v.detach().to("cpu", copy=True)
                                     for k, v in
                                     dim_reduction.state_dict().items()},
                      "inDim": out_dim,
                      "type": args.mode}
    torch.save(out_state_dict, args.pathOut)
    path_args = f"{os.path.splitext(args.pathOut)[0]}_args.json"
    with open(path_args, 'w') as f:
        json.dump(vars(args), f, indent=2)
    return dim_reduction


if __name__ == "__main__":
    main(sys.argv[1:])
