"""k-means and DP-means quantization of CPC features (counterpart of
`cpc2_tpu/clustering/clustering.py`, reference
`cpc/clustering/clustering.py`).

The JAX package's forms are kept:

* squared distances `||f||^2 - 2 f.C^T + ||C||^2` in one product, never
  `torch.cdist` (whose formula changes with the size), so that near-ties
  break as they do there; `argmin` takes the first minimum, as `jnp.argmin`;
* one Lloyd step as a one-hot product, `onehot(assign)^T @ f` and the
  one-hot's column sums, which is also how DP-means accumulates, so that two
  runs on the card agree bit for bit (no atomics).

Every product runs in full fp32 (`training.full_fp32`), as the JAX package
forces `highest`. The sums and counts stay on the device across a pass over
the loader: k-means syncs once an iteration, DP-means once a batch (for its
`max_dist > lambda` decision). The random draws (k-means' start rows,
`distanceEstimation`'s shuffle) come from `rng`, a `numpy.random.RandomState`,
or, with `rng=None`, from numpy's global state, as in the JAX package.

Checkpoints: `{state_dict: {Ck}, n_clusters, dim, iteration, last_diff,
mode}` torch pickles with `Ck` (1, k, D) a CPU tensor, which either package
and the reference load.
"""

from __future__ import annotations

import contextlib
import logging
from os import remove
from pathlib import Path
from time import time
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import _DDP
from ..training import full_fp32, resolve_device

Tensor = torch.Tensor


def _check_mesh(mesh) -> None:
    """The port runs on one card: the JAX package's evaluation mesh belongs
    to data-parallel training."""
    if mesh not in (None, 'auto'):
        raise NotImplementedError(f"mesh={mesh!r}: not ported to cpc2_torch "
                                  f"(ROADMAP.md item: {_DDP})")


def _draws(rng: Optional[np.random.RandomState]):
    return np.random if rng is None else rng


def _rows(features, d: int, device: torch.device) -> Tensor:
    """A feature maker's output (a tensor or numpy) as fp32 rows of width
    `d` on `device`."""
    x = features if isinstance(features, Tensor) else torch.as_tensor(
        np.asarray(features))
    return x.to(device, torch.float32).reshape(-1, d)


def _sq_distances(features: Tensor, ck: Tensor) -> Tensor:
    """(N, D), (k, D) -> (N, k) squared L2 distances, by one product."""
    with full_fp32():
        f2 = (features * features).sum(dim=1, keepdim=True)
        c2 = (ck * ck).sum(dim=1)[None, :]
        return f2 - 2.0 * (features @ ck.T) + c2


def _one_hot_sums(features: Tensor, assign: Tensor, k: int
                  ) -> Tuple[Tensor, Tensor]:
    """Per-cluster sums (k, D) and counts (k,) of `features` by cluster id,
    as a one-hot product: a fixed order of additions on every run."""
    onehot = torch.nn.functional.one_hot(assign, k).to(features.dtype)
    with full_fp32():
        return onehot.T @ features, onehot.sum(dim=0)


def _lloyd_accumulate(features: Tensor, ck: Tensor) -> Tuple[Tensor, Tensor]:
    """One assignment and accumulation step: (sums (k, D), counts (k,))."""
    assign = _sq_distances(features, ck).argmin(dim=1)
    return _one_hot_sums(features, assign, ck.shape[0])


class kMeanCluster(nn.Module):
    """Distances (B, S, D) -> (B, S, k), squared L2 to each centroid
    (reference `clustering.py:24-34`). `Ck` (1, k, D) is a buffer: the
    module runs where `.to()` puts it, without gradients."""

    def __init__(self, Ck):
        super().__init__()
        ck = Ck.detach() if isinstance(Ck, Tensor) else torch.as_tensor(
            np.asarray(Ck))
        self.register_buffer("Ck", ck.to(torch.float32).clone())
        self.k = self.Ck.shape[1]

    def forward(self, features) -> Tensor:
        x = features if isinstance(features, Tensor) else torch.as_tensor(
            np.asarray(features))
        b, s, d = x.shape
        with torch.no_grad():
            dist = _sq_distances(x.to(self.Ck.device, torch.float32)
                                 .reshape(b * s, d), self.Ck[0])
        return dist.reshape(b, s, self.k)


class kMeanClusterStep:
    """One Lloyd step over a feature batch (B, S, D): (per-cluster sums
    (k, D), counts (k,)) (reference `clustering.py:37-53`)."""

    def __init__(self, k_mean_cluster: kMeanCluster):
        self.module = k_mean_cluster
        self.k = k_mean_cluster.k

    def __call__(self, features) -> Tuple[Tensor, Tensor]:
        ck = self.module.Ck[0]
        with torch.no_grad():
            return _lloyd_accumulate(
                _rows(features, ck.shape[1], ck.device), ck)


def save_clustering_checkpoint(Ck, path_out, mode=None, iter=None,
                               last_diff=None) -> None:
    """Reference format (`clustering.py:58-72`): `Ck` saved as a CPU
    tensor, whatever device it is on."""
    ck = (Ck.detach().to("cpu", copy=True) if isinstance(Ck, Tensor)
          else torch.from_numpy(np.array(Ck)))
    out = {"state_dict": {"Ck": ck.contiguous()},
           "n_clusters": int(ck.shape[1]),
           "dim": int(ck.shape[2]),
           "iteration": iter,
           "last_diff": last_diff,
           "mode": mode}
    torch.save(out, path_out)


def load_clustering_checkpoint(path) -> kMeanCluster:
    """The `kMeanCluster` of a clustering checkpoint of either package, on
    the CPU."""
    print(f"Loading ClusterModule at {path}")
    state_dict = torch.load(path, map_location='cpu', weights_only=False)
    return kMeanCluster(state_dict["state_dict"]["Ck"])


# Reference-spelled alias
loadClusterModule = load_clustering_checkpoint


def get_last_checkpoint(path_in):
    checkpoint_list = list(Path(path_in).glob("checkpoint_*.pt"))
    valid = [x for x in checkpoint_list if x.stem.split("_")[-1].isdigit()]
    valid.sort(key=lambda x: int(x.stem.split("_")[-1]))
    if len(valid) == 0:
        raise RuntimeError("No checkpoint found")
    return valid[-1]


@contextlib.contextmanager
def _log_file(logger, save_dir):
    """`save_dir/training_logs.txt` receives the fit's log lines, and only
    this fit's: the handler goes when it ends (the JAX package leaves it on
    the named logger, so a second fit in one process writes to both
    files)."""
    if save_dir is None:
        yield
        return
    handler = logging.FileHandler(Path(save_dir) / "training_logs.txt")
    logger.addHandler(handler)
    try:
        yield
    finally:
        logger.removeHandler(handler)
        handler.close()


# ---------------------------------------------------------------------------
# Mini-batch k-means (reference `clustering.py:90-205`)
# ---------------------------------------------------------------------------

def kMeanGPU(dataLoader, featureMaker, k, n_group=1, MAX_ITER=100,
             EPSILON=1e-4, perIterSize=-1, start_clusters=None,
             save_dir=None, save_last=5, mesh='auto', device="cuda",
             rng: Optional[np.random.RandomState] = None) -> Tensor:
    """Lloyd's k-means over the features of every batch of `dataLoader`
    (`perIterSize` batches an iteration), from `start_clusters` or from k
    rows drawn from the first batches' features. Returns the centroids
    (1, k, D) on `device`."""
    _check_mesh(mesh)
    device = resolve_device(str(device))
    logging.basicConfig(level=logging.INFO)
    logger = logging.getLogger("Kmean")
    save = save_dir is not None
    if save:
        save_dir = Path(save_dir)
    with _log_file(logger, save_dir), torch.no_grad():
        logger.info(f"Start Kmean clustering with {k} clusters and "
                    f"{n_group} groups...")
        if start_clusters is None:
            init_feats = []
            for index, data in enumerate(dataLoader):
                c_feature = featureMaker(data)
                init_feats.append(_rows(c_feature,
                                        c_feature.shape[2] // n_group,
                                        device))
                if index > k:
                    break
            init_feats = torch.cat(init_feats, dim=0)
            indexes = _draws(rng).permutation(init_feats.shape[0])[:k]
            ck = init_feats[torch.as_tensor(indexes, device=device)]
        else:
            ck = (start_clusters.detach() if isinstance(start_clusters, Tensor)
                  else torch.as_tensor(np.asarray(start_clusters)))
            ck = ck.to(device, torch.float32)
            if ck.ndim == 3:
                ck = ck[0]
        d = ck.shape[1]

        if perIterSize < 0:
            perIterSize = len(dataLoader)

        it, stored = 0, 0
        sum_seen = 0.0
        last_diff = float('inf')
        n_items_clusters = torch.zeros((k,), device=device)
        print("perIterSize = %.f" % perIterSize)

        while it < MAX_ITER:
            start_time = time()
            ck1 = torch.zeros((k, d), device=device)
            n_items_clusters = torch.zeros((k,), device=device)
            for index, data in enumerate(dataLoader):
                sums, counts = _lloyd_accumulate(
                    _rows(featureMaker(data), d, device), ck)
                ck1 += sums
                n_items_clusters += counts
                stored += 1
                sum_seen += data[0].shape[0] * data[0].shape[-1] / 16000
                if stored >= perIterSize:
                    break
            if stored < perIterSize:
                continue

            stored = 0
            it += 1
            print("I've seen %.2f hours in %d epochs :) More data more data "
                  "more data!" % (sum_seen / 3600, it))

            ck1 = ck1 / (n_items_clusters[:, None] + 1e-8)
            # one sync an iteration
            last_diff, n_items = torch.stack([
                torch.linalg.vector_norm(ck - ck1, dim=1).max().double(),
                n_items_clusters.sum().double()]).tolist()
            n_items = int(n_items)
            logger.info(f"ITER {it} done in {time()-start_time:.2f} seconds. "
                        f"nItems: {n_items}. Difference with last "
                        f"checkpoint: {last_diff}")

            if save:
                path_save = save_dir / f"checkpoint_{it}.pt"
                logger.info(f"Saving last checkpoint to {path_save}")
                save_clustering_checkpoint(ck1[None], path_save, iter=it,
                                           last_diff=last_diff, mode="kMean")
                old = save_dir / f"checkpoint_{it - save_last}.pt"
                if old.is_file():
                    remove(old)
            if last_diff < EPSILON:
                logger.info(f"Clustering ended in {it} iterations out of "
                            f"{MAX_ITER}")
                ck = ck1
                break
            ck = ck1

        logger.info(f"Last diff {last_diff}")
        if start_clusters is not None:
            n_empty = int((n_items_clusters < 1).sum())
            logger.info(f"{n_empty} empty clusters out of {k}")
    return ck[None]


# ---------------------------------------------------------------------------
# DP-means (reference `clustering.py:208-329`)
# ---------------------------------------------------------------------------

def fastDPMean(dataLoader, featureMaker, l, MAX_ITER=100, batchSize=1000,
               EPSILON=1e-4, perIterSize=-1, save_dir=None, save_last=5,
               mu_start=None, mesh='auto', device="cuda") -> Tensor:
    """DP-means with penalty `l`: a row farther than `l` from every centroid
    (the batch's farthest, one a batch) opens a new cluster. Returns the
    centroids (1, k, D) on `device`."""
    _check_mesh(mesh)
    device = resolve_device(str(device))
    logging.basicConfig(level=logging.INFO)
    logger = logging.getLogger("DPMean")
    save = save_dir is not None
    if save:
        save_dir = Path(save_dir)
    with _log_file(logger, save_dir), torch.no_grad():
        logger.info(f"{perIterSize} updates per iteration")
        if mu_start is not None:
            mu = (mu_start.detach() if isinstance(mu_start, Tensor)
                  else torch.as_tensor(np.asarray(mu_start)))
            mu = mu.to(device, torch.float32)
            mu = mu.reshape(-1, mu.shape[-1])
        else:
            print("Start training from scratch. Creating new mu ...")
            acc = None
            n_seqs = 100
            for index, data in enumerate(dataLoader):
                features = featureMaker(data)
                features = (features if isinstance(features, Tensor)
                            else torch.as_tensor(np.asarray(features))
                            ).to(device, torch.float32)
                acc = features if acc is None else acc + features
                if index > n_seqs:
                    break
            mu = (acc.reshape(-1, acc.shape[-1]).mean(dim=0)
                  / n_seqs)[None, :]
        k, d = mu.shape

        it = 0
        last_diff = float('inf')
        while it < MAX_ITER:
            start_time = time()
            mu1 = torch.zeros((k, d), device=device)
            c1 = torch.zeros((k,), dtype=torch.float64, device=device)
            for n_batch, data in enumerate(dataLoader):
                features = _rows(featureMaker(data), d, device)
                dist2 = _sq_distances(features, mu)
                assign = dist2.argmin(dim=1)
                dist = dist2.gather(1, assign[:, None])[:, 0].sqrt()
                # one sync a batch: the farthest row and its distance
                max_dist, idx = torch.stack([dist.max().double(),
                                             dist.argmax().double()]).tolist()
                if max_dist > l:
                    idx = int(idx)
                    mu = torch.cat([mu, features[idx:idx + 1]], dim=0)
                    mu1 = torch.cat([mu1, mu1.new_zeros((1, d))], dim=0)
                    c1 = torch.cat([c1, c1.new_zeros(1)], dim=0)
                    assign[idx] = k
                    k += 1
                    if k % 10 == 0:
                        logger.info(f"Number of clusters increased to {k}")
                sums, counts = _one_hot_sums(features, assign, k)
                mu1 += sums
                c1 += counts.double()

            c1 = c1 + 1e-4
            mu1 = (mu1.double() / c1[:, None]).float()
            last_diff, n_items = torch.stack([
                torch.linalg.vector_norm(mu - mu1, dim=1).max().double(),
                c1.sum()]).tolist()
            n_items = int(n_items)

            mu = mu1
            k = mu.shape[0]
            it += 1
            logger.info(f"ITER {it} done in {time()-start_time:.2f} seconds. "
                        f"nItems: {n_items}. lambda={l}. mu shape: "
                        f"{(1, k, d)}. Difference with last checkpoint: "
                        f"{last_diff}")
            if save:
                path_save = save_dir / f"checkpoint_{it}.pt"
                logger.info(f"Saving last checkpoint to {path_save}")
                save_clustering_checkpoint(mu[None], path_save, iter=it,
                                           last_diff=last_diff,
                                           mode="DPMean")
                old = save_dir / f"checkpoint_{it - save_last}.pt"
                if old.is_file():
                    remove(old)
            if last_diff < EPSILON:
                logger.info(f"Clustering ended in {it} iterations out of "
                            f"{MAX_ITER}")
                break

        logger.info(f"{mu.shape[0]} clusters found for lambda = {l}")
    return mu[None]


def KMean(C, k, MAX_ITER=100, EPSILON=1e-4, batchSize=1000, device="cuda",
          rng: Optional[np.random.RandomState] = None) -> Tensor:
    """In-memory Lloyd over the rows of `C` (N, D) from k drawn rows
    (reference `clustering.py:332-358`). As in the JAX package, an empty
    cluster stays at the origin (the reference's mean of no rows is NaN),
    and on convergence the updated table is returned. Returns (1, k, D) on
    `device`."""
    device = resolve_device(str(device))
    with torch.no_grad():
        C = (C.detach() if isinstance(C, Tensor)
             else torch.as_tensor(np.asarray(C))).to(device, torch.float32)
        indexes = _draws(rng).permutation(C.shape[0])[:k]
        ck = C[torch.as_tensor(indexes, device=device)]
        last_diff = float('inf')
        for it in range(MAX_ITER):
            sums, counts = _lloyd_accumulate(C, ck)
            ck1 = sums / counts[:, None].clamp_min(1e-8)
            last_diff = torch.linalg.vector_norm(ck - ck1, dim=1).max().item()
            if last_diff < EPSILON:
                print(f"Clustering ended in {it} iterations out of "
                      f"{MAX_ITER}")
                ck = ck1
                break
            ck = ck1
    print(f"Last diff {last_diff}")
    return ck[None]


def distanceEstimation(featureMaker, dataLoader, maxIndex=10,
                       maxSizeGroup=300, device="cuda",
                       rng: Optional[np.random.RandomState] = None):
    """The sorted nonzero L2 distances between the rows of each group of
    `maxSizeGroup` shuffled feature rows, over the first batches: the
    distribution DP-means' lambda is picked from (reference
    `clustering.py:361-406`). Returns a sorted list of floats."""
    device = resolve_device(str(device))
    out_data = []
    maxIndex = min(maxIndex, len(dataLoader))
    print("Computing the features...")
    with torch.no_grad():
        for index, item in enumerate(dataLoader):
            features = featureMaker(item)
            out_data.append(_rows(features, features.shape[-1], device))
            if index > maxIndex:
                break
        print("Done")
        out_data = torch.cat(out_data, dim=0)
        n_items = out_data.shape[0]
        out_data = out_data[torch.as_tensor(
            _draws(rng).permutation(n_items), device=device)]

        out_dist = []
        print("Computing the distance...")
        for min_born in range(0, n_items, maxSizeGroup):
            group = out_data[min_born:min_born + maxSizeGroup]
            loc = torch.linalg.vector_norm(group[None, :, :]
                                           - group[:, None, :], dim=2)
            out_dist.append(loc[loc > 0])
        print("Done")
    return torch.sort(torch.cat(out_dist)).values.tolist()
