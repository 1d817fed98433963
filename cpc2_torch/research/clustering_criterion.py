"""Clustering-based auxiliary losses (counterpart of
`cpc2_tpu/research/clustering_criterion.py`, reference
`cpc/criterion/research/clustering_criterion.py`).

The deferred cluster updates run the port's k-means and DP-means
(`clustering/clustering.py`: `kMeanGPU`, `fastDPMean`,
`distanceEstimation`) on `device`; the losses are torch functions of their
inputs, differentiable where they lie. The deep embedded clustering's
centroid step takes its gradient with `torch.autograd.grad` (the JAX
package's `jax.grad` there cannot trace its `kMeanCluster`, which converts
the centroids to numpy, so its update raises).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..clustering.clustering import (_sq_distances, distanceEstimation,
                                     fastDPMean, kMeanCluster, kMeanGPU)
from ..losses import CTCPhoneCriterion
from ..training import resolve_device

Tensor = torch.Tensor


def _features(x, device: torch.device) -> Tensor:
    t = x if isinstance(x, Tensor) else torch.as_tensor(np.asarray(x))
    return t.detach().to(device, torch.float32)


class ClusteringLoss:
    """Base: k centroids of width d, updated every `clusterIter` batches
    once `delay` updates have been asked for (reference
    `clustering_criterion.py:16-85`). The centroids, and every module of a
    subclass, live on `device` (the card unless `device="cpu"`)."""

    TARGET_QUANTILE = 0.05

    def __init__(self, k, d, delay, clusterIter, clusteringUpdate,
                 device="cuda"):
        self.device = resolve_device(str(device))
        self.clusters = kMeanCluster(np.zeros((1, k, d), np.float32)).to(
            self.device)
        self.k = k
        self.d = d
        self.init = False
        self.delay = delay
        self.step = 0
        self.clusterIter = clusterIter
        available = ["kmean", "dpmean"]
        if clusteringUpdate not in available:
            raise ValueError(f"{clusteringUpdate} is an invalid clustering "
                             f"update option. Must be in {available}")
        print(f"Clustering update mode is {clusteringUpdate}")
        self.DP_MEAN = clusteringUpdate == "dpmean"

    def canRun(self):
        return self.step > self.delay

    def getOptimalLambda(self, dataLoader, model, MAX_ITER=10):
        dist_data = distanceEstimation(model, dataLoader, maxIndex=MAX_ITER,
                                       maxSizeGroup=300, device=self.device)
        n_data = len(dist_data)
        print(f"{n_data} samples analyzed")
        return dist_data[int(self.TARGET_QUANTILE * n_data)]

    def updateClusters(self, dataLoader, featureMaker, MAX_ITER=20,
                       EPSILON=1e-4):
        self.step += 1
        if not self.canRun():
            return
        if self.DP_MEAN:
            l_ = self.getOptimalLambda(dataLoader, featureMaker)
            clusters = fastDPMean(dataLoader, featureMaker, l_,
                                  MAX_ITER=MAX_ITER,
                                  perIterSize=self.clusterIter,
                                  device=self.device)
            self.k = clusters.shape[1]
        else:
            clusters = kMeanGPU(dataLoader, featureMaker, self.k,
                                MAX_ITER=MAX_ITER, EPSILON=EPSILON,
                                perIterSize=self.clusterIter,
                                device=self.device)
        self.clusters = kMeanCluster(clusters)
        self.init = True

    # reference-spelled alias
    updateCLusters = updateClusters

    def assign_labels(self, x) -> Tensor:
        """Hard cluster assignments (B, S) of a (B, S, D) feature batch."""
        return self.clusters(x).argmin(dim=-1)


class DeepClustering(ClusteringLoss):
    """Cross-entropy of a linear classifier (d -> k) against the cluster
    assignments (`clustering_criterion.py:88-102`)."""

    def __init__(self, *args, device="cuda"):
        super().__init__(*args, device=device)
        self.classifier = nn.Linear(self.d, self.k).to(self.device)

    def __call__(self, x, labels) -> Tensor:
        if not self.canRun():
            return torch.zeros((1, 1), device=self.device)
        d = x.shape[-1]
        logits = self.classifier(x.reshape(-1, d))
        logp = torch.log_softmax(logits, dim=-1)
        ll = logp.gather(1, labels.reshape(-1, 1).long())[:, 0]
        return -ll.mean().reshape(1, 1)


class CTCCLustering(ClusteringLoss):
    """CTC loss of a linear (k + 1) head against the collapsed chains of
    cluster labels (`clustering_criterion.py:105-111`)."""

    def __init__(self, *args, device="cuda"):
        super().__init__(*args, device=device)
        self.main_module = CTCPhoneCriterion(self.d, self.k,
                                             on_encoder=False).to(self.device)

    def __call__(self, c_feature, label) -> Tensor:
        loss, _ = self.main_module(c_feature, None, label)
        return loss


class DeepEmbeddedClustering(ClusteringLoss):
    """Deep embedded clustering: the KL divergence of the sharpened soft
    assignments from the soft assignments, with centroids that learn at
    rate `lr` (`clustering_criterion.py:114-168`)."""

    def __init__(self, lr, *args, device="cuda"):
        self.lr = lr
        super().__init__(*args, device=device)

    def __call__(self, x) -> Tensor:
        if not self.canRun():
            return torch.zeros((1, 1), device=self.device)
        return self.loss(x, self.clusters.Ck)

    def loss(self, x: Tensor, ck: Tensor) -> Tensor:
        """KL loss (1, 1) of features (B, S, D) against centroids
        (1, k, D), differentiable in both."""
        b, s, d = x.shape
        dist = _sq_distances(x.reshape(b * s, d), ck[0])
        dist = 1.0 / (1.0 + dist)
        qij = dist / dist.sum(dim=1, keepdim=True)
        q_factor = qij ** 2 / qij.sum(dim=0, keepdim=True)
        pij = q_factor / q_factor.sum(dim=1, keepdim=True)
        return (pij * torch.log(pij / qij)).sum().reshape(1, 1)

    def updateClusters(self, dataLoader, model):
        if not self.init:
            super().updateClusters(dataLoader, model)
            self.init = True
            return
        self.step += 1
        if not self.canRun():
            return
        print("Updating the deep embedded clusters")
        ck = self.clusters.Ck.detach().clone()
        max_data = (len(dataLoader) if self.clusterIter <= 0
                    else self.clusterIter)
        for index, data in enumerate(dataLoader):
            if index > max_data:
                break
            feats = _features(model(data), self.device)
            with torch.enable_grad():
                c = ck.requires_grad_(True)
                grad, = torch.autograd.grad(self.loss(feats, c).sum(), c)
            ck = (ck - self.lr * grad).detach()
        self.clusters = kMeanCluster(ck)

    updateCLusters = updateClusters
