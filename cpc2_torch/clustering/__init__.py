"""k-means and DP-means over CPC features, their checkpoints, and the
clustering and quantization CLIs (counterpart of `cpc2_tpu/clustering/`)."""

from .clustering import (KMean, distanceEstimation, fastDPMean,
                         get_last_checkpoint, kMeanCluster, kMeanClusterStep,
                         kMeanGPU, loadClusterModule,
                         load_clustering_checkpoint,
                         save_clustering_checkpoint)

__all__ = ["KMean", "distanceEstimation", "fastDPMean", "get_last_checkpoint",
           "kMeanCluster", "kMeanClusterStep", "kMeanGPU",
           "loadClusterModule", "load_clustering_checkpoint",
           "save_clustering_checkpoint"]
