"""Research extras of the port (counterpart of `cpc2_tpu/research/`): the
PCA and SFA reductions, the clustering criteria, and the CCA projection
(`cca.py`, fitted by `train_cca.py`)."""

from .clustering_criterion import (ClusteringLoss, CTCCLustering,
                                   DeepClustering, DeepEmbeddedClustering)
from .dim_reduction import PCA, SFALinear, buildPCA, buildSFA, loadDimReduction

__all__ = ["PCA", "SFALinear", "buildPCA", "buildSFA", "loadDimReduction",
           "ClusteringLoss", "DeepClustering", "CTCCLustering",
           "DeepEmbeddedClustering"]
