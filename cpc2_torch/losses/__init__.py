"""Training criteria of the port."""

from .criterion import (CPCUnsupervisedCriterion, PredictionNetwork,
                        sample_negative_indices)

__all__ = ["CPCUnsupervisedCriterion", "PredictionNetwork",
           "sample_negative_indices"]
