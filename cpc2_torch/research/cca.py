"""Canonical correlation analysis of two feature views, fitted in float64
on a torch device, and its pickled projection (the fit behind
`research/train_cca.py`, the projection behind
`FeatureModule(cca_projection=...)`).

The fit follows scikit-learn's `CCA(n_components, scale=True,
max_iter=500, tol=1e-06)`, the JAX package's: its `_PLS` in mode B with
canonical deflation (Wegelin's algorithm, section 4.1). Both views are
centred and scaled (ddof 1; a constant column keeps a scale of 1). For
each component the first pair of canonical weights comes from the power
method on the views' pseudo-inverses (their SVD, cut at 1e6 machine
epsilons of the largest singular value), started from Y's first column
that is not all zero; the weights are turned so that the largest of X's
has a positive sign, and both views are deflated by their scores. The X
side's rotations are `W (P^T W)^+`.

`CCAProjection` is what the port pickles: the X side's mean, scale and
rotations as numpy arrays, `transform(X) = ((X - mean) / std) @ rotations`.
`load_cca` reads it, or a pickled `sklearn.cross_decomposition.CCA` (the
JAX package's and the reference's artifact) without scikit-learn: that
class is mapped to a stub that keeps its fitted fields, and a pickle that
names any other class is refused.
"""

from __future__ import annotations

import pickle
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

# scikit-learn's CCA, under its module's name since 0.22 and before
_SKLEARN_CCA = {("sklearn.cross_decomposition._pls", "CCA"),
                ("sklearn.cross_decomposition.cca_", "CCA")}
# what a pickle of numpy arrays and plain objects needs besides
_PLAIN = {("numpy._core.multiarray", "_reconstruct"),
          ("numpy.core.multiarray", "_reconstruct"),
          ("numpy._core.multiarray", "scalar"),
          ("numpy.core.multiarray", "scalar"),
          ("numpy", "ndarray"), ("numpy", "dtype"),
          ("copyreg", "_reconstructor"), ("builtins", "object")}


class CCAProjection:
    """The X side of a fitted CCA: `x_mean` (D,), `x_std` (D,) and
    `x_rotations` (D, n_components), float64 numpy arrays. `transform` runs
    in numpy; calling the projection runs it in float64 where its input
    lies and returns the input's dtype."""

    def __init__(self, x_mean: np.ndarray, x_std: np.ndarray,
                 x_rotations: np.ndarray):
        self.x_mean = np.asarray(x_mean, np.float64)
        self.x_std = np.asarray(x_std, np.float64)
        self.x_rotations = np.asarray(x_rotations, np.float64)
        self._tensors = None

    @property
    def n_components(self) -> int:
        return self.x_rotations.shape[1]

    def transform(self, X) -> np.ndarray:
        """(N, D) -> (N, n_components)."""
        return ((np.asarray(X) - self.x_mean) / self.x_std) @ self.x_rotations

    def to(self, device) -> "CCAProjection":
        """Keep float64 copies of the fields on `device` for `__call__`."""
        self._tensors = tuple(torch.as_tensor(a, device=device) for a in (
            self.x_mean, self.x_std, self.x_rotations))
        return self

    def __call__(self, feats: Tensor) -> Tensor:
        """(..., D) features -> (..., n_components), on their device."""
        if self._tensors is None or self._tensors[0].device != feats.device:
            self.to(feats.device)
        mean, std, rot = self._tensors
        out = ((feats.to(torch.float64) - mean) / std) @ rot
        return out.to(feats.dtype)

    def __getstate__(self):
        return {"x_mean": self.x_mean, "x_std": self.x_std,
                "x_rotations": self.x_rotations}

    def __setstate__(self, state):
        self.__init__(state["x_mean"], state["x_std"], state["x_rotations"])


class _SklearnCCAFields:
    """Stands in for `sklearn.cross_decomposition.CCA` while its pickle is
    read: it keeps the pickled fields and nothing else."""

    def __setstate__(self, state):
        self.__dict__.update(state)


class _CCAUnpickler(pickle.Unpickler):

    def find_class(self, module, name):
        if (module, name) in _SKLEARN_CCA:
            return _SklearnCCAFields
        if (module, name) == (__name__, "CCAProjection"):
            return CCAProjection
        if (module, name) in _PLAIN:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"a CCA pickle names {module}.{name}: only scikit-learn's CCA "
            f"or {__name__}.CCAProjection are read")


def load_cca(path: str) -> CCAProjection:
    """The projection of a pickled CCA, the port's or scikit-learn's."""
    if not str(path).endswith(".pkl"):
        raise ValueError(f"a CCA projection is a .pkl file, got {path}")
    with open(path, "rb") as f:
        obj = _CCAUnpickler(f).load()
    if isinstance(obj, CCAProjection):
        return obj
    if not isinstance(obj, _SklearnCCAFields):
        raise pickle.UnpicklingError(f"{path} holds a {type(obj).__name__}, "
                                     f"not a CCA")
    return CCAProjection(obj._x_mean, obj._x_std, obj.x_rotations_)


def _pinv_cut(a: Tensor) -> Tensor:
    """The pseudo-inverse of `a` through its SVD, singular values at or
    below 1e6 machine epsilons of the largest dropped (scikit-learn's
    `_pinv2_old`, scipy's old `pinv2`)."""
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    cond = s.max() * 1e6 * torch.finfo(a.dtype).eps
    rank = int((s > cond).sum())
    return ((u[:, :rank] / s[:rank]) @ vh[:rank]).T


def _first_canonical_pair(X: Tensor, Y: Tensor, max_iter: int, tol: float
                          ) -> Optional[Tuple[Tensor, Tensor]]:
    """The first canonical weights of X and Y by the mode-B power method,
    Y's weights normalised; None when Y's residual is constant."""
    eps = torch.finfo(X.dtype).eps
    live = torch.nonzero((Y.abs() > eps).any(dim=0))
    if live.numel() == 0:
        return None
    y_score = Y[:, int(live[0])]
    x_pinv, y_pinv = _pinv_cut(X), _pinv_cut(Y)
    x_weights_old = None
    for _ in range(max_iter):
        x_weights = x_pinv @ y_score
        x_weights = x_weights / (torch.sqrt(x_weights @ x_weights) + eps)
        x_score = X @ x_weights
        y_weights = y_pinv @ x_score
        y_weights = y_weights / (torch.sqrt(y_weights @ y_weights) + eps)
        y_score = (Y @ y_weights) / (y_weights @ y_weights + eps)
        diff = x_weights - (100.0 if x_weights_old is None
                            else x_weights_old)
        if float(diff @ diff) < tol or Y.shape[1] == 1:
            break
        x_weights_old = x_weights
    else:
        warnings.warn("CCA: maximum number of iterations reached")
    return x_weights, y_weights


def fit_cca(x, y, n_components: int, device="cpu", max_iter: int = 500,
            tol: float = 1e-06) -> CCAProjection:
    """Fit a CCA of views `x` (N, p) and `y` (N, q), numpy or tensors, in
    float64 on `device`. Returns the X side's projection."""
    dev = torch.device(device)
    X = torch.as_tensor(x).to(dev, torch.float64, copy=True)
    Y = torch.as_tensor(y).to(dev, torch.float64, copy=True)
    if Y.ndim == 1:
        Y = Y[:, None]
    n, p = X.shape
    q = Y.shape[1]
    if Y.shape[0] != n:
        raise ValueError(f"the views have {n} and {Y.shape[0]} rows")
    bound = min(n, p, q)
    if n_components > bound:
        raise ValueError(f"`n_components` upper bound is {bound}. Got "
                         f"{n_components} instead. Reduce `n_components`.")
    x_mean, y_mean = X.mean(dim=0), Y.mean(dim=0)
    X, Y = X - x_mean, Y - y_mean
    x_std, y_std = X.std(dim=0), Y.std(dim=0)
    x_std[x_std == 0.0] = 1.0
    y_std[y_std == 0.0] = 1.0
    X, Y = X / x_std, Y / y_std

    weights = X.new_zeros((p, n_components))
    loadings = X.new_zeros((p, n_components))
    y_eps = torch.finfo(Y.dtype).eps
    for k in range(n_components):
        Y[:, (Y.abs() < 10 * y_eps).all(dim=0)] = 0.0
        pair = _first_canonical_pair(X, Y, max_iter, tol)
        if pair is None:
            warnings.warn(f"y residual is constant at iteration {k}")
            break
        x_weights, y_weights = pair
        sign = torch.sign(x_weights[torch.argmax(x_weights.abs())])
        x_weights, y_weights = x_weights * sign, y_weights * sign
        x_scores, y_scores = X @ x_weights, Y @ y_weights
        x_loadings = (x_scores @ X) / (x_scores @ x_scores)
        X = X - torch.outer(x_scores, x_loadings)
        y_loadings = (y_scores @ Y) / (y_scores @ y_scores)
        Y = Y - torch.outer(y_scores, y_loadings)
        weights[:, k], loadings[:, k] = x_weights, x_loadings
    rotations = weights @ torch.linalg.pinv(loadings.T @ weights)
    return CCAProjection(*(t.cpu().numpy() for t in (x_mean, x_std,
                                                      rotations)))
