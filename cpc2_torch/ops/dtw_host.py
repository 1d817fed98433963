"""Normalised DTW on the host, in C++ (counterpart of
`cpc2_tpu/ops/dtw_host.py`).

`csrc/host/dtwhost.cc`, built with `g++` at first use
(`_build.host_library("dtwhost")`, which raises with the compiler's output
when the build fails) and called through ctypes: numpy in, numpy out, no
card. It gives the same bits as the DTW kernel (`ops/dtw.py`, `csrc/dtw.cu`)
and the plain DTW (`dtw_normalized_plain`): the same float32 sums in the
same order per cell, the same backtrack.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import _build

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


def dtw_normalized_host(dist: np.ndarray, n1, n2) -> np.ndarray:
    """dist (B, S1, S2) padded distance matrices, n1/n2 (B,) true lengths
    in [1, S1] and [1, S2] -> (B,) float32 DTW(dist[b, :n1, :n2]) /
    backtracked path length. Same contract as `ops/dtw.py:dtw_normalized`."""
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    if dist.ndim != 3:
        raise ValueError(f"dtw_normalized_host: dist must be (B, S1, S2), "
                         f"got {dist.shape}")
    b, s1, s2 = dist.shape
    n1 = np.ascontiguousarray(n1, dtype=np.int32)
    n2 = np.ascontiguousarray(n2, dtype=np.int32)
    if n1.shape != (b,) or n2.shape != (b,):
        raise ValueError(f"dtw_normalized_host: n1, n2 must be ({b},), got "
                         f"{n1.shape}, {n2.shape}")
    if b and (n1.min() < 1 or n1.max() > s1 or n2.min() < 1
              or n2.max() > s2):
        raise ValueError(f"dtw_normalized_host: lengths outside [1, {s1}] "
                         f"x [1, {s2}]")
    out = np.empty((b,), dtype=np.float32)
    _build.host_library("dtwhost").dtw_host_batch(
        dist.ctypes.data_as(_FP), b, s1, s2, n1.ctypes.data_as(_IP),
        n2.ctypes.data_as(_IP), out.ctypes.data_as(_FP))
    return out


def dtw_batch_host(x, y, sx, sy, dist_mat, ignore_diag: bool = False,
                   symetric: bool = False) -> np.ndarray:
    """The reference's Cython `dtw.dtw_batch` (`dtw.pyx:16-36`) on the
    host: dist_mat (Nx, Ny, S1, S2) -> (Nx, Ny). `x`, `y` and `symetric`
    are taken for the reference's signature and unused; `ignore_diag`
    zeroes the diagonal."""
    dist_mat = np.ascontiguousarray(dist_mat, dtype=np.float32)
    nx, ny, s1, s2 = dist_mat.shape
    flat = dist_mat.reshape(nx * ny, s1, s2)
    out = dtw_normalized_host(flat, np.repeat(np.asarray(sx, np.int32), ny),
                              np.tile(np.asarray(sy, np.int32), nx))
    out = out.reshape(nx, ny)
    if ignore_diag:
        np.fill_diagonal(out, 0.0)
    return out
