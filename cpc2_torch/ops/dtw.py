"""Batched DTW with backtracked path-length normalisation, with a
hand-written CUDA kernel (counterpart of `cpc2_tpu/ops/dtw.py` and
`cpc2_tpu/ops/dtw_pallas.py`, reference `cpc/eval/ABX/dtw.pyx`).

`dtw_normalized_plain` is the anti-diagonal wavefront of the JAX package
in PyTorch: every cell of a diagonal depends only on the two diagonals
before it, so a diagonal of all pairs updates in one vector step. The path
length is carried forward with the backtracking tie-break (diag <= left <=
up), which gives the length the reference finds by backtracking.

`dtw_normalized` launches the kernel of `csrc/dtw.cu` for CUDA tensors
(one warp per pair; see the source) and runs `dtw_normalized_plain` for
CPU tensors; there is no other path. Both give bit-identical results.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

Tensor = torch.Tensor

_BIG = 1e30
# Largest S1 and S2 the kernel takes: a 20 s token at 100 frames per second.
MAX_LEN = 2048


def dtw_normalized_plain(dist: Tensor, n1: Tensor, n2: Tensor) -> Tensor:
    """dist (P, S1, S2) float32, n1/n2 (P,) true lengths (>= 1) ->
    (P,) DTW(dist[p, :n1, :n2]) / backtracked path length."""
    p, s1, s2 = dist.shape
    dev = dist.device
    big = torch.full((p, 1), _BIG, dtype=torch.float32, device=dev)
    zero = torch.zeros((p, 1), dtype=torch.float32, device=dev)
    i_idx = torch.arange(s1, device=dev)
    n1 = n1.to(device=dev, dtype=torch.long)
    n2 = n2.to(device=dev, dtype=torch.long)
    prev_c = big.expand(p, s1).clone()
    prev2_c = prev_c.clone()
    prev_l = zero.expand(p, s1).clone()
    prev2_l = prev_l.clone()
    k_final = n1 + n2 - 2
    final_c = torch.zeros(p, dtype=torch.float32, device=dev)
    final_l = torch.zeros(p, dtype=torch.float32, device=dev)
    at_i0 = (i_idx == 0)[None, :]
    for k in range(s1 + s2 - 1):
        j_idx = k - i_idx
        valid = ((j_idx >= 0) & (j_idx < s2))[None, :]
        d_k = dist[:, i_idx, j_idx.clamp(0, s2 - 1)]     # d[:, i, k - i]
        at_j0 = (j_idx == 0)[None, :]
        c_left = torch.where(at_j0, _BIG, prev_c)
        c_up = torch.where(at_i0, _BIG, torch.cat([big, prev_c[:, :-1]], 1))
        c_diag = torch.where(at_i0 | at_j0, _BIG,
                             torch.cat([big, prev2_c[:, :-1]], 1))
        l_up = torch.cat([zero, prev_l[:, :-1]], 1)
        l_diag = torch.cat([zero, prev2_l[:, :-1]], 1)

        best = torch.minimum(c_diag, torch.minimum(c_left, c_up))
        origin = at_i0 & at_j0
        cost_k = d_k + torch.where(origin, 0.0, best)
        take_diag = (c_diag <= c_left) & (c_diag <= c_up)
        take_left = ~take_diag & (c_left <= c_up)
        pred_l = torch.where(take_diag, l_diag,
                             torch.where(take_left, prev_l, l_up))
        len_k = torch.where(origin, 1.0, pred_l + 1.0)
        cost_k = torch.where(valid, cost_k, _BIG)
        len_k = torch.where(valid, len_k, 0.0)

        here = k_final == k
        row = (n1 - 1)[:, None].clamp(0, s1 - 1)
        final_c = torch.where(here, cost_k.gather(1, row)[:, 0], final_c)
        final_l = torch.where(here, len_k.gather(1, row)[:, 0], final_l)
        prev2_c, prev_c = prev_c, cost_k
        prev2_l, prev_l = prev_l, len_k
    return final_c / torch.clamp(final_l, min=1.0)


def _check(dist: Tensor, n1: Tensor, n2: Tensor) -> None:
    if dist.dim() != 3 or n1.shape != (dist.shape[0],) \
            or n2.shape != (dist.shape[0],):
        raise ValueError(f"dtw_normalized: dist must be (P, S1, S2) and "
                         f"n1, n2 (P,), got {tuple(dist.shape)}, "
                         f"{tuple(n1.shape)}, {tuple(n2.shape)}")


def dtw_normalized(dist: Tensor, n1: Tensor, n2: Tensor) -> Tensor:
    """Normalised DTW of a batch of padded distance matrices.

    dist: (P, S1, S2) float32, padding values ignored; n1, n2: (P,) true
    lengths in [1, S1] and [1, S2]. Returns (P,) float32. CUDA tensors go
    through the kernel, which takes S1, S2 <= `MAX_LEN` and raises above;
    CPU tensors through `dtw_normalized_plain`."""
    _check(dist, n1, n2)
    if dist.device.type == "cpu":
        return dtw_normalized_plain(dist, n1, n2)
    device = _build.check_cuda("dtw_normalized", dist, n1, n2)
    _build.check_f32("dtw_normalized", dist)
    p, s1, s2 = dist.shape
    if s1 > MAX_LEN or s2 > MAX_LEN:
        raise ValueError(f"dtw_normalized: the kernel takes S1, S2 <= "
                         f"{MAX_LEN} frames, got ({s1}, {s2})")
    dist = dist.contiguous()
    n1 = n1.to(torch.int32).contiguous()
    n2 = n2.to(torch.int32).contiguous()
    out = torch.empty(p, dtype=torch.float32, device=device)
    _build.launch("dtw", "cpc2_dtw", device, dist.data_ptr(), n1.data_ptr(),
                  n2.data_ptr(), out.data_ptr(), p, s1, s2)
    return out


def _bucket(n: int, sizes=(8, 16, 32, 64, 128, 256, 512, 1024)) -> int:
    for s in sizes:
        if n <= s:
            return s
    return int(np.ceil(n / 1024) * 1024)


def dtw_batch(x, y, sx, sy, dist_mat, ignore_diag: bool = False,
              symetric: bool = False, device: str = "cuda") -> np.ndarray:
    """The Cython `dtw.dtw_batch` (`dtw.pyx:16-36`): dist_mat (Nx, Ny, S1,
    S2) -> (Nx, Ny) normalised DTW distances, all pairs in one call on
    `device`. `x`, `y` and `symetric` are accepted for the reference's
    signature and unused; `ignore_diag` zeroes the diagonal."""
    dist_mat = np.asarray(dist_mat, dtype=np.float32)
    nx, ny, s1, s2 = dist_mat.shape
    p1, p2 = _bucket(s1), _bucket(s2)
    if (p1, p2) != (s1, s2):
        dist_mat = np.pad(dist_mat, ((0, 0), (0, 0), (0, p1 - s1),
                                     (0, p2 - s2)))
    flat = torch.from_numpy(np.ascontiguousarray(
        dist_mat.reshape(nx * ny, p1, p2))).to(device)
    n1 = torch.from_numpy(np.repeat(np.asarray(sx, np.int32), ny)).to(device)
    n2 = torch.from_numpy(np.tile(np.asarray(sy, np.int32), nx)).to(device)
    out = dtw_normalized(flat, n1, n2).cpu().numpy().reshape(nx, ny)
    if ignore_diag:
        np.fill_diagonal(out, 0.0)
    return out
