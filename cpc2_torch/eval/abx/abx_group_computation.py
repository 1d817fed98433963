"""Per-group ABX scores on the card (counterpart of
`cpc2_tpu/eval/abx/abx_group_computation.py`, reference
`cpc/eval/ABX/abx_group_computation.py`).

The pairwise frame distances are one batched matmul (cosine on features
already normalised: arccos of the clamped dot product over pi), computed
in plain PyTorch as the JAX package computes them with `einsum` outside
any Pallas kernel. Every pair's DTW goes through `ops/dtw.py`, whose CUDA
kernel runs for tensors on the card. Library matmuls run in full fp32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...ops.dtw import _bucket, dtw_normalized
from ...training import full_fp32

Tensor = torch.Tensor

# Triplet groups scored together: up to this many groups of one padded
# shape go through one pair of DTW launches (a "flush").
_GROUP_BATCH = 32

# Flushes and DTW pairs scored by `get_abx_scores_dtw_on_group`, for the
# caller's report.
COUNTS = {"flushes": 0, "dtw_pairs": 0}


def get_distance_function_from_name(name_str: str):
    if name_str == 'euclidian':
        return get_euclidian_distance_batch
    if name_str == 'cosine':
        return get_cosine_distance_batch
    raise ValueError("Invalid distance mode")


def check_dtw_group_validity(a, b, x):
    assert a.ndim == b.ndim == x.ndim
    assert a.shape[2] == x.shape[2] == b.shape[2]


def _cross_g(a1: Tensor, a2: Tensor) -> Tensor:
    """(G, N1, S1, D) x (G, N2, S2, D) -> (G, N1, N2, S1, S2) dot products,
    one batched matmul."""
    g, n1, s1, d = a1.shape
    _, n2, s2, _ = a2.shape
    prod = torch.bmm(a1.reshape(g, n1 * s1, d),
                     a2.reshape(g, n2 * s2, d).transpose(1, 2))
    return prod.reshape(g, n1, s1, n2, s2).permute(0, 1, 3, 2, 4)


def _cosine_dist_g(a1: Tensor, a2: Tensor) -> Tensor:
    return torch.arccos(_cross_g(a1, a2).clamp(-1.0, 1.0)) / math.pi


def _euclid_dist_g(a1: Tensor, a2: Tensor) -> Tensor:
    n1 = (a1 ** 2).sum(dim=3)                          # (G, N1, S1)
    n2 = (a2 ** 2).sum(dim=3)                          # (G, N2, S2)
    sq = (n1[:, :, None, :, None] - 2 * _cross_g(a1, a2)
          + n2[:, None, :, None, :])
    return torch.sqrt(sq.clamp(min=0.0))


def get_cosine_distance_batch(a1, a2, epsilon=1e-8) -> Tensor:
    """a1 (N1, S1, D), a2 (N2, S2, D) normalised -> (N1, N2, S1, S2)
    angular distance (reference `abx_group_computation.py:26-35`)."""
    return _cosine_dist_g(torch.as_tensor(a1)[None],
                          torch.as_tensor(a2)[None])[0]


def get_euclidian_distance_batch(a1, a2) -> Tensor:
    return _euclid_dist_g(torch.as_tensor(a1)[None],
                          torch.as_tensor(a2)[None])[0]


def _bucket_small(n: int) -> int:
    """Bucket group sizes, so that groups of nearby sizes share a flush."""
    for s in (1, 2, 4, 8, 16, 24, 32, 48, 64, 96, 128):
        if n <= s:
            return s
    return int(np.ceil(n / 128) * 128)


def _bucket_g(n: int, cap: int = _GROUP_BATCH) -> int:
    g = 1
    while g < n:
        g *= 2
    return min(g, cap)


def _pad_group(g, sizes):
    n, s, d = g.shape
    bn, ps = _bucket_small(n), _bucket(s)
    gp = np.zeros((bn, ps, d), np.float32)
    gp[:n, :s] = np.asarray(g)
    lp = np.ones(bn, np.int32)
    lp[:n] = np.asarray(sizes)
    valid = np.zeros(bn, bool)
    valid[:n] = True
    return gp, lp, valid


def get_distance_group_dtw(a1, a2, size1, size2, ignore_diag=False,
                           symmetric=False,
                           distance_function=get_cosine_distance_batch,
                           device="cuda"):
    """(N1, S1, D) x (N2, S2, D) numpy -> (N1, N2) numpy DTW-averaged
    distances (reference `abx_group_computation.py:45-60`), computed on
    `device`. `distance_function` takes two padded tensors on `device` and
    returns their (N1, N2, S1, S2) distances; padded pairs get length-1
    DTWs and are sliced away."""
    n1_, s1, _ = a1.shape
    n2_, s2, _ = a2.shape
    a1p, len1, _ = _pad_group(a1, size1)
    a2p, len2, _ = _pad_group(a2, size2)
    bn1, bn2 = a1p.shape[0], a2p.shape[0]
    with full_fp32():
        dist = distance_function(torch.from_numpy(a1p).to(device),
                                 torch.from_numpy(a2p).to(device))
        flat = dist.reshape(bn1 * bn2, a1p.shape[1], a2p.shape[1])
        l1 = torch.from_numpy(np.repeat(len1, bn2)).to(device)
        l2 = torch.from_numpy(np.tile(len2, bn1)).to(device)
        out = dtw_normalized(flat.contiguous(), l1, l2).cpu().numpy()
    out = out.reshape(bn1, bn2)[:n1_, :n2_]
    if ignore_diag:
        np.fill_diagonal(out, 0.0)
    return out


def get_theta_group_dtw(a, b, x, sa, sb, sx, distance_function, symmetric,
                        device="cuda") -> float:
    """ABX score theta of one triplet group (reference
    `abx_group_computation.py:63-90`), for any distance callable."""
    check_dtw_group_validity(a, b, x)
    dxb = get_distance_group_dtw(x, b, sx, sb,
                                 distance_function=distance_function,
                                 device=device)
    dxa = get_distance_group_dtw(x, a, sx, sa, ignore_diag=symmetric,
                                 symmetric=symmetric,
                                 distance_function=distance_function,
                                 device=device)
    nx, na = dxa.shape
    nb = dxb.shape[1]
    if symmetric:
        n_pos = na * (na - 1)
        np.fill_diagonal(dxa, dxb.max() + 1)
    else:
        n_pos = na * nx
    dxb_e = dxb.reshape(nx, 1, nb)
    dxa_e = dxa.reshape(nx, na, 1)
    sc = float((dxa_e < dxb_e).sum() + 0.5 * (dxa_e == dxb_e).sum())
    return sc / (n_pos * nb)


def loc_dtw(data, distance_function, symmetric, device="cuda"):
    coords, group_a, group_b, group_x = data
    theta = get_theta_group_dtw(group_a[0], group_b[0], group_x[0],
                                group_a[1], group_b[1], group_x[1],
                                distance_function, symmetric, device)
    return coords, 1 - theta


def _dtw_pairs(dist_g, q, r, lq, lr):
    """(G, NQ, SQ, D) x (G, NR, SR, D) -> (G, NQ, NR) DTW distances."""
    dist = dist_g(q, r)
    g, nq, nr, sq, sr = dist.shape
    l1 = lq[:, :, None].expand(g, nq, nr).reshape(-1)
    l2 = lr[:, None, :].expand(g, nq, nr).reshape(-1)
    return dtw_normalized(dist.reshape(g * nq * nr, sq, sr), l1,
                          l2).reshape(g, nq, nr)


def _score_groups(dist_g, symmetric, a, b, x, la, lb, lx, va, vb, vx):
    """Win and tie counts of G same-shape triplet groups: (G, N, S, D)
    features, (G, N) lengths and valid masks -> (G,) numerators. Counts of
    wins (1) and ties (0.5) below 2**24 are exact in fp32."""
    dxb = _dtw_pairs(dist_g, x, b, lx, lb)             # (G, NX, NB)
    dxa = _dtw_pairs(dist_g, x, a, lx, la)             # (G, NX, NA)
    w_xb = vx[:, :, None] & vb[:, None, :]
    w_xa = vx[:, :, None] & va[:, None, :]
    if symmetric:
        # positives leave out the x == a pair: its distance becomes the
        # largest dxb plus one, so it loses every comparison
        # (reference `abx_group_computation.py:74-78`)
        max_val = torch.where(w_xb, dxb, -math.inf).amax(dim=(1, 2),
                                                          keepdim=True)
        eye = torch.eye(dxa.shape[1], dxa.shape[2], dtype=torch.bool,
                        device=dxa.device)[None]
        dxa = torch.where(eye, max_val + 1, dxa)
    w = (w_xa[:, :, :, None] & w_xb[:, :, None, :]).float()
    dxa_e = dxa[:, :, :, None]
    dxb_e = dxb[:, :, None, :]
    wins = (dxa_e < dxb_e).float() + 0.5 * (dxa_e == dxb_e).float()
    return (wins * w).sum(dim=(1, 2, 3))


def get_abx_scores_dtw_on_group(group_iterator, distance_function,
                                symmetric, device="cuda"):
    """Score every triplet group of `group_iterator`: (coords (n, k) int64,
    scores (n,) float32, board size), the reference's sparse tensor as
    arrays.

    Groups are padded to shape buckets and scored in flushes of up to
    `_GROUP_BATCH` groups of one padded shape. The loader's (T, D) feature
    matrix goes to `device` once; a flush sends only the rows' indices,
    lengths and valid masks, gathers its padded blocks there, and scores
    its groups' x-b and x-a DTWs and win counts there. The numerators stay
    on the device until one fetch at the end. Distance callables other
    than the cosine and Euclidean ones go through the per-group host loop.
    """
    if distance_function is get_cosine_distance_batch:
        dist_g = _cosine_dist_g
    elif distance_function is get_euclidian_distance_batch:
        dist_g = _euclid_dist_g
    else:
        return _abx_scores_host_loop(group_iterator, distance_function,
                                     symmetric, device)

    n = len(group_iterator)
    coords_list = [None] * n
    denoms = np.empty(n, np.float64)
    pending = []                  # (device (G,) numerators, [indices])
    buffers = {}                  # padded shapes -> [(index, padded...)]

    feats_np = getattr(getattr(group_iterator, 'dataset', None), 'data',
                       None)
    feats_dev = None
    if isinstance(feats_np, np.ndarray) and feats_np.ndim == 2:
        feats_dev = torch.from_numpy(
            np.ascontiguousarray(feats_np, np.float32)).to(device)

    def upload(array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    def flush(key):
        items = buffers.pop(key)
        g_true = len(items)
        gb = _bucket_g(g_true)

        def stack(pos, fill=0):
            # dummy groups: length 1, no valid row
            arrs = [it[pos] for it in items]
            arrs += [np.full_like(arrs[0], fill)] * (gb - g_true)
            return np.stack(arrs)

        if feats_dev is not None and all(
                it[pos] is not None for it in items for pos in (10, 11, 12)):
            t_rows = feats_dev.shape[0]

            def block(pos_start, pos_feat):
                s_pad = items[0][pos_feat].shape[1]
                idx = stack(pos_start)[:, :, None] + np.arange(s_pad)
                return feats_dev[upload(np.clip(idx, 0, t_rows - 1))]
            blocks = (block(10, 1), block(11, 4), block(12, 7))
        else:
            blocks = tuple(upload(stack(pos)) for pos in (1, 4, 7))
        lengths = tuple(upload(stack(pos, 1)) for pos in (2, 5, 8))
        valid = tuple(upload(stack(pos)) for pos in (3, 6, 9))
        with full_fp32():
            out = _score_groups(dist_g, symmetric, *blocks, *lengths, *valid)
        pending.append((out, [it[0] for it in items]))
        nx, na, nb = (blocks[2].shape[1], blocks[0].shape[1],
                      blocks[1].shape[1])
        COUNTS["flushes"] += 1
        COUNTS["dtw_pairs"] += gb * nx * (na + nb)

    def pad_starts(g, bn):
        st = getattr(g, 'token_starts', None)
        if st is None:
            return None
        out = np.zeros(bn, np.int64)
        out[:len(st)] = st
        return out

    for index, group in enumerate(group_iterator):
        coords, (a, sa), (b, sb), (x, sx) = group
        check_dtw_group_validity(a, b, x)
        ap, la, va = _pad_group(a, sa)
        bp, lb, vb = _pad_group(b, sb)
        xp, lx, vx = _pad_group(x, sx)
        na, nb, nx = a.shape[0], b.shape[0], x.shape[0]
        n_pos = na * (na - 1) if symmetric else na * nx
        coords_list[index] = coords
        denoms[index] = n_pos * nb
        key = (ap.shape, bp.shape, xp.shape)
        buffers.setdefault(key, []).append(
            (index, ap, la, va, bp, lb, vb, xp, lx, vx,
             pad_starts(a, ap.shape[0]), pad_starts(b, bp.shape[0]),
             pad_starts(x, xp.shape[0])))
        if len(buffers[key]) >= _GROUP_BATCH:
            flush(key)
        if (index + 1) % 500 == 0:
            print(f"  {index + 1}/{n} groups")
    for key in list(buffers):
        flush(key)

    scores = np.empty(n, np.float64)
    if pending:
        numerators = torch.cat([p[0] for p in pending]).cpu().numpy()
        off = 0
        for out, idxs in pending:
            scores[idxs] = numerators[off:off + len(idxs)]
            off += out.shape[0]
    scores = 1.0 - scores / denoms
    return (np.array(coords_list, dtype=np.int64),
            np.array(scores, dtype=np.float32),
            group_iterator.get_board_size())


def _abx_scores_host_loop(group_iterator, distance_function, symmetric,
                          device):
    """Per-group path for distance callables other than the built-in
    ones."""
    data_list, coords_list = [], []
    n = len(group_iterator)
    for index, group in enumerate(group_iterator):
        coords, abx = loc_dtw(group, distance_function, symmetric, device)
        data_list.append(abx)
        coords_list.append(coords)
        if (index + 1) % 500 == 0:
            print(f"  {index + 1}/{n} groups")
    return (np.array(coords_list, dtype=np.int64),
            np.array(data_list, dtype=np.float32),
            group_iterator.get_board_size())
