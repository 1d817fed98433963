"""The DTW kernel's plan and its two routes' traversal orders, on the CPU.

`dtw_plan` against the rules `csrc/dtw.cu:dtw_layout` follows, at every
(S1, S2) the ABX scorer's `_bucket` produces. Then the two routes'
decompositions, emulated in numpy float32 from the plan, against
`dtw_normalized_plain` and `cpc2_tpu.ops.dtw.dtw_normalized`, bit for bit:
the lane route walks each pair's rows in order, G lanes a pair each
holding S2B / G columns of the row above and handing its last column to
the next lane; the wave route walks 32-row strips as anti-diagonals,
computing every step's cells whether or not they lie inside the pair.
Cells the kernels never stage (rows past n1, columns past n2) are NaN
here, as stale shared memory is there: they must not reach the result.
`np.fmin` is `fminf` (the non-NaN operand), every cost one float32 add to
an exact minimum and the result one float32 division, so equality is
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc2_tpu.ops.dtw import dtw_normalized as jax_dtw
from cpc2_torch.ops.dtw import (LANE_WIDTHS, MAX_LEN, _bucket,
                                dtw_normalized_plain, dtw_plan)

BIG = np.float32(1e30)
BUCKETS = sorted({_bucket(n) for n in range(1, MAX_LEN + 1)})
SMS = 132


def cell(dv, diag, ldiag, left, lleft, up, lup, up_last):
    """The kernels' cell (`csrc/dtw.cu:cell`): d + min(diag, left, up), the
    length through the predecessor the tie-break diag <= left <= up picks;
    the wave route (`up_last`) takes up last, the lane route left, with one
    minimum of left and up for the cost and the tie-break."""
    if up_last:
        take_diag = (diag <= left) & (diag <= up)
        c = dv + np.fmin(np.fmin(diag, left), up)
    else:
        m = np.fmin(left, up)
        take_diag = diag <= m
        c = dv + np.fmin(diag, m)
    l = np.where(take_diag, ldiag, np.where(left <= up, lleft, lup)) + 1
    return c.astype(np.float32), l


def staged(dist, n1, n2):
    """dist with NaN where the kernels stage nothing."""
    p, s1, s2 = dist.shape
    rows = np.arange(s1)[None, :, None] < n1[:, None, None]
    cols = np.arange(s2)[None, None, :] < n2[:, None, None]
    return np.where(rows & cols, dist, np.float32(np.nan))


def lanes_route(dist, n1, n2, plan):
    """The lane route: each warp's pairs walk rows 0 ... max n1 - 1 in order,
    lane k of a pair holding columns [kC, kC + C) of the row above (C = S2B
    / G) and taking its left and diagonal neighbours at column kC - 1 from
    lane k - 1's last column of this row and the row before; a lane computes
    all its columns of every row up to its own n1."""
    p, s1, s2 = dist.shape
    g, s2b = plan.lanes, plan.s2b
    c = s2b // g
    d = np.full((p, s1, s2b), np.nan, np.float32)
    d[:, :, :s2] = staged(dist, n1, n2)
    out = np.empty(p, np.float32)
    for w0 in range(0, p, plan.pairs):
        sl = slice(w0, min(w0 + plan.pairs, p))
        wn1, wn2, wd = n1[sl], n2[sl], d[sl]
        q = len(wn1)
        pc = np.full((q, s2b), BIG, np.float32)
        pl = np.zeros((q, s2b), np.int64)
        last_c = np.full((q, g), BIG, np.float32)   # lane k's last column,
        last_l = np.zeros((q, g), np.int64)         # this row and the one
        prev_c = np.full((q, g), BIG, np.float32)   # before
        prev_l = np.zeros((q, g), np.int64)
        for i in range(int(wn1.max())):
            on = i < wn1
            prev_c[:], prev_l[:] = last_c, last_l
            for k in range(g):
                if k > 0:
                    diag, ldiag = prev_c[:, k - 1], prev_l[:, k - 1]
                    left, lleft = last_c[:, k - 1], last_l[:, k - 1]
                else:
                    diag = np.full(q, 0.0 if i == 0 else BIG, np.float32)
                    ldiag = np.zeros(q, np.int64)
                    left, lleft = np.full(q, BIG, np.float32), ldiag
                for j in range(k * c, k * c + c):
                    up, lup = pc[:, j].copy(), pl[:, j].copy()
                    left, lleft = cell(wd[:, i, j], diag, ldiag, left, lleft,
                                       up, lup, False)
                    diag, ldiag = up, lup
                    pc[:, j] = np.where(on, left, pc[:, j])
                    pl[:, j] = np.where(on, lleft, pl[:, j])
                last_c[:, k] = np.where(on, pc[:, k * c + c - 1], BIG)
                last_l[:, k] = np.where(on, pl[:, k * c + c - 1], 0)
        idx = np.arange(q)
        out[sl] = pc[idx, wn2 - 1] / np.maximum(
            pl[idx, wn2 - 1], 1).astype(np.float32)
    return out


def wave_route(dist, n1, n2):
    """The wave route: 32-row strips, lane l owning row base + l and
    computing column t - l at step t, every step's cells computed whether
    or not they lie inside the pair; lane 0's up neighbours from the
    previous strip's bottom row, which lane 31 kept."""
    p, s1, s2 = dist.shape
    d = staged(dist, n1, n2)
    lanes = np.arange(32)
    final_c = np.zeros(p, np.float32)
    final_l = np.zeros(p, np.int64)
    above_c = np.full((p, s2), BIG, np.float32)
    above_l = np.zeros((p, s2), np.int64)
    idx = np.arange(p)[:, None]
    for base in range(0, int(n1.max()), 32):
        i = base + lanes[None, :]
        row_ok = i < n1[:, None]
        below_c, below_l = above_c.copy(), above_l.copy()
        cur_c = np.full((p, 32), BIG, np.float32)
        cur_l = np.zeros((p, 32), np.int64)
        up_prev_c, up_prev_l = cur_c.copy(), cur_l.copy()
        for t in range(int(n2.max()) + 31):
            j = t - lanes[None, :]
            inside = row_ok & (j >= 0) & (j < n2[:, None])
            dv = np.where(inside, d[idx, np.minimum(i, s1 - 1),
                                    np.clip(j, 0, s2 - 1)], np.float32(0))
            have = (base > 0) & (t < n2)
            up_c = np.concatenate([np.where(have, above_c[:, min(t, s2 - 1)],
                                            BIG)[:, None], cur_c[:, :-1]], 1)
            up_l = np.concatenate([np.where(have, above_l[:, min(t, s2 - 1)],
                                            0)[:, None], cur_l[:, :-1]], 1)
            c_diag = np.where(j == 0, np.where(i == 0, np.float32(0), BIG),
                              up_prev_c).astype(np.float32)
            l_diag = np.where(j == 0, 0, up_prev_l)
            c_left = np.where(j == 0, BIG, cur_c)
            new_c, new_l = cell(dv, c_diag, l_diag, c_left, cur_l, up_c, up_l,
                                True)
            last = inside[:, 31]
            col = min(max(t - 31, 0), s2 - 1)
            below_c[last, col] = new_c[last, 31]
            below_l[last, col] = new_l[last, 31]
            here = (i == n1[:, None] - 1) & (j == n2[:, None] - 1)
            pair, lane = here.nonzero()
            final_c[pair] = new_c[pair, lane]
            final_l[pair] = new_l[pair, lane]
            up_prev_c, up_prev_l = up_c, up_l
            cur_c, cur_l = new_c, new_l
        above_c, above_l = below_c, below_l
    return (final_c / np.maximum(final_l, 1).astype(np.float32)).astype(
        np.float32)


def draw(seed, p, s1, s2, ties):
    """dist uniform in [0, 1), or from {0, 0.25, 0.5} (`ties`: equal costs
    meet at most cells, so the tie-break decides the path length);
    lengths uniform, pair 0 at (1, 1) and pair 1 at (S1, S2)."""
    rs = np.random.RandomState(seed)
    if ties:
        dist = rs.randint(0, 3, (p, s1, s2)).astype(np.float32) / 4
    else:
        dist = rs.rand(p, s1, s2).astype(np.float32)
    n1 = rs.randint(1, s1 + 1, p).astype(np.int32)
    n2 = rs.randint(1, s2 + 1, p).astype(np.int32)
    n1[0] = n2[0] = 1
    n1[1], n2[1] = s1, s2
    return dist, n1, n2


def references(dist, n1, n2):
    plain = dtw_normalized_plain(*map(torch.from_numpy, (dist, n1, n2)))
    scan = jax_dtw(jnp.asarray(dist), jnp.asarray(n1), jnp.asarray(n2))
    return plain.numpy(), np.asarray(scan)


@pytest.mark.parametrize("s1", BUCKETS)
def test_plan_at_every_bucket_pair(s1):
    """The lane route for S2 <= 64 at the smallest bucket width that holds
    S2, the wave route above; the lane route's G lanes a pair the fewest
    (a power of 2, S2B / G >= 8 columns a lane) that give every SM 8
    warps; the ring's slots and bytes; all below the 48 KB a launch takes
    without opting in."""
    for s2 in BUCKETS + [1, 7, 9, 33, 63, 65, 1000, MAX_LEN]:
        for p in (1, 100, 1024, 18432, 34000):
            plan = dtw_plan(s1, s2, p, SMS)
            assert plan.smem <= 48 * 1024
            if s2 > LANE_WIDTHS[-1]:
                assert plan == ("wave", 0, 1, 1, 32, 3,
                                (3 * 32 * 32 + 4 * s2) * 4)
                continue
            assert plan.route == "lanes"
            assert plan.s2b == min(w for w in LANE_WIDTHS if w >= s2)
            g = plan.lanes
            assert g in (1, 2, 4, 8) and plan.s2b // g >= 8
            assert plan.pairs * g == 32
            assert g == plan.s2b // 8 or p * g >= 32 * 8 * SMS
            assert g == 1 or p * (g // 2) < 32 * 8 * SMS
            c = plan.s2b // g
            assert plan.ahead * c >= 128 or plan.ahead == 2
            assert plan.slots == plan.ahead + g
            assert plan.smem == plan.slots * plan.pairs * (plan.s2b + 4) * 4


@pytest.mark.parametrize("s1,s2", [(0, 8), (8, 0), (MAX_LEN + 1, 8),
                                   (8, MAX_LEN + 1)])
def test_plan_refuses_outside_the_limits(s1, s2):
    with pytest.raises(ValueError, match="dtw_normalized"):
        dtw_plan(s1, s2, 1, SMS)


# (P, S1, S2) of the lane route, planned for a card of one SM (8 warps of
# pairs: P sets G): every kernel, each (S2B, G); S1 != S2 both ways; S2 off
# the bucket widths; P not a multiple of a warp's pairs
LANE_SHAPES = [(260, 6, 64), (130, 7, 50), (70, 9, 64), (9, 24, 64),
               (5, 64, 40), (3, 16, 60), (37, 8, 8), (260, 5, 16),
               (21, 30, 16), (300, 5, 32), (150, 4, 20), (19, 12, 32),
               (13, 40, 13), (11, 5, 27)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("p,s1,s2", LANE_SHAPES)
def test_lane_route_is_bit_identical(p, s1, s2, ties):
    dist, n1, n2 = draw(p * s1 + s2, p, s1, s2, ties)
    plain, scan = references(dist, n1, n2)
    plan = dtw_plan(s1, s2, p, 1)
    assert plan.route == "lanes"
    got = lanes_route(dist, n1, n2, plan)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, scan)


def test_lane_shapes_take_every_kernel():
    """The shapes above reach each of the lane route's ten kernels."""
    kernels = {dtw_plan(s1, s2, p, 1)[1:3] for p, s1, s2 in LANE_SHAPES}
    assert kernels == {(8, 1), (16, 1), (16, 2), (32, 1), (32, 2), (32, 4),
                       (64, 1), (64, 2), (64, 4), (64, 8)}


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("p,s1,s2", [(5, 40, 65), (3, 70, 100),
                                     (4, 20, 130), (2, 33, 66)])
def test_wave_route_is_bit_identical(p, s1, s2, ties):
    dist, n1, n2 = draw(p * s1 + s2 + 1, p, s1, s2, ties)
    plain, scan = references(dist, n1, n2)
    assert dtw_plan(s1, s2, p, SMS).route == "wave"
    got = wave_route(dist, n1, n2)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, scan)
