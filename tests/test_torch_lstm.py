"""The LSTM's kernels on the CPU (`cpc2_torch/ops/lstm.py`,
`cpc2_torch/csrc/lstm.cu`): the resident cluster route and the grid route.

A CUDA kernel cannot run here, so the kernels' decomposition is emulated in
torch, in this file. Resident: the forward by batch tiles (one per cluster,
the last one ragged) and by CTA row slices (each CTA's 4H/C gate rows of
W_hh, its product summed over k slices in order), with h gathered from
every CTA's slice after each step; the backward forms each CTA's row-slice
partial P_j = dgi_{t+1}[:, R_j] W[R_j, :] and sums the partials per unit in
rank order, with db_hh a running sum over t per batch row, then summed over
rows and tiles in order. Grid: the batch walked in blocks and staged in
chunks, each CTA's unit slice (the last one ragged), each product tile's
k split into slices, a slice's k added up per lane (k = 4(lane + 32i) ..
+3) and the lanes reduced in the kernels' butterfly, the slices summed in
order; the backward's dh per unit over 4H the same way, with dc carried per
CTA and db_hh a column sum in (b, t) order. Both emulations are held
against autograd of `lstm_plain` and against the JAX package's Pallas
kernel in interpret mode, with the same inputs made from a seed with numpy.
Then `lstm_plan`, which picks the route and its layout from (B, H) and the
card's SMs on the CPU and on the card alike.

Tolerances are fp32 reordering: rtol 1e-5, atol 1e-6 for the forward and
rtol 1e-4, atol 1e-6 for the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc2_tpu.ops.lstm_pallas import fused_lstm as jax_fused_lstm
from cpc2_torch.ops.lstm import (BATCH_TILES, CELL_ITEMS, GRID_THREADS,
                                 MAX_CLUSTERS, SMEM_LIMIT, GridLayout,
                                 grid_layout, grid_plan, lstm_plain,
                                 lstm_plan, resident_smem)

torch.set_num_threads(1)

SMS = 132     # an H100's SMs, which the grid route's plan sizes its CTAs by
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
K_SLICES = 2   # the forward's k slices in the emulation
SHAPES = [(3, 13, 8, 4, 2), (5, 24, 16, 8, 4)]   # (B, T, H, C, Bc)


def _rows(j, u, h):
    """The gate rows of W_hh that CTA j of a cluster owns, gate-major."""
    return torch.cat([g * h + j * u + torch.arange(u) for g in range(4)])


def _tiles(b, bc):
    return [(b0, min(b0 + bc, b)) for b0 in range(0, b, bc)]


def emulate_forward(gi, h0, c0, w, bias, c, bc):
    """ys, h_last, c_last, and the saved cell states and gates."""
    b, t_len, g4 = gi.shape
    h = g4 // 4
    u = h // c
    ys, cs, ga = (torch.zeros(b, t_len, n) for n in (h, h, g4))
    for b0, b1 in _tiles(b, bc):
        hp = torch.zeros(bc, h)       # the tile's rows, ragged rows zero
        hp[:b1 - b0] = h0[b0:b1]
        cc = c0[b0:b1].clone()
        for t in range(t_len):
            h_next = torch.zeros(bc, h)
            for j in range(c):
                rows = _rows(j, u, h)
                wj = w[rows]
                kc = h // K_SLICES
                pre = sum(hp[:, s * kc:(s + 1) * kc] @ wj[:, s * kc:(s + 1) * kc].t()
                          for s in range(K_SLICES))[:b1 - b0]
                pre = gi[b0:b1, t, rows] + pre + bias[rows]
                ig, fg, og = (torch.sigmoid(pre[:, q * u:(q + 1) * u])
                              for q in (0, 1, 3))
                gg = torch.tanh(pre[:, 2 * u:3 * u])
                units = slice(j * u, (j + 1) * u)
                cc[:, units] = fg * cc[:, units] + ig * gg
                h_next[:b1 - b0, units] = og * torch.tanh(cc[:, units])
                for q, gate in enumerate((ig, fg, gg, og)):
                    ga[b0:b1, t, q * h + j * u:q * h + (j + 1) * u] = gate
            hp = h_next               # the all-gather of every CTA's slice
            ys[b0:b1, t] = hp[:b1 - b0]
            cs[b0:b1, t] = cc
    return ys, ys[:, -1].clone(), cs[:, -1].clone(), cs, ga


def emulate_backward(saved, h0, c0, w, dys, dh_last, dc_last, c, bc):
    """dgi, dh0, dc0, dW_hh, db_hh from the forward's saved tensors."""
    ys, cs, ga = saved
    b, t_len, h = ys.shape
    u = h // c
    dgi = torch.zeros(b, t_len, 4 * h)
    dh0, dc0 = torch.zeros(b, h), torch.zeros(b, h)
    db_tiles = []
    for b0, b1 in _tiles(b, bc):
        n = b1 - b0
        dc = dc_last[b0:b1].clone()
        db_rows = torch.zeros(n, 4 * h)   # each batch row's running sum
        for t in range(t_len - 1, -2, -1):
            if t == t_len - 1:
                dh_rec = dh_last[b0:b1]
            else:
                d_next = dgi[b0:b1, t + 1]
                parts = [d_next[:, _rows(j, u, h)] @ w[_rows(j, u, h)]
                         for j in range(c)]
                dh_rec = torch.zeros(n, h)
                for k in range(c):        # CTA k sums its slots in order
                    units = slice(k * u, (k + 1) * u)
                    for part in parts:
                        dh_rec[:, units] = dh_rec[:, units] + part[:, units]
            if t < 0:
                dh0[b0:b1], dc0[b0:b1] = dh_rec, dc
                break
            i, f, g, o = ga[b0:b1, t].chunk(4, dim=-1)
            tanh_c = torch.tanh(cs[b0:b1, t])
            c_prev = c0[b0:b1] if t == 0 else cs[b0:b1, t - 1]
            dh = dys[b0:b1, t] + dh_rec
            do_pre = dh * tanh_c * o * (1 - o)
            dcv = dc + dh * o * (1 - tanh_c * tanh_c)
            d = torch.cat([dcv * g * i * (1 - i), dcv * c_prev * f * (1 - f),
                           dcv * i * (1 - g * g), do_pre], dim=-1)
            dgi[b0:b1, t] = d
            db_rows = db_rows + d
            dc = dcv * f
        db = torch.zeros(4 * h)
        for r in range(n):                # over the tile's rows in order
            db = db + db_rows[r]
        db_tiles.append(db)
    db_hh = torch.zeros(4 * h)
    for db in db_tiles:                   # over clusters in order
        db_hh = db_hh + db
    hs_prev = torch.cat([h0[:, None], ys[:, :-1]], dim=1)
    dw_hh = dgi.reshape(-1, 4 * h).t() @ hs_prev.reshape(-1, h)
    return dgi, dh0, dc0, dw_hh, db_hh


def _arrays(b, t, h, seed):
    rs = np.random.RandomState(seed)
    arrays = [rs.randn(b, t, 4 * h).astype(np.float32),
              rs.randn(b, h).astype(np.float32),
              rs.randn(b, h).astype(np.float32),
              (rs.randn(4 * h, h) / np.sqrt(h)).astype(np.float32),
              (rs.randn(4 * h) / np.sqrt(h)).astype(np.float32)]
    cots = [rs.randn(b, t, h).astype(np.float32),
            rs.randn(b, h).astype(np.float32),
            rs.randn(b, h).astype(np.float32)]
    return arrays, cots


def _emulate(arrays, cots, c, bc):
    gi, h0, c0, w, bias = (torch.from_numpy(a) for a in arrays)
    dys, dhl, dcl = (torch.from_numpy(a) for a in cots)
    ys, hl, cl, cs, ga = emulate_forward(gi, h0, c0, w, bias, c, bc)
    grads = emulate_backward((ys, cs, ga), h0, c0, w, dys, dhl, dcl, c, bc)
    return ([x.numpy() for x in (ys, hl, cl)], [g.numpy() for g in grads])


def _close(got, want, names, tol):
    for g, w, name in zip(got, want, names):
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


OUTS = ["ys", "h_last", "c_last"]
GRADS = ["dgi", "dh0", "dc0", "dw_hh", "db_hh"]


@pytest.mark.parametrize("b,t,h,c,bc", SHAPES)
def test_emulated_decomposition_matches_plain_autograd(b, t, h, c, bc):
    """With a nonzero (h0, c0) carry and a ragged last batch tile."""
    arrays, cots = _arrays(b, t, h, seed=b)
    out_e, grad_e = _emulate(arrays, cots, c, bc)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    outs = lstm_plain(*leaves)
    torch.autograd.backward(outs, [torch.from_numpy(x) for x in cots])
    _close(out_e, [o.detach().numpy() for o in outs], OUTS, FWD)
    _close(grad_e, [x.grad.numpy() for x in leaves], GRADS, GRAD)


@pytest.mark.parametrize("b,t,h,c,bc", SHAPES)
def test_emulated_decomposition_matches_pallas(b, t, h, c, bc):
    """The JAX package's kernel in interpret mode, as its own tests run
    it."""
    arrays, cots = _arrays(b, t, h, seed=10 + b)
    out_e, grad_e = _emulate(arrays, cots, c, bc)
    outs, vjp = jax.vjp(lambda *a: jax_fused_lstm(*a, True),
                        *[jnp.asarray(a) for a in arrays])
    grads = vjp(tuple(jnp.asarray(x) for x in cots))
    _close(out_e, [np.asarray(o) for o in outs], OUTS, FWD)
    _close(grad_e, [np.asarray(g) for g in grads], GRADS, GRAD)


@pytest.mark.parametrize("b", [8, 1, 4, 16, 5])
def test_plan_takes_the_resident_route_at_h256(b):
    """The recipe (8, 256), the ABX feature batches (1, 4 and 16 files of
    one length) and a ragged batch: one persistent launch per call, at most
    MAX_CLUSTERS tiles that cover the batch with at most one ragged tile,
    and shared memory within one block's limit."""
    plan = lstm_plan(b, 256, SMS)
    assert plan.route == "resident"
    assert plan.cluster in (8, 16) and plan.bc in BATCH_TILES
    n_clusters = -(-b // plan.bc)
    assert n_clusters * plan.bc >= b > (n_clusters - 1) * plan.bc
    assert n_clusters <= MAX_CLUSTERS
    assert 0 < plan.smem <= SMEM_LIMIT
    assert plan.smem == resident_smem(256, plan.cluster, plan.bc)
    # W_hh's slice is resident: 4H/C rows of H floats in every CTA
    assert plan.smem > 4 * (4 * 256 // plan.cluster) * 256


def test_plan_takes_the_steps_route_at_h512():
    """A 512-wide W_hh slice does not fit a CTA at either cluster size, so
    the width the per-step route took goes to the grid route that replaced
    it."""
    plan = lstm_plan(8, 512, SMS)
    assert plan.route == "grid" and plan.cluster == 0 and plan.bc == 0
    for cluster in (8, 16):
        assert 4 * (4 * 512 // cluster) * 512 > SMEM_LIMIT
        assert not 0 < resident_smem(512, cluster, 8) <= SMEM_LIMIT


def test_plan_of_the_recipe():
    """At the recipe eight clusters of 16 CTAs each walk one sequence: 64 KB
    of W_hh a CTA, two mbarriers, h double-buffered, the forward's and the
    backward's partial sums and slots; the backward's layout is the larger."""
    bwd = 4 * (64 * 256 + 4 * 1 * 256 + 1 * 64 + 2 * 16 * 1 * 16)
    assert lstm_plan(8, 256, SMS) == ("resident", 16, 1, 16 + bwd, 0, 0,
                                      None, None)


# --- the grid route ----------------------------------------------------------

def _lanes_then_butterfly(x, w):
    """A product tile's sums over one slice of k, as a warp forms them:
    x (n, k4, 4) and w (m, k4, 4) -> (n, m). Lane l adds up the 4-wide dot
    products of k4 = l, l + 32, ... in order; the 32 lanes' partials are
    then added in the kernels' butterfly (lane x with lane x + 16, then + 8,
    ..., + 1)."""
    k4 = x.shape[1]
    dots = torch.einsum("njk,mjk->jnm", x, w)
    lanes = torch.zeros(32, x.shape[0], w.shape[0])
    lanes.index_add_(0, torch.arange(k4) % 32, dots)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes[:off] + lanes[off:2 * off]
    return lanes[0]


def _split_product(x, w, splits):
    """x (n, K) . w (m, K)ᵀ with K a multiple of 4, k split into `splits`
    slices of float4 groups as the kernels cut it, the slices added in
    order."""
    k4 = x.shape[1] // 4
    xs, ws = x.reshape(x.shape[0], k4, 4), w.reshape(w.shape[0], k4, 4)
    total = torch.zeros(x.shape[0], w.shape[0])
    for s in range(splits):
        lo, hi = s * k4 // splits, (s + 1) * k4 // splits
        total = total + _lanes_then_butterfly(xs[:, lo:hi], ws[:, lo:hi])
    return total


def _cta_slices(h, units):
    """Each CTA's hidden units, the last CTA's possibly fewer."""
    return [range(u0, min(u0 + units, h)) for u0 in range(0, h, units)]


def _chunks(nb, chunk):
    return [(c, min(c + chunk, nb)) for c in range(0, nb, chunk)]


def emulate_grid_forward(gi, h0, c0, w, bias, units, walk, chunk, splits):
    """ys, h_last, c_last, cs, ga as the grid forward forms them: the batch
    in walks of `walk` rows, each step's h_{t-1} (zero-padded to a multiple
    of 4) staged in chunks, each CTA's gate rows of its units."""
    b, t_len, g4 = gi.shape
    h = g4 // 4
    k_row = -(-h // 4) * 4
    wp = torch.zeros(g4, k_row)
    wp[:, :h] = w
    ys, cs, ga = (torch.zeros(b, t_len, n) for n in (h, h, g4))
    for w0 in range(0, b, walk):
        nb = min(walk, b - w0)
        c = c0[w0:w0 + nb].clone()
        for t in range(t_len):
            hp = torch.zeros(nb, k_row)
            hp[:, :h] = h0[w0:w0 + nb] if t == 0 else ys[w0:w0 + nb, t - 1]
            for cta in _cta_slices(h, units):
                us = torch.tensor(list(cta))
                rows = torch.cat([q * h + us for q in range(4)])
                for c_lo, c_hi in _chunks(nb, chunk):
                    pre = _split_product(hp[c_lo:c_hi], wp[rows], splits)
                    pre = (gi[w0 + c_lo:w0 + c_hi, t, rows] + pre
                           + bias[rows])
                    u = len(us)
                    ig, fg, og = (torch.sigmoid(pre[:, q * u:(q + 1) * u])
                                  for q in (0, 1, 3))
                    gg = torch.tanh(pre[:, 2 * u:3 * u])
                    cc = fg * c[c_lo:c_hi, us] + ig * gg
                    c[c_lo:c_hi, us] = cc
                    rb = slice(w0 + c_lo, w0 + c_hi)
                    ys[rb, t, us] = og * torch.tanh(cc)
                    cs[rb, t, us] = cc
                    for q, gate in enumerate((ig, fg, gg, og)):
                        ga[rb, t, q * h + us] = gate
    return ys, ys[:, -1].clone(), cs[:, -1].clone(), cs, ga


def emulate_grid_backward(saved, h0, c0, w, dys, dh_last, dc_last, units,
                          walk, chunk, splits):
    """dgi, dh0, dc0, dW_hh, db_hh as the grid backward forms them: dh_rec
    of a CTA's units from dgi_{t+1} staged in chunks, over 4H in the split
    and lane order of the kernels, dc carried per CTA across steps; then
    dW_hh = dgiᵀ [h0, ys[:, :-1]] and db_hh the column sum of dgi over
    (b, t) in order."""
    ys, cs, ga = saved
    b, t_len, h = ys.shape
    dgi = torch.zeros(b, t_len, 4 * h)
    dh0, dc0 = torch.zeros(b, h), torch.zeros(b, h)
    for w0 in range(0, b, walk):
        nb = min(walk, b - w0)
        rb = slice(w0, w0 + nb)
        dc = dc_last[rb].clone()
        for t in range(t_len - 1, -2, -1):
            if t == t_len - 1:
                dh_rec = dh_last[rb]
            else:
                dh_rec = torch.zeros(nb, h)
                for cta in _cta_slices(h, units):
                    us = list(cta)
                    wt = w[:, us].t()          # the CTA's rows of W_hhᵀ
                    for c_lo, c_hi in _chunks(nb, chunk):
                        dh_rec[c_lo:c_hi, us] = _split_product(
                            dgi[w0 + c_lo:w0 + c_hi, t + 1], wt, splits)
            if t < 0:
                dh0[rb], dc0[rb] = dh_rec, dc
                break
            i, f, g, o = ga[rb, t].chunk(4, dim=-1)
            tanh_c = torch.tanh(cs[rb, t])
            c_prev = c0[rb] if t == 0 else cs[rb, t - 1]
            dh = dys[rb, t] + dh_rec
            do_pre = dh * tanh_c * o * (1 - o)
            dcv = dc + dh * o * (1 - tanh_c * tanh_c)
            dgi[rb, t] = torch.cat([dcv * g * i * (1 - i),
                                    dcv * c_prev * f * (1 - f),
                                    dcv * i * (1 - g * g), do_pre], dim=-1)
            dc = dcv * f
    hs_prev = torch.cat([h0[:, None], ys[:, :-1]], dim=1)
    dw_hh = dgi.reshape(-1, 4 * h).t() @ hs_prev.reshape(-1, h)
    db_hh = torch.cumsum(dgi.reshape(-1, 4 * h), dim=0)[-1]
    return dgi, dh0, dc0, dw_hh, db_hh


def _emulate_grid(arrays, cots, units, walk, chunk, splits):
    gi, h0, c0, w, bias = (torch.from_numpy(a) for a in arrays)
    dys, dhl, dcl = (torch.from_numpy(a) for a in cots)
    ys, hl, cl, cs, ga = emulate_grid_forward(gi, h0, c0, w, bias, units,
                                              walk, chunk, splits[0])
    grads = emulate_grid_backward((ys, cs, ga), h0, c0, w, dys, dhl, dcl,
                                  units, walk, chunk, splits[1])
    return ([x.numpy() for x in (ys, hl, cl)], [g.numpy() for g in grads])


def _grid_layout_of(b, t, h, sms, walk=None, chunk=None):
    """The plan's units and splits at (B, H) on `sms` SMs, with the walk and
    chunk the plan gives, or smaller ones that a small test shape would
    never get (the kernels take any walk and chunk the plan can give)."""
    plan = grid_plan(b, h, sms)
    walk = walk or min(plan.fwd.walk, plan.bwd.walk)
    chunk = chunk or min(plan.fwd.chunk, plan.bwd.chunk)
    return plan.units, walk, chunk, (plan.fwd.splits, plan.bwd.splits)


# (B, T, H, SMs, walk, chunk): H not a multiple of 4 with a ragged last CTA
# (H = 10 on 4 SMs: 3 units a CTA, the last 1), a unit count that does not
# divide H with two walks and chunks of one row, more than 8 rows in a chunk
# (two row groups of a tile), and one unit a CTA with every k split used.
GRID_SHAPES = [(3, 7, 10, 4, None, None), (5, 6, 13, 3, 2, 1),
               (11, 4, 8, 2, None, None), (4, 5, 6, 6, None, 3)]


@pytest.mark.parametrize("b,t,h,sms,walk,chunk", GRID_SHAPES)
def test_grid_emulation_matches_plain_autograd(b, t, h, sms, walk, chunk):
    """With a nonzero (h0, c0) carry."""
    arrays, cots = _arrays(b, t, h, seed=20 + b)
    out_e, grad_e = _emulate_grid(arrays, cots,
                                  *_grid_layout_of(b, t, h, sms, walk, chunk))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    outs = lstm_plain(*leaves)
    torch.autograd.backward(outs, [torch.from_numpy(x) for x in cots])
    _close(out_e, [o.detach().numpy() for o in outs], OUTS, FWD)
    _close(grad_e, [x.grad.numpy() for x in leaves], GRADS, GRAD)


@pytest.mark.parametrize("b,t,h,sms,walk,chunk", GRID_SHAPES)
def test_grid_emulation_matches_pallas(b, t, h, sms, walk, chunk):
    """The JAX package's kernel in interpret mode, as its own tests run
    it."""
    arrays, cots = _arrays(b, t, h, seed=30 + b)
    out_e, grad_e = _emulate_grid(arrays, cots,
                                  *_grid_layout_of(b, t, h, sms, walk, chunk))
    outs, vjp = jax.vjp(lambda *a: jax_fused_lstm(*a, True),
                        *[jnp.asarray(a) for a in arrays])
    grads = vjp(tuple(jnp.asarray(x) for x in cots))
    _close(out_e, [np.asarray(o) for o in outs], OUTS, FWD)
    _close(grad_e, [np.asarray(g) for g in grads], GRADS, GRAD)


@pytest.mark.parametrize("b,h", [(8, 512), (1, 512), (16, 512), (8, 510),
                                 (8, 1024)])
def test_plan_takes_the_grid_route(b, h):
    """The widths no cluster holds (512 and wider, or not a multiple of 4)
    at the trainer's and the ABX path's batches: one CTA an SM at most, the
    fewest units a CTA that needs no more CTAs than SMs, every unit owned,
    the batch walked at once, and both directions' layouts within one
    block's shared memory."""
    plan = lstm_plan(b, h, SMS)
    assert plan.route == "grid" and plan.cluster == 0 and plan.bc == 0
    assert plan.ctas <= SMS and plan.units == -(-h // SMS)
    assert (plan.ctas - 1) * plan.units < h <= plan.ctas * plan.units
    for layout in (plan.fwd, plan.bwd):
        assert layout.walk == b and 1 <= layout.chunk
        assert 0 < layout.smem <= SMEM_LIMIT
    assert plan.smem == max(plan.fwd.smem, plan.bwd.smem)


def test_grid_plan_at_512_holds_the_kernels_layout():
    """At (8, 512) on 132 SMs: 128 CTAs of 4 units. The forward keeps its
    16 gate rows of W_hh (32 KB) and stages the 8 rows of h_{t-1}; 4 tiles
    (a unit's 4 gates x 8 rows) in 2 k splits fill the 8 warps. The
    backward keeps its 4 columns of W_hh as rows of W_hhᵀ (32 KB) and
    stages dgi_{t+1} (8 x 2,048 floats); one tile (4 units x 8 rows) in 8
    splits. The byte counts are `grid_layout` of `csrc/lstm.cu`."""
    plan = lstm_plan(8, 512, SMS)
    assert (plan.ctas, plan.units) == (128, 4)
    assert plan.fwd == GridLayout(8, 8, 2, 1,
                                  4 * (16 * 512 + 8 * 512 + 2 * 4 * 32))
    assert plan.bwd == GridLayout(8, 8, 8, 1,
                                  4 * (4 * 2048 + 8 * 2048 + 8 * 1 * 32))
    assert plan.smem == plan.bwd.smem == 99328


@pytest.mark.parametrize("b,h", [(4, 1400), (8, 1300)])
def test_grid_plan_reads_the_slice_from_l2_where_it_does_not_fit(b, h):
    """At H = 1,400 (11 units a CTA) neither slice fits beside one staged
    row (the forward's 44 rows of 1,400 floats are 246,400 bytes), so both
    directions read W_hh from L2 with the whole batch staged; at H = 1,300
    the forward's slice still fits beside 4 staged rows (two chunks a step)
    and the backward's does not."""
    plan = lstm_plan(b, h, SMS)
    units = plan.units
    assert plan.route == "grid"
    # the backward's slice: 4 ceil(units / 4) rows of W_hhᵀ, 4H floats each
    assert 4 * 4 * -(-units // 4) * 4 * h > SMEM_LIMIT
    assert plan.bwd.w_smem == 0 and plan.bwd.chunk == b
    assert plan.bwd.smem == 4 * (b * 4 * h
                                 + 32 * plan.bwd.splits * -(-units // 4))
    if h == 1400:
        assert 4 * 4 * units * h > SMEM_LIMIT - 4 * h
        assert plan.fwd.w_smem == 0 and plan.fwd.chunk == b
    else:
        assert plan.fwd.w_smem == 1 and plan.fwd.chunk == 4
        assert plan.fwd.smem == 4 * (4 * units * h + 4 * h + 32 * units)


def test_grid_layout_walks_the_batch_in_blocks_a_thread_can_carry():
    """Each thread carries c (dc) of at most CELL_ITEMS (unit, row) items,
    so a walk holds GRID_THREADS * CELL_ITEMS / units rows; a larger batch
    is walked in several blocks, each staged in chunks of its rows."""
    layout = grid_layout(3000, 2, 1, backward=False)
    assert layout.walk == GRID_THREADS * CELL_ITEMS
    assert layout.chunk == layout.walk
    assert grid_layout(5, 205, 205, backward=True).walk == 4
    # one staged row of dgi (4H floats) and its partials beside it: up to
    # H = 14,304 on 132 SMs
    assert grid_plan(1, 14304, SMS).bwd.chunk == 1
    with pytest.raises(ValueError):
        grid_plan(1, 14305, SMS)


@pytest.mark.parametrize("h", [4, 64, 256, 510, 512, 777, 1024, 1400, 2048])
def test_plan_covers_every_batch_at_every_width(h):
    """Every (B, H) gets a route: the resident one where a cluster holds
    the slice, else the grid, whose layout fits and covers the batch (the
    per-step route took every width the resident one did not)."""
    for b in (1, 2, 5, 8, 16, 33, 400):
        plan = lstm_plan(b, h, SMS)
        if plan.route == "resident":
            assert 0 < resident_smem(h, plan.cluster, plan.bc) <= SMEM_LIMIT
            continue
        assert plan.route == "grid" and plan.ctas <= SMS
        for layout in (plan.fwd, plan.bwd):
            assert 1 <= layout.chunk <= layout.walk <= b
            assert layout.smem <= SMEM_LIMIT
