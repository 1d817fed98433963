"""The LSTM's resident cluster kernels on the CPU (`cpc2_torch/ops/lstm.py`,
`cpc2_torch/csrc/lstm.cu`).

A CUDA kernel cannot run here, so the kernels' decomposition is emulated in
torch, in this file: the forward by batch tiles (one per cluster, the last
one ragged) and by CTA row slices (each CTA's 4H/C gate rows of W_hh, its
product summed over k slices in order), with h gathered from every CTA's
slice after each step; the backward forms each CTA's row-slice partial
P_j = dgi_{t+1}[:, R_j] W[R_j, :] and sums the partials per unit in rank
order, with db_hh a running sum over t per batch row, then summed over
rows and tiles in order. The emulation is held against autograd of
`lstm_plain` and against the JAX package's Pallas kernel in interpret mode,
with the same inputs made from a seed with numpy. Then `lstm_plan`, which
picks the route and tiles from (B, H) on the CPU and on the card alike.

Tolerances are fp32 reordering: rtol 1e-5, atol 1e-6 for the forward and
rtol 1e-4, atol 1e-6 for the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc2_tpu.ops.lstm_pallas import fused_lstm as jax_fused_lstm
from cpc2_torch.ops.lstm import (BATCH_TILES, MAX_CLUSTERS, SMEM_LIMIT,
                                 lstm_plain, lstm_plan, resident_smem)

torch.set_num_threads(1)

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
    plan = lstm_plan(b, 256)
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
    """A 512-wide W_hh slice does not fit a CTA at either cluster size."""
    plan = lstm_plan(8, 512)
    assert plan.route == "steps" and plan.cluster == 0 and plan.bc == 0
    for cluster in (8, 16):
        assert 4 * (4 * 512 // cluster) * 512 > SMEM_LIMIT
        assert not 0 < resident_smem(512, cluster, 8) <= SMEM_LIMIT


def test_plan_of_the_recipe():
    """At the recipe eight clusters of 16 CTAs each walk one sequence: 64 KB
    of W_hh a CTA, two mbarriers, h double-buffered, the forward's and the
    backward's partial sums and slots; the backward's layout is the larger."""
    bwd = 4 * (64 * 256 + 4 * 1 * 256 + 1 * 64 + 2 * 16 * 1 * 16)
    assert lstm_plan(8, 256) == ("resident", 16, 1, 16 + bwd)
