"""The plain PyTorch versions of the port's three training-step kernels
(`cpc2_torch/ops/{lstm,ffn,infonce}.py`) against the JAX package's Pallas
kernels, run in interpret mode on the CPU as the JAX package's own tests
run them, and every kernel wrapper off the CPU. The same inputs, made from
a seed with numpy, go to both sides.

Tolerances are fp32 reordering: rtol 1e-5, atol 1e-6 for forwards and
rtol 1e-4, atol 1e-6 for gradients, unless a test states a looser one
with its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc2_tpu.ops.ffn_pallas import fused_ffn as jax_fused_ffn
from cpc2_tpu.ops.infonce_pallas import negative_scores_pallas
from cpc2_tpu.ops.lstm_pallas import fused_lstm as jax_fused_lstm
from cpc2_torch.ops import _build
from cpc2_torch.ops.attention import fused_relpos_attention
from cpc2_torch.ops.encoder import fused_encoder
from cpc2_torch.ops.ffn import (dropout_bits, ffn_plain, fused_ffn,
                                keep_mask)
from cpc2_torch.ops.infonce import (SMEM_LIMIT, dz_partial_floats,
                                    infonce_plan, negative_scores,
                                    negative_scores_plain)
from cpc2_torch.ops.lstm import (_LSTMGrid, _LSTMResident, fused_lstm,
                                 grid_plan)

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _torch_grads(fn, arrays, cotangents):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cotangents])
    return ([o.detach().numpy() for o in outs],
            [leaf.grad.numpy() for leaf in leaves])


def _jax_grads(fn, arrays, cotangents):
    outs, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    outs = outs if isinstance(outs, tuple) else (outs,)
    cots = tuple(jnp.asarray(c) for c in cotangents)
    grads = vjp(cots if len(cots) > 1 else cots[0])
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _assert_all_close(got, want, names, tol):
    for g, w, name in zip(got, want, names):
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


@pytest.mark.parametrize("b,t,h", [(2, 13, 8), (3, 16, 4)])
def test_lstm_plain_matches_pallas(b, t, h):
    """Forward and all five gradients, with a nonzero (h0, c0) carry; T = 13
    is not a multiple of 8."""
    rs = np.random.RandomState(0)
    arrays = [rs.randn(b, t, 4 * h).astype(np.float32),
              rs.randn(b, h).astype(np.float32),
              rs.randn(b, h).astype(np.float32),
              (rs.randn(4 * h, h) / np.sqrt(h)).astype(np.float32),
              (rs.randn(4 * h) / np.sqrt(h)).astype(np.float32)]
    cots = [rs.randn(b, t, h).astype(np.float32),
            rs.randn(b, h).astype(np.float32),
            rs.randn(b, h).astype(np.float32)]
    out_t, grad_t = _torch_grads(fused_lstm, arrays, cots)
    out_j, grad_j = _jax_grads(lambda *a: jax_fused_lstm(*a, True), arrays,
                               cots)
    _assert_all_close(out_t, out_j, ["ys", "h_last", "c_last"], FWD)
    _assert_all_close(grad_t, grad_j,
                      ["dgi", "dh0", "dc0", "dw_hh", "db_hh"], GRAD)


def test_ffn_plain_matches_pallas_at_rate_0():
    """The TPU kernel's mask comes from the TPU's own generator, so the
    two are compared with dropout off."""
    rs = np.random.RandomState(1)
    m, din, dff, dout = 16, 8, 32, 8
    arrays = [rs.randn(m, din).astype(np.float32),
              (0.3 * rs.randn(dff, din)).astype(np.float32),
              (0.3 * rs.randn(dff)).astype(np.float32),
              (0.3 * rs.randn(dout, dff)).astype(np.float32),
              (0.3 * rs.randn(dout)).astype(np.float32)]
    cots = [rs.randn(m, dout).astype(np.float32)]
    seed_t = torch.zeros(1, dtype=torch.int32)
    seed_j = jnp.zeros((1, 1), jnp.int32)
    out_t, grad_t = _torch_grads(lambda *a: fused_ffn(*a, seed_t, 0.0),
                                 arrays, cots)
    out_j, grad_j = _jax_grads(
        lambda *a: jax_fused_ffn(*a, seed_j, 0.0, True), arrays, cots)
    _assert_all_close(out_t, out_j, ["y"], FWD)
    _assert_all_close(grad_t, grad_j, ["dx", "dw1", "db1", "dw2", "db2"],
                      GRAD)


@pytest.mark.parametrize("b,k,w,d,p,n,round_cot", [
    (2, 3, 11, 16, 40, 12, False),  # the first port's case
    (3, 5, 9, 36, 70, 20, True),    # K, N, D off the kernels' 8/16 tiles
    (1, 2, 5, 8, 1500, 8, True),    # a pool above the JAX kernel's 1,024
])
def test_negative_scores_plain_matches_pallas(b, k, w, d, p, n, round_cot):
    """Forward, dpreds and the scatter-add dz, with repeated indices. The
    Pallas kernel carries its f32 values through bf16 planes (three for
    the scores, two for the spread cotangent), which keep about 24 and 16
    bits: the forward is held to rtol 1e-5 with atol 1e-5 and the
    gradients to rtol 1e-4 with atol 2e-5 for that reason. The first case
    takes full fp32 cotangents. The others round the cotangent to 16
    significant bits, which the two planes carry exactly: with full fp32
    cotangents the Pallas kernel's own dpreds lies up to 5.3e-5 from its
    float64 value at K = 5, N = 20, past that atol (the plain version
    3.2e-6)."""
    rs = np.random.RandomState(2)
    idx = rs.randint(0, p, size=(b, w, n)).astype(np.int32)
    idx[:, :, ::3] = 7                      # one pool row drawn many times
    arrays = [rs.randn(b, k, w, d).astype(np.float32),
              rs.randn(p, d).astype(np.float32)]
    g = rs.randn(b, k, w, n).astype(np.float32)
    if round_cot:
        g = (g.view(np.uint32) + np.uint32(0x80)
             & np.uint32(0xFFFFFF00)).view(np.float32)
    idx_t, idx_j = torch.from_numpy(idx), jnp.asarray(idx)
    out_t, grad_t = _torch_grads(lambda a, z: negative_scores(a, z, idx_t),
                                 arrays, [g])
    out_j, grad_j = _jax_grads(
        lambda a, z: negative_scores_pallas(a, z, idx_j, interpret=True),
        arrays, [g])
    _assert_all_close(out_t, out_j, ["neg"], dict(rtol=1e-5, atol=1e-5))
    _assert_all_close(grad_t, grad_j, ["dpreds", "dz"],
                      dict(rtol=1e-4, atol=2e-5))


def test_infonce_plan_at_the_recipe():
    """The recipe's launches: 64-row blocks of whole 1 KB rows, one group
    of predictions and one chunk of sampled rows, the dz accumulator of 128
    pool rows x 256 columns (128 KB) in 8 tiles, each tile's 928 units
    split 16 ways so that 128 dz CTAs fill the card."""
    plan = infonce_plan(8, 12, 116, 128, 256, 1024)
    assert (plan.kp, plan.fwd_rb, plan.fwd_dc, plan.fwd_stride,
            plan.fwd_stages, plan.fwd_grid) == (16, 64, 256, 260, 2, 132)
    assert plan.fwd_smem == 128 + 4 * 2 * (64 + 16) * 260
    assert (plan.bwd_n, plan.bwd_rb, plan.bwd_dc, plan.bwd_zs, plan.bwd_gs,
            plan.bwd_stages, plan.bwd_grid) == (128, 64, 256, 264, 68, 3,
                                                132)
    assert (plan.nc, plan.dzc, plan.dz_stage, plan.dz_stages) == (
        128, 256, 128 + 12 * 128 + 12 * 256, 4)
    assert (plan.pt, plan.row_tiles, plan.col_slices, plan.splits) == (
        128, 8, 1, 16)
    assert dz_partial_floats(plan, 256) == 16 * 8 * 128 * 256
    # a 4,096-row pool: more tiles, fewer splits
    big = infonce_plan(8, 12, 116, 128, 256, 4096)
    assert (big.pt, big.row_tiles, big.splits) == (128, 32, 4)
    # one (b, w): one split, whose partial is the whole of dz
    small = infonce_plan(1, 3, 1, 8, 16, 40)
    assert small.splits == 1 and dz_partial_floats(small, 16) == 40 * 16


def _kernels_take(plan, k, n, d, p):
    """`csrc/infonce.cu:fwd_ok` and `bwd_ok` on a plan: what the kernels'
    register arrays and fragment layouts take, and stages and shared
    memory that hold what the kernels put there."""
    kp, kr = plan.kp, min(k, plan.kp)
    fwd = (plan.fwd_rb in (16, 32, 64, 128)
           and plan.fwd_rb // 16 * kp // 8 <= 16
           and plan.fwd_dc % 8 == 0 and plan.fwd_stride >= plan.fwd_dc
           and plan.fwd_stride % 4 == 0 and plan.fwd_stage % 4 == 0
           and plan.fwd_stage >= (plan.fwd_rb + kp) * plan.fwd_stride
           and 1 <= plan.fwd_stages <= 8
           and plan.fwd_smem >= 128 + 4 * plan.fwd_stages * plan.fwd_stage)
    bwd = (plan.bwd_n % 4 == 0 and plan.bwd_n >= n
           and plan.bwd_rb in (16, 32, 64, 128)
           and plan.bwd_dc % 8 == 0 and 0 < plan.bwd_dc <= 256
           and plan.bwd_zs >= plan.bwd_dc and plan.bwd_zs % 4 == 0
           and plan.bwd_gs >= plan.bwd_rb and plan.bwd_gs % 4 == 0
           and plan.bwd_stage % 4 == 0
           and plan.bwd_stage >= plan.bwd_rb * plan.bwd_zs + kp * plan.bwd_gs
           and 1 <= plan.bwd_stages <= 8
           and plan.nc == min(plan.bwd_n, 256)
           and plan.dzc % 4 == 0 and 0 < plan.dzc <= 256 * 64 // kp
           and plan.dz_stage % 4 == 0
           and plan.dz_stage >= plan.nc * (1 + kr) + kr * plan.dzc
           and 1 <= plan.dz_stages <= 8
           and plan.row_tiles * plan.pt >= p > (plan.row_tiles - 1) * plan.pt
           and plan.col_slices * plan.dzc >= d
           > (plan.col_slices - 1) * plan.dzc
           and plan.bwd_smem >= 128 + 4 * plan.bwd_stages * plan.bwd_stage
           and plan.bwd_smem >= 128 + 4 * (
               plan.dz_stages * plan.dz_stage + plan.pt * plan.dzc
               + 8 * plan.nc))
    return fwd and bwd


@pytest.mark.parametrize("k", [1, 5, 12, 16, 17, 32, 40, 64])
@pytest.mark.parametrize("n", [4, 10, 20, 128, 256, 384, 1000])
def test_infonce_plan_fits_shared_memory(k, n):
    """Every shape gets a plan the kernels take (`_kernels_take`), within a
    block's 227 KB, with at least two stages a ring, whole rows of D a
    forward stage where they fit, and at most one dz CTA a multiprocessor
    when the tiles allow."""
    for d in (4, 36, 256, 1032, 2048, 4800):
        for p in (1, 40, 1024, 5000):
            plan = infonce_plan(3, k, 7, n, d, p)
            assert _kernels_take(plan, k, n, d, p), plan
            assert max(plan.fwd_smem, plan.bwd_smem) <= SMEM_LIMIT
            assert min(plan.fwd_stages, plan.bwd_stages,
                       plan.dz_stages) >= 2
            assert plan.kp == (16 if k <= 16 else 32)
            if d <= 256:
                assert plan.fwd_dc >= d
            tiles = plan.row_tiles * plan.col_slices
            assert 1 <= plan.splits <= 3 * 7
            assert tiles * plan.splits <= max(132, tiles)
            assert plan.fwd_grid == plan.bwd_grid == 21


@pytest.mark.parametrize("shape", [
    (2, 3, 5, 8, 30, 40),       # D not a multiple of 4 (the wrapper pads)
    (2, 3, 0, 8, 16, 40),       # an empty dimension
    (2, 0, 5, 8, 16, 40),       # no predictions
    (2, 3, 5, 0, 16, 40),       # no samples
    (2, 3, 5, 8, 16, 0),        # an empty pool
])
def test_infonce_plan_raises_on_shapes_the_kernels_do_not_take(shape):
    with pytest.raises(ValueError):
        infonce_plan(*shape)


def _emulate_walk(plan, preds, z, idx, g):
    """The kernels' decomposition in float64, item by item as
    `csrc/infonce.cu` walks it: the forward by groups of kp predictions,
    blocks of fwd_rb sampled rows and chunks of fwd_dc columns (sums
    carried across chunks); dpreds by groups, bwd_dc chunks and bwd_rb
    blocks; dz by (row tile, column slice, split), each split by groups,
    chunks of 256 sampled rows and its run of units in order, then the
    splits summed in order. Inputs at the kernels' shapes (D and the
    backward's N padded)."""
    b, k, w, d = preds.shape
    n, p = idx.shape[2], z.shape[0]
    out = torch.zeros(b, k, w, n, dtype=torch.float64)
    dpreds = torch.zeros_like(preds)
    for u in range(b * w):
        bi, wi = divmod(u, w)
        for k0 in range(0, k, plan.kp):
            k1 = min(k, k0 + plan.kp)
            for r0 in range(0, n, plan.fwd_rb):
                r1 = min(n, r0 + plan.fwd_rb)
                for d0 in range(0, d, plan.fwd_dc):
                    d1 = min(d, d0 + plan.fwd_dc)
                    zg = z[idx[bi, wi, r0:r1].long(), d0:d1]
                    out[bi, k0:k1, wi, r0:r1] += \
                        preds[bi, k0:k1, wi, d0:d1] @ zg.T
    nb = plan.bwd_n
    gp = torch.nn.functional.pad(g, (0, nb - n))
    ip = torch.nn.functional.pad(idx, (0, nb - n))
    for u in range(b * w):
        bi, wi = divmod(u, w)
        for k0 in range(0, k, plan.kp):
            k1 = min(k, k0 + plan.kp)
            for d0 in range(0, d, plan.bwd_dc):
                d1 = min(d, d0 + plan.bwd_dc)
                for r0 in range(0, nb, plan.bwd_rb):
                    r1 = min(nb, r0 + plan.bwd_rb)
                    dpreds[bi, k0:k1, wi, d0:d1] += \
                        gp[bi, k0:k1, wi, r0:r1] @ z[ip[bi, wi, r0:r1].long(),
                                                     d0:d1]
    rows = plan.row_tiles * plan.pt
    partial = torch.zeros(plan.splits, rows, d, dtype=torch.float64)
    units = b * w
    for tile in range(plan.row_tiles * plan.col_slices):
        row0 = tile // plan.col_slices * plan.pt
        c0 = tile % plan.col_slices * plan.dzc
        c1 = min(d, c0 + plan.dzc)
        for s in range(plan.splits):
            for k0 in range(0, k, plan.kp):
                k1 = min(k, k0 + plan.kp)
                for j0 in range(0, nb, 256):
                    for u in range(s * units // plan.splits,
                                   (s + 1) * units // plan.splits):
                        bi, wi = divmod(u, w)
                        for j in range(j0, min(nb, j0 + 256)):
                            r = int(ip[bi, wi, j]) - row0
                            if 0 <= r < min(plan.pt, p - row0):
                                partial[s, row0 + r, c0:c1] += (
                                    gp[bi, k0:k1, wi, j]
                                    @ preds[bi, k0:k1, wi, c0:c1])
    return out, dpreds, partial.sum(0)[:p]


@pytest.mark.parametrize("b,k,w,n,d,p", [
    (2, 3, 5, 12, 16, 40),       # one item a unit
    (2, 40, 3, 10, 36, 50),      # two groups of predictions, N padded
    (1, 12, 2, 300, 8, 1030),    # two chunks of sampled rows, several tiles
    (1, 20, 2, 8, 1032, 40),     # forward chunks and dz slices of D
])
def test_infonce_plan_walk_computes_the_function(b, k, w, n, d, p):
    """The plan's decomposition, emulated in float64 (`_emulate_walk`),
    gives the plain version's scores and gradients: its groups, blocks,
    chunks, tiles, slices and splits cover every entry once."""
    rs = np.random.RandomState(4)
    preds = torch.from_numpy(rs.randn(b, k, w, d))
    z = torch.from_numpy(rs.randn(p, d))
    idx = torch.from_numpy(rs.randint(0, p, size=(b, w, n)).astype(np.int32))
    idx[:, :, ::3] = p - 1                  # the last pool row, repeatedly
    g = torch.from_numpy(rs.randn(b, k, w, n))
    plan = infonce_plan(b, k, w, n, d, p, sms=7)
    out, dpreds, dz = _emulate_walk(plan, preds, z, idx, g)
    pr, zr = preds.clone().requires_grad_(True), z.clone().requires_grad_(True)
    want = negative_scores_plain(pr, zr, idx)
    want.backward(g)
    for got, ref in ((out, want.detach()), (dpreds, pr.grad), (dz, zr.grad)):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


def test_three_tf32_split_keeps_fp32_accuracy():
    """The kernels' 3xTF32 products (`csrc/infonce.cu:split_tf32`): big =
    x rounded to TF32 by adding half an ulp and clearing the low 13 bits,
    small = x - big truncated to TF32 by the tensor core, a * b taken as
    small_a big_b + big_a small_b + big_a big_b. Emulated here in float64:
    every product errs by under 2.5 * 2^-21 of |a b|, and dots of 256
    terms by under 1e-6 of the largest, where one TF32 product alone errs
    by about 1e-3."""
    rs = np.random.RandomState(5)
    a = rs.randn(64, 256).astype(np.float32)
    b = rs.randn(12, 256).astype(np.float32)

    def split(x):
        bits = x.view(np.uint32)
        big = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
            np.float32)
        small = (x - big).view(np.uint32) & np.uint32(0xFFFFE000)
        return big.astype(np.float64), small.view(np.float32).astype(
            np.float64)
    ab, as_ = split(a)
    bb, bs = split(b)
    exact = a.astype(np.float64)[:, None, :] * b.astype(np.float64)[None]
    three = (as_[:, None] * bb[None] + ab[:, None] * bs[None]
             + ab[:, None] * bb[None])
    assert (np.abs(three - exact) <= 2.5 * 2.0 ** -21 * np.abs(exact)).all()
    dots = a.astype(np.float64) @ b.astype(np.float64).T
    err = np.abs(three.sum(-1) - dots).max() / np.abs(dots).max()
    one = np.abs((ab @ bb.T) - dots).max() / np.abs(dots).max()
    assert err < 1e-6 and one > 1e-4


def _mix32_int(x):
    """csrc/common.cuh:mix32 on Python ints, uint32 arithmetic."""
    m = 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & m
    x ^= x >> 15
    x = (x * 0x846CA68B) & m
    return x ^ (x >> 16)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 2])
def test_dropout_hash_is_uint32_arithmetic(seed):
    """The int64 emulation draws the bits the CUDA kernel draws."""
    rows, cols = 5, 7
    got = dropout_bits(torch.tensor([seed], dtype=torch.int32), rows, cols)
    want = [[_mix32_int((_mix32_int(seed ^ _mix32_int(r)) + c) & 0xFFFFFFFF)
             for c in range(cols)] for r in range(rows)]
    np.testing.assert_array_equal(got.numpy(), np.array(want))


def test_ffn_mask_rate_and_forward_backward_agree():
    """At p = 0.1 the mask keeps 90% of the hidden, differs between seeds,
    and the backward of `ffn_plain` uses the forward's mask."""
    m, din, dff, dout = 256, 8, 2048, 8
    seed = torch.tensor([77], dtype=torch.int32)
    keep = keep_mask(seed, m, dff, 0.1)
    assert abs(keep.float().mean().item() - 0.9) < 0.005
    other = keep_mask(torch.tensor([78], dtype=torch.int32), m, dff, 0.1)
    assert (keep != other).float().mean().item() > 0.1

    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(m, din).astype(np.float32))
    w1 = torch.from_numpy((0.3 * rs.randn(dff, din)).astype(np.float32))
    b1 = torch.from_numpy((0.3 * rs.randn(dff)).astype(np.float32))
    w2 = torch.from_numpy((0.3 * rs.randn(dout, dff)).astype(np.float32))
    b2 = torch.from_numpy((0.3 * rs.randn(dout)).astype(np.float32))
    g = torch.from_numpy(rs.randn(m, dout).astype(np.float32))
    xr = x.clone().requires_grad_(True)
    y = ffn_plain(xr, w1, b1, w2, b2, seed, 0.1)
    y.backward(g)

    pre = x @ w1.t() + b1
    hidden = torch.where(keep, torch.relu(pre) / 0.9, torch.zeros_like(pre))
    torch.testing.assert_close(y.detach(), hidden @ w2.t() + b2,
                               **dict(rtol=1e-5, atol=1e-6))
    dh = torch.where(keep & (pre > 0), (g @ w2) / 0.9, torch.zeros_like(pre))
    torch.testing.assert_close(xr.grad, dh @ w1, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("call", ["lstm", "lstm_resident", "lstm_steps",
                                  "ffn", "ffn_bf16", "infonce", "attention",
                                  "encoder"])
def test_kernel_wrappers_raise_off_cpu_without_a_card(call):
    """A tensor that is not on the CPU goes to the kernel or raises; here
    (no card) a meta tensor raises before anything is built or counted."""
    before = dict(_build.LAUNCHES)
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        if call == "lstm":
            fused_lstm(torch.empty(2, 3, 16, **meta),
                       torch.empty(2, 4, **meta), torch.empty(2, 4, **meta),
                       torch.empty(16, 4, **meta), torch.empty(16, **meta))
        elif call in ("lstm_resident", "lstm_steps"):
            # each route's own entry, at the recipe's width (`lstm_steps`:
            # the grid route, which took the per-step route's place)
            args = (torch.empty(2, 3, 1024, **meta),
                    torch.empty(2, 256, **meta), torch.empty(2, 256, **meta),
                    torch.empty(1024, 256, **meta), torch.empty(1024, **meta))
            if call == "lstm_resident":
                _LSTMResident.apply(*args, 8, 2)
            else:
                _LSTMGrid.apply(*args, grid_plan(2, 256, 132))
        elif call in ("ffn", "ffn_bf16"):
            fused_ffn(torch.empty(4, 8, **meta), torch.empty(16, 8, **meta),
                      torch.empty(16, **meta), torch.empty(8, 16, **meta),
                      torch.empty(8, **meta),
                      torch.zeros(1, dtype=torch.int32, **meta),
                      bf16=call == "ffn_bf16")
        elif call == "infonce":
            negative_scores(torch.empty(1, 2, 3, 8, **meta),
                            torch.empty(5, 8, **meta),
                            torch.zeros(1, 3, 4, dtype=torch.int32, **meta))
        elif call == "attention":
            fused_relpos_attention(
                torch.empty(2, 5, 4, **meta), torch.empty(2, 5, 4, **meta),
                torch.empty(2, 5, 4, **meta), torch.empty(4, 5, **meta),
                torch.zeros(1, dtype=torch.int32, **meta), 0.1)
        else:
            c, cin, conv_w = 32, 1, []
            for k in (10, 8, 4, 4, 4):
                conv_w.append(torch.empty(c, cin, k, **meta))
                cin = c
            vecs = [[torch.empty(c, **meta) for _ in range(5)]
                    for _ in range(3)]
            fused_encoder(torch.empty(2, 320, **meta), conv_w, *vecs)
    assert _build.LAUNCHES == before
    assert _build._lib is None
