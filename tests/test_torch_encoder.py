"""The port's encoder kernels' plain version (`cpc2_torch/ops/encoder.py`)
against the JAX package's Pallas encoder, run in interpret mode on the CPU
as the JAX package's own tests run it, with the same inputs made from a
seed with numpy; the opt-in module path; the gate; and the kernels' plan
(`encoder_plan`), mirrored here, with the three products of layers 2-5
emulated in fp32 from the plan's per-tap boxes and held to `F.conv1d` and
its gradients.

Tolerances are the JAX package's for this kernel
(`tests/test_encoder_pallas.py:113,124-125`), as a max abs error over the
largest reference value: 2e-5 for the output, 1e-5 for the bias and norm
gradients, and 2e-3 for dx and the conv weights, whose sums take dy in
bf16: a dy value that lands within fp32 reordering noise of a bf16
rounding boundary rounds one way on one side and the other way on the
other, which is rounding chatter, not structure. At other input seeds than
the one below, such a flip three layers up has moved the lowest layers'
bias and norm gradients by up to 5e-5. The module path agrees with the
cuDNN path at the bf16 level, 2e-2 (`tests/test_encoder_pallas.py:158`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cpc2_tpu.ops.encoder_pallas import fused_encoder as jax_fused_encoder
from cpc2_torch.models.encoder import CPCEncoder
from cpc2_torch.ops import encoder as enc
from cpc2_torch.ops.encoder import (BOX, CONV_STACK, TILE, WGRAD_ROWS,
                                    encoder_plain, encoder_plan,
                                    fused_encoder, use_fused_encoder)
from cpc2_torch.training import full_fp32, set_precision

torch.set_num_threads(1)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _params(rs, c):
    conv_w, conv_b, norm_w, norm_b = [], [], [], []
    cin = 1
    for k, _s, _p in CONV_STACK:
        conv_w.append((0.2 * rs.randn(c, cin, k)).astype(np.float32))
        conv_b.append((0.1 * rs.randn(c)).astype(np.float32))
        norm_w.append((1.0 + 0.2 * rs.randn(c)).astype(np.float32))
        norm_b.append((0.1 * rs.randn(c)).astype(np.float32))
        cin = c
    return conv_w, conv_b, norm_w, norm_b


@pytest.fixture
def tf32_flags():
    """Restore the library-precision switches that a test sets."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def test_encoder_plain_matches_pallas():
    """Forward and all five gradients at N 1, 2 frames, C 128 (the JAX
    kernel's smallest width)."""
    n, f, c = 1, 2, 128
    rs = np.random.RandomState(1)
    groups = _params(rs, c)
    x = rs.randn(n, 160 * f).astype(np.float32)
    cot = rs.randn(n, f, c).astype(np.float32)

    out_j, vjp = jax.vjp(
        lambda x, *g: jax_fused_encoder(x, *g, True), jnp.asarray(x),
        *[tuple(map(jnp.asarray, g)) for g in groups])
    grads_j = vjp(jnp.asarray(cot))

    x_t = torch.from_numpy(x).requires_grad_(True)
    groups_t = [[torch.from_numpy(a).requires_grad_(True) for a in g]
                for g in groups]
    out = fused_encoder(x_t, *groups_t)
    out.backward(torch.from_numpy(cot))

    assert out.shape == (n, f, c)
    assert _rel(out.detach().numpy(), np.asarray(out_j)) < 2e-5
    assert _rel(x_t.grad.numpy(), np.asarray(grads_j[0])) < 2e-3
    tols = {"dconv_w": 2e-3, "dconv_b": 1e-5, "dnorm_w": 1e-5,
            "dnorm_b": 1e-5}
    for (name, tol), got, want in zip(tols.items(), groups_t, grads_j[1:]):
        err = _rel(np.concatenate([t.grad.numpy().ravel() for t in got]),
                   np.concatenate([np.asarray(w).ravel() for w in want]))
        assert err < tol, (name, err)


def test_module_with_fused_encoder_routes_to_plain(monkeypatch, tf32_flags):
    """Under bf16mix with CPC2_FUSED_ENCODER=1 the module runs
    `encoder_plain` (on the CPU) with the same state-dict keys and agrees
    with the cuDNN path at the bf16 level: the output, and the last layer's
    gradients. Lower layers' gradients pass through more ChannelNorm
    projections, which cancel most of each bf16-rounded dy, so there the
    two paths part by up to about 25% of the largest value at this
    initialization; `test_encoder_plain_matches_pallas` holds them against
    the JAX package's bf16 kernel instead."""
    torch.manual_seed(0)
    mod = CPCEncoder(64)
    x = torch.randn(2, 1, 480)
    keys = set(mod.state_dict())
    monkeypatch.delenv("CPC2_FUSED_ENCODER", raising=False)
    set_precision("bf16mix")
    want = mod(x)
    want.pow(2).sum().backward()
    want_grads = [p.grad.clone() for p in mod.parameters()]
    mod.zero_grad()

    monkeypatch.setenv("CPC2_FUSED_ENCODER", "1")
    calls = []
    monkeypatch.setattr(enc, "encoder_plain",
                        lambda *a: calls.append(1) or encoder_plain(*a))
    got = mod(x)
    got.pow(2).sum().backward()
    assert calls == [1]
    assert set(mod.state_dict()) == keys
    assert got.shape == want.shape == (2, 3, 64)
    assert 0 < _rel(got.detach().numpy(), want.detach().numpy()) < 2e-2
    for (name, p), w in zip(mod.named_parameters(), want_grads):
        if name.endswith("4.weight") or name.endswith("4.bias"):
            assert _rel(p.grad.numpy(), w.numpy()) < 2e-2, name


@pytest.mark.parametrize("case", ["fp32", "full_fp32", "instanceNorm",
                                  "batchNorm", "ID", "T", "width", "dtype",
                                  "stack"])
def test_gate_declines_what_the_kernels_do_not_compute(case, monkeypatch,
                                                      tf32_flags):
    monkeypatch.setenv("CPC2_FUSED_ENCODER", "1")
    set_precision("bf16mix")
    args = dict(t=20480, c=256)
    assert use_fused_encoder(**args)
    if case == "fp32":
        set_precision("fp32")
        assert not use_fused_encoder(**args)
    elif case == "full_fp32":
        with full_fp32():
            assert not use_fused_encoder(**args)
        assert use_fused_encoder(**args)
    elif case in ("instanceNorm", "batchNorm", "ID"):
        assert not use_fused_encoder(**args, norm_mode=case)
    elif case == "T":
        assert not use_fused_encoder(20480 + 80, 256)
    elif case == "width":
        assert not use_fused_encoder(20480, 96)
        assert not use_fused_encoder(20480, 512)
    elif case == "dtype":
        assert not use_fused_encoder(**args, dtype=torch.float64)
    else:
        stack = ((10, 5, 3), (8, 4, 2), (4, 2, 1), (4, 2, 1), (3, 2, 1))
        assert not use_fused_encoder(**args, conv_stack=stack)


def test_gate_is_off_by_default(monkeypatch, tf32_flags):
    monkeypatch.delenv("CPC2_FUSED_ENCODER", raising=False)
    set_precision("bf16mix")
    assert not use_fused_encoder(20480, 256)
    monkeypatch.setenv("CPC2_FUSED_ENCODER", "0")
    assert not use_fused_encoder(20480, 256)
    monkeypatch.setenv("CPC2_FUSED_ENCODER", "on")
    assert use_fused_encoder(20480, 256)


# --- the kernels' plan ------------------------------------------------------

# Shapes of the plan's checks: the recipe, and each narrower width at T = 160
# and 1,120 (layer 5 then has 1 and 7 frames, off every tile).
PLAN_SHAPES = [(16, 20480, 256)] + [(n, t, c) for c in (32, 64, 128)
                                    for n, t in ((2, 160), (3, 1120))]


def _cdiv(a, b):
    return -(-a // b)


def test_encoder_plan_at_recipe():
    """The recipe's plan, written out: per-tap boxes, tiles, dW's splits on
    132 SMs, the scratch and the offsets."""
    plan = encoder_plan(16, 20480, 256, sms=132)
    assert plan.lengths == (4096, 1024, 512, 256, 128)
    assert (plan.tile_k, plan.col_tiles) == (4, 2)
    l2, l3, _l4, l5 = plan.layers
    assert l2.boxes == ((2, -1), (3, -1), (0, 0), (1, 0), (2, 0), (3, 0),
                        (0, 1), (1, 1))
    assert l3.boxes == l5.boxes == ((1, -1), (0, 0), (1, 0), (0, 1))
    assert l2.shifts == (1, 1, 0, 0) and l5.shifts == (1, 0)
    assert (l2.fwd.grid, l2.fwd.k_tiles) == ((256, 1), 32)
    assert (l2.dgrad.grid, l2.dgrad.k_tiles) == ((256, 4), 8)
    assert (l2.wgrad.grid, l2.wgrad.k_tiles, l2.wgrad.per_split) == (
        (32, 4), 256, 64)
    assert (l5.fwd.grid, l5.wgrad.grid, l5.wgrad.per_split) == (
        (32, 1), (16, 8), 4)
    assert (plan.w1_splits, plan.w1_rows) == (128, 512)
    assert plan.part_floats == 4 * 8 * 256 * 256
    assert plan.scratch_floats == 16 * 1024 * 256
    assert (l2.in_off, l2.pre_off, l2.w_off, l2.wt_off) == (
        0, 16 * 4096 * 256, 10 * 256, 0)


@pytest.mark.parametrize("n,t,c", PLAN_SHAPES)
def test_encoder_plan_mirrors_the_conv(n, t, c):
    """The plan against the conv it cuts up, computed here on its own: each
    tap's box reads input row s t - pad + j; every row of the lower layer's
    gradient is written by exactly one phase and row; the grids, dW's
    splits, the scratch and the offsets (16-byte aligned) as the kernels'
    tiles give them."""
    sms = 132
    plan = encoder_plan(n, t, c, sms)
    lengths = [t // 5, t // 20, t // 40, t // 80, t // 160]
    assert plan.lengths == tuple(lengths)
    tile_k, col_tiles = max(1, c // 64), _cdiv(c, 128)
    assert (plan.tile_k, plan.col_tiles) == (tile_k, col_tiles)
    acts = np.cumsum([0] + [n * x * c for x in lengths])
    w_off, wt_off, part = 10 * c, 0, 0
    for layer, lp in enumerate(plan.layers, start=1):
        k, s, p = CONV_STACK[layer]
        t_in, t_out = lengths[layer - 1], lengths[layer]
        assert (lp.t_in, lp.t_out, lp.taps, lp.stride, lp.pad) == (
            t_in, t_out, k, s, p)
        assert t_in == s * t_out
        for j, (ph, off) in enumerate(lp.boxes):
            assert 0 <= ph < s
            for row in range(t_out):
                assert s * (row + off) + ph == s * row - p + j
        written = np.zeros(t_in, int)
        for ph, shift in enumerate(lp.shifts):
            for a in range(shift, t_out + shift):
                u = s * a + ph - p
                assert 0 <= u < t_in
                written[u] += 1
                # its taps: ph + s of dy row a - 1 and ph of dy row a
                assert s * (a - 1) - p + ph + s == u == s * a - p + ph
        assert (written == 1).all()
        row_tiles = _cdiv(t_out, 128)
        assert lp.fwd.grid == (n * row_tiles * col_tiles, 1)
        assert lp.fwd.k_tiles == k * tile_k
        assert lp.dgrad.grid == (n * row_tiles * col_tiles, s)
        assert lp.dgrad.k_tiles == 2 * tile_k
        m_tiles = k * tile_k * 64 // 128
        assert k * tile_k * 64 % 128 == 0
        k_tiles = n * _cdiv(t_out, 64)
        splits, per = lp.wgrad.grid[1], lp.wgrad.per_split
        assert lp.wgrad.grid[0] == m_tiles * col_tiles
        assert lp.wgrad.k_tiles == k_tiles
        assert (splits - 1) * per < k_tiles <= splits * per
        assert splits <= max(1, sms // (m_tiles * col_tiles))
        part = max(part, splits * k * c * c)
        assert (lp.in_off, lp.pre_off, lp.w_off, lp.wt_off) == (
            acts[layer - 1], acts[layer], w_off, wt_off)
        assert not (2 * lp.in_off % 16 or 4 * lp.pre_off % 16
                    or 2 * lp.w_off % 16 or 2 * lp.wt_off % 16)
        w_off += k * c * c
        wt_off += s * 2 * c * c
    m1 = n * lengths[0]
    assert plan.w1_splits * plan.w1_rows >= m1 > (plan.w1_splits - 1) * (
        plan.w1_rows)
    assert plan.w1_rows % 16 == 0
    part = max(part, plan.w1_splits * 10 * c, _cdiv(m1, 64) * 3 * c)
    assert plan.part_floats == part
    assert plan.scratch_floats == n * lengths[1] * c


def test_encoder_plan_empty_batch():
    """N = 0: every grid is empty and no scratch is asked for."""
    plan = encoder_plan(0, 1120, 64)
    for lp in plan.layers:
        assert lp.fwd.grid[0] == lp.dgrad.grid[0] == 0
        assert lp.wgrad.grid[1] == lp.wgrad.k_tiles == 0
    assert plan.part_floats == plan.scratch_floats == 0


@pytest.mark.parametrize("t,c", [(160, 32), (1120, 64), (1120, 128),
                                 (160, 256), (1120, 256)])
def test_encoder_plan_refuses(t, c):
    """What the kernels do not take: T off 160, a width off CHANNELS."""
    with pytest.raises(ValueError):
        encoder_plan(2, t + 80, c)
    with pytest.raises(ValueError):
        encoder_plan(2, t, c + 16)


# --- the products emulated from the plan ------------------------------------

# Products against `F.conv1d` in float64: an error passes when it is at most
# ATOL + RTOL * max|reference| (fp32 sums in the tiles' order).
EMU_RTOL, EMU_ATOL = 1e-5, 1e-6


def _box(x, start, size):
    """x[start : start + size] in every dimension, zero outside x: TMA's
    fill."""
    out = x.new_zeros(size)
    src, dst = [], []
    for st, sz, dim in zip(start, size, x.shape):
        lo, hi = max(st, 0), min(st + sz, dim)
        if lo >= hi:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - st, hi - st))
    out[tuple(dst)] = x[tuple(src)]
    return out


def _emulate_fwd(plan, lp, h, wpack, c):
    """The forward product as the kernel cuts it: tile (sample, row tile,
    column tile), k tile (tap, 64 channels) = one box of the (C, s, T_out,
    N) view of h (N, T_in, C) against 64 rows of the weight pack."""
    n = h.shape[0]
    view = h.reshape(n, lp.t_out, lp.stride, c)
    w = wpack[lp.w_off:lp.w_off + lp.taps * c * c].reshape(-1, c)
    y = torch.full((n, lp.t_out, c), float("nan"))
    for x in range(lp.fwd.grid[0]):
        tile, col = divmod(x, plan.col_tiles)
        smp, rt = divmod(tile, lp.fwd.row_tiles)
        t0, n0 = rt * TILE, col * TILE
        acc = torch.zeros(TILE, TILE)
        for kt in range(lp.fwd.k_tiles):
            j, q = divmod(kt, plan.tile_k)
            ph, off = lp.boxes[j]
            a = _box(view, (smp, t0 + off, ph, q * BOX), (1, TILE, 1, BOX))
            acc += a.reshape(TILE, BOX) @ _box(w, (j * c + q * BOX, n0),
                                               (BOX, TILE))
        rows, cols = min(TILE, lp.t_out - t0), min(TILE, c - n0)
        y[smp, t0:t0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    return y


def _emulate_wgrad(plan, lp, h, dy, c):
    """dW as the kernel cuts it: tile ((tap, channel) rows at 64 tile_k
    channels a tap, column tile), split z of k tiles (sample, 64 rows),
    each the M-major boxes of two 64-row slices of the tile and dy's box;
    the splits' partials summed in order."""
    n = h.shape[0]
    view = h.reshape(n, lp.t_out, lp.stride, c)
    tap_rows = plan.tile_k * BOX
    (tiles, splits), per = lp.wgrad.grid, lp.wgrad.per_split
    part = torch.full((splits, lp.taps * c, c), float("nan"))
    for x in range(tiles):
        tile, col = divmod(x, plan.col_tiles)
        m0, n0 = tile * TILE, col * TILE
        for z in range(splits):
            acc = torch.zeros(TILE, TILE)
            for kt in range(z * per, min((z + 1) * per, lp.wgrad.k_tiles)):
                smp, r = divmod(kt, lp.wgrad.row_tiles)
                t0 = r * WGRAD_ROWS
                a = torch.cat([_box(view, (smp, t0 + lp.boxes[j][1],
                                           lp.boxes[j][0], mm - j * tap_rows),
                                    (1, WGRAD_ROWS, 1, 64)).reshape(64, 64).T
                               for mm in (m0, m0 + 64)
                               for j in [mm // tap_rows]])
                acc += a @ _box(dy, (smp, t0, n0),
                                (1, WGRAD_ROWS, TILE)).reshape(-1, TILE)
            cols = min(TILE, c - n0)
            for r in range(TILE):
                j, ci = divmod(m0 + r, tap_rows)
                if j < lp.taps and ci < c:
                    part[z, j * c + ci, n0:n0 + cols] = acc[r, :cols]
    out = part[0]
    for z in range(1, splits):
        out = out + part[z]
    return out


def _emulate_dgrad(plan, lp, dy, wtpack, c):
    """The lower layer's gradient as the kernel cuts it: per phase z, tile
    (sample, row tile, column tile) of dy rows a = t + shifts[z], k tile
    (tap, 64 channels) = dy's box at rows a - 1 + tap against that phase's
    block; row t stored at input row s (t + shift) + z - pad, and counted."""
    n = dy.shape[0]
    wt = wtpack[lp.wt_off:lp.wt_off + lp.stride * 2 * c * c].reshape(-1, c)
    dh = torch.full((n, lp.t_in, c), float("nan"))
    written = torch.zeros(n, lp.t_in, c, dtype=torch.int32)
    for x in range(lp.dgrad.grid[0]):
        tile, col = divmod(x, plan.col_tiles)
        smp, rt = divmod(tile, lp.dgrad.row_tiles)
        t0, n0 = rt * TILE, col * TILE
        for z, shift in enumerate(lp.shifts):
            acc = torch.zeros(TILE, TILE)
            for kt in range(lp.dgrad.k_tiles):
                j, q = divmod(kt, plan.tile_k)
                a = _box(dy, (smp, t0 + j - 1 + shift, q * BOX),
                         (1, TILE, BOX))
                acc += a.reshape(TILE, BOX) @ _box(
                    wt, (z * 2 * c + j * c + q * BOX, n0), (BOX, TILE))
            cols = min(TILE, c - n0)
            for r in range(min(TILE, lp.t_out - t0)):
                u = lp.stride * (t0 + r + shift) + z - lp.pad
                if 0 <= u < lp.t_in:
                    dh[smp, u, n0:n0 + cols] = acc[r, :cols]
                    written[smp, u, n0:n0 + cols] += 1
    assert (written == 1).all()
    return dh


def _bf16(rs, *shape, scale=1.0):
    return torch.from_numpy((scale * rs.randn(*shape)).astype(
        np.float32)).to(torch.bfloat16).float()


def _hold(name, got, want):
    err = (got.double() - want).abs().max().item()
    tol = EMU_ATOL + EMU_RTOL * want.abs().max().item()
    assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("t,c", [(160, 32), (1120, 32), (1120, 64),
                                 (1120, 128), (160, 256), (1120, 256)])
def test_encoder_products_emulated_from_plan(t, c):
    """Layers 2-5's three products, emulated in fp32 from the plan's
    per-tap boxes (zero outside the tensor) on bf16-valued operands packed
    by the wrapper's own packers, against the conv of `encoder_plain`
    (`F.conv1d`), its weight gradient and its input gradient in float64."""
    n = 2
    rs = np.random.RandomState(c + t)
    plan = encoder_plan(n, t, c)
    conv_w = [_bf16(rs, c, cin, k, scale=0.2)
              for (k, _s, _p), cin in zip(CONV_STACK, [1] + [c] * 4)]
    wpack = enc._pack_fwd(conv_w).float()
    wtpack = enc._pack_bwd(conv_w).float()
    for layer, lp in enumerate(plan.layers, start=1):
        _k, s, p = CONV_STACK[layer]
        h = _bf16(rs, n, lp.t_in, c)
        dy = _bf16(rs, n, lp.t_out, c)
        h64 = h.double().transpose(1, 2).requires_grad_(True)
        w64 = conv_w[layer].double().requires_grad_(True)
        y64 = F.conv1d(h64, w64, stride=s, padding=p)
        dh64, dw64 = torch.autograd.grad(y64, [h64, w64],
                                         dy.double().transpose(1, 2))
        what = f"layer {layer + 1}"
        _hold(what + " forward", _emulate_fwd(plan, lp, h, wpack, c),
              y64.detach().transpose(1, 2))
        _hold(what + " dW", _emulate_wgrad(plan, lp, h, dy, c),
              dw64.permute(2, 1, 0).reshape(-1, c))
        _hold(what + " dh", _emulate_dgrad(plan, lp, dy, wtpack, c),
              dh64.transpose(1, 2))
