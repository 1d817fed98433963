"""The port's relative-position attention (`cpc2_torch/ops/attention.py`)
against the JAX package's Pallas kernel, run in interpret mode on the CPU
as the JAX package's own tests run it, with the same inputs made from a
seed with numpy; its hash dropout mask; and the opt-in module path.

Tolerances are the ROADMAP's fp32 reordering: rtol 1e-5, atol 1e-6 for
forwards and rtol 1e-4, atol 1e-6 for gradients, tighter than the JAX
package's own for this kernel (`tests/test_attention_pallas.py:54-55,
76-77`: atol 2e-5 and 5e-4).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc2_tpu.ops.attention_pallas import \
    fused_relpos_attention as jax_fused_relpos_attention
from cpc2_torch.models.transformer import ScaledDotProductAttention
from cpc2_torch.ops import attention as att
from cpc2_torch.ops.attention import (attention_plain, fused_relpos_attention,
                                      use_fused_attention)
from cpc2_torch.ops.ffn import keep_mask

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _w2(krelpos, s):
    """`tests/test_attention_pallas.py:_w2`: the JAX side's (dk, S, S)
    table, gathered outside its kernel."""
    offs = jnp.clip(jnp.arange(s)[:, None] - jnp.arange(s)[None, :],
                    0, s - 1)
    return jnp.take(krelpos[:, ::-1], offs, axis=1)


def _inputs(seed, n, s, dk):
    rs = np.random.RandomState(seed)
    return [rs.randn(n, s, dk).astype(np.float32) for _ in range(3)] + [
        rs.randn(dk, s).astype(np.float32)]


def _jax_attention(q, k, v, krelpos):
    seed = jnp.zeros((1, 1), jnp.int32)
    return jax_fused_relpos_attention(q, k, v, _w2(krelpos, q.shape[1]),
                                      seed, 0.0, True)


ZERO_SEED = torch.zeros(1, dtype=torch.int32)


@pytest.mark.parametrize("n,s,dk", [(4, 12, 8), (6, 23, 4), (16, 116, 32)])
def test_attention_plain_matches_pallas(n, s, dk):
    arrays = _inputs(0, n, s, dk)
    got = fused_relpos_attention(*map(torch.from_numpy, arrays), ZERO_SEED)
    want = _jax_attention(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_attention_plain_grads_match_pallas():
    """dq, dk, dv and dKrelpos at (4, 17, 8), dropout off; the JAX side's
    dKrelpos flows through its W2 gather."""
    n, s, dk = 4, 17, 8
    arrays = _inputs(1, n, s, dk)
    cot = np.random.RandomState(2).randn(n, s, dk).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fused_relpos_attention(*leaves, ZERO_SEED)
    out.backward(torch.from_numpy(cot))
    out_j, vjp = jax.vjp(_jax_attention, *map(jnp.asarray, arrays))
    grads_j = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **FWD)
    for leaf, want, name in zip(leaves, grads_j,
                                ["dq", "dk", "dv", "dKrelpos"]):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   err_msg=name, **GRAD)


def test_attention_plain_is_the_reference_shift_trick():
    """The W2 formulation equals the module's zero-diagonal shift path."""
    n, s, dk = 3, 9, 4
    q, k, v, krel = map(torch.from_numpy, _inputs(3, n, s, dk))
    mod = ScaledDotProductAttention(s, dk, 0.0, relpos=True)
    with torch.no_grad():
        mod.Krelpos.copy_(krel)
    torch.testing.assert_close(attention_plain(q, k, v, krel, ZERO_SEED),
                               mod(q, k, v), **FWD)


def test_attention_mask_rate_and_forward_backward_agree():
    """At rate 0.1 the hash mask is deterministic, keeps about 0.9 of the
    probabilities, differs between seeds, and the backward uses the
    forward's mask: the gradients equal those of the same attention with
    that mask applied by hand."""
    n, s, dk, rate = 64, 116, 8, 0.1
    seed = torch.tensor([12345], dtype=torch.int32)
    keep = keep_mask(seed, n * s, s, rate).reshape(n, s, s)
    assert torch.equal(keep, keep_mask(seed, n * s, s, rate).reshape(n, s, s))
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    kept = keep[:, causal].float().mean().item()
    assert abs(kept - 0.9) < 0.005, kept
    other = keep_mask(torch.tensor([12346], dtype=torch.int32), n * s, s, rate)
    assert (other.reshape(n, s, s) != keep).float().mean().item() > 0.1

    arrays = _inputs(4, 4, 12, dk)
    cot = torch.from_numpy(
        np.random.RandomState(5).randn(4, 12, dk).astype(np.float32))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fused_relpos_attention(*leaves, seed, rate)
    out.backward(cot)
    again = fused_relpos_attention(*[a.detach() for a in leaves], seed, rate)
    assert torch.equal(out.detach(), again)

    q, k, v, krel = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    logits = (q @ k.transpose(1, 2)
              + torch.einsum("nrd,drc->nrc", q, att.relpos_table(krel)))
    logits = logits / math.sqrt(dk)
    mask = torch.ones(12, 12, dtype=torch.bool).tril()
    p = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=2)
    hand = keep_mask(seed, 4 * 12, 12, rate).reshape(4, 12, 12)
    ref = torch.where(hand, p / (1 - rate), torch.zeros_like(p)) @ v
    ref.backward(cot)
    torch.testing.assert_close(out.detach(), ref.detach(), **FWD)
    for leaf, want in zip(leaves, (q, k, v, krel)):
        torch.testing.assert_close(leaf.grad, want.grad, **GRAD)


def test_module_with_fused_attention_keeps_keys_and_output(monkeypatch):
    """With CPC2_FUSED_ATTENTION=1 the module has the same state-dict keys
    and, at rate 0, the same output and gradients as without it."""
    n, s, dk = 2, 11, 8
    torch.manual_seed(0)
    q, k, v = (torch.randn(n, 2 * s - 3, dk) for _ in range(3))
    mod = ScaledDotProductAttention(s, dk, 0.1, relpos=True).eval()
    monkeypatch.delenv("CPC2_FUSED_ATTENTION", raising=False)
    keys = set(mod.state_dict())
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = mod(*leaves)
    want.sum().backward()
    want_grads = [t.grad for t in leaves] + [mod.Krelpos.grad.clone()]
    mod.Krelpos.grad = None

    monkeypatch.setenv("CPC2_FUSED_ATTENTION", "1")
    assert use_fused_attention(s, dk)
    calls = []
    monkeypatch.setattr(att, "attention_plain",
                        lambda *a: calls.append(a[5]) or attention_plain(*a))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = mod(*leaves)
    got.sum().backward()
    assert calls == [0.0]
    assert set(mod.state_dict()) == keys
    torch.testing.assert_close(got, want, **FWD)
    for g, w in zip([t.grad for t in leaves] + [mod.Krelpos.grad],
                    want_grads):
        torch.testing.assert_close(g, w, **GRAD)


def test_gate_is_off_by_default_and_keeps_the_kernel_limits(monkeypatch):
    monkeypatch.delenv("CPC2_FUSED_ATTENTION", raising=False)
    assert not use_fused_attention(116, 32)
    monkeypatch.setenv("CPC2_FUSED_ATTENTION", "0")
    assert not use_fused_attention(116, 32)
    monkeypatch.setenv("CPC2_FUSED_ATTENTION", "1")
    assert use_fused_attention(116, 32)
    assert att.bwd_smem_bytes(116, 32) <= att.MAX_SMEM_BYTES
    assert not use_fused_attention(att.MAX_S + 1, 8)
    assert not use_fused_attention(116, 256)     # shared memory
    assert not use_fused_attention(200, 64)


# --- the kernels' plan and their tiled algorithm, emulated from the plan ----

# The recipe, ragged S, the gate's limit at dk = 32, dk = 4 and 128, N = 0;
# then widths that the wide kernels take in chunks of dk.
PLAN_SHAPES = [(64, 116, 32), (4, 1, 32), (4, 17, 8), (5, 37, 8),
               (3, 134, 32), (4, 64, 4), (2, 20, 128), (0, 116, 32),
               (3, 8, 256), (2, 43, 248), (1, 1, 1999), (2, 58, 177)]


@pytest.mark.parametrize("n,s,dk", PLAN_SHAPES)
def test_attention_plan_owns_every_row_once_and_fits(n, s, dk):
    """Every row tile is owned by exactly one warp slot of one CTA in both
    kernels; a CTA's causal work (column tiles of its row tiles) is within
    one tile pair (T + 1 column tiles) of every other CTA's; the shared
    memory fits a block, the regions lie in order and the backward's
    exchange fits over k, v and krel_t; the cluster's m-tile ranges cover
    every m-tile once; the chunks of dk cover dkp once, and a plan of
    several chunks has one CTA a unit, the narrowest instantiation and the
    staged Krelpos clear of the regions that live across chunks."""
    plan = att.attention_plan(n, s, dk)
    t = plan.tiles
    assert t == -(-s // 16) and plan.pairs == -(-t // 2)
    for ctas, warps in ((plan.fwd_ctas, plan.fwd_warps),
                        (plan.bwd_ctas, plan.bwd_warps)):
        owned = [att.own_tile(r, ctas, t, w) for r in range(ctas)
                 for w in range(warps)]
        assert sorted(x for x in owned if x >= 0) == list(range(t))
        work = [sum(x + 1 for x in (att.own_tile(r, ctas, t, w)
                                    for w in range(warps)) if x >= 0)
                for r in range(ctas)]
        assert max(work) - min(work) <= t + 1, work
        assert warps <= att.MAX_WARPS
    assert plan.fwd_smem <= 232448 and plan.bwd_smem <= 232448
    assert plan.bwd_ctas <= att.MAX_CLUSTER
    f = [plan.f_k, plan.f_v, plan.f_krel, plan.f_q, plan.f_x, plan.f_floats]
    b = [plan.b_k, plan.b_v, plan.b_krel, plan.b_q, plan.b_g, plan.b_pd,
         plan.b_ds, plan.b_dqp, plan.b_floats]
    assert f == sorted(f) and b == sorted(b)
    assert all(x % 32 == 0 for x in f + b + [plan.f_raw, plan.b_raw])
    staged = min(plan.dc, plan.dk_in) * s           # Krelpos, a chunk of it
    assert plan.f_floats - plan.f_raw >= staged
    assert plan.b_floats - plan.b_raw >= staged
    assert plan.exchange <= plan.b_q - plan.b_k
    assert plan.ld % 8 == 4 and plan.lds % 8 == 4 and plan.ldr % 32 == 0
    assert plan.dc % 8 == 0 and plan.ld == plan.dc + 4 <= att.MAX_BOX
    assert (plan.chunks - 1) * plan.dc < plan.dkp <= plan.chunks * plan.dc
    if plan.chunks == 1:  # Krelpos lands over the scratch, or the planes
        assert (plan.f_raw, plan.b_raw) == (plan.f_x, plan.b_pd)
    else:
        assert (plan.fwd_ctas, plan.bwd_ctas, plan.max_tiles) == (1, 1, 4)
        assert plan.f_raw >= plan.f_x + plan.fwd_warps * 16 * plan.lds
        assert plan.b_raw >= plan.b_dqp + plan.bwd_warps * 16 * plan.lds
    ranges = [_mtile_range(r, plan.bwd_ctas, t)
              for r in range(plan.bwd_ctas)]
    assert [m for lo, hi in ranges for m in range(lo, hi)] == list(range(t))
    assert max(hi - lo for lo, hi in ranges) <= plan.mtiles


def test_attention_plan_at_the_recipe():
    plan = att.attention_plan(64, 116, 32)
    assert (plan.tiles, plan.pairs, plan.fwd_ctas, plan.bwd_ctas) == (8, 4, 2, 2)
    assert (plan.fwd_warps, plan.bwd_warps, plan.max_tiles) == (4, 4, 8)
    assert (plan.ld, plan.ldr, plan.lds) == (36, 32, 132)
    assert (plan.dc, plan.chunks) == (32, 1)
    assert 160 * 1024 < plan.bwd_smem < 180 * 1024


def test_attention_plan_takes_every_gated_shape(monkeypatch):
    """Every (S, dk) that the gate's limits (`_within_limits`) take, at
    every dk they admit (up to 11,621 at S = 1), has a plan, so the gate
    sends no shape to the kernels that they refuse; so does N = 0. Widths
    past dk = 248, or past what a block holds at S up to 58, come in
    chunks."""
    monkeypatch.setenv("CPC2_FUSED_ATTENTION", "1")
    taken = chunked = 0
    for s in range(1, att.MAX_S + 1):
        dk = 1
        while att._within_limits(s, dk):
            assert use_fused_attention(s, dk)
            chunked += att.attention_plan(1, s, dk).chunks > 1  # or raises
            taken += 1
            dk += 1
    assert taken > 60000 and chunked > 39000
    assert att.attention_plan(1, 8, 248).chunks == 1
    assert att.attention_plan(1, 8, 249).chunks == 2
    assert att.attention_plan(0, 116, 32).n == 0


def test_attention_plan_for_bf16_takes_every_gated_shape():
    """The bf16 kernels' plans at every (S, dk) that the gate's limits take
    (dk up to 11,621 at S = 1): rows of dk_in = dk padded to 8, so a row's
    stride is a multiple of TMA's 16 bytes, and so is every box's row (dc
    bf16 values, at most MAX_BOX); staged (f_st, b_st), the staging region
    lies after Krelpos's raw copy and holds K, V and every warp slot's q
    (and g) rows, clear of the rows they are widened into and of the
    block's end; in place, each box lands at the end of the fp32 rows it
    fills (K and V: SP rows of ld floats, a warp slot of q or g: 16), half
    their bytes or less, on a 128-byte boundary, and the layout is the
    fp32 plan's but for dk_in and the raw copy of Krelpos (dk_in rows); it
    fits a block. The recipe's is staged in both kernels."""
    chunked = staged = 0
    for s in range(1, att.MAX_S + 1):
        dk = 1
        while att._within_limits(s, dk):
            plan = att.attention_plan(1, s, dk, bf16=True)
            fp32 = att.attention_plan(1, s, dk)
            assert plan.io == 1 and fp32.io == 0
            assert plan.dk_in == -(-dk // 8) * 8 and (2 * plan.dk_in) % 16 == 0
            assert (2 * plan.dc) % 16 == 0 and plan.dc <= att.MAX_BOX
            for rows in (16 * plan.tiles, 16):
                assert 2 * rows * plan.dc <= 2 * rows * plan.ld
                assert (4 * rows * plan.ld - 2 * rows * plan.dc) % 128 == 0
            assert plan.fwd_smem <= 232448 and plan.bwd_smem <= 232448
            sp = 16 * plan.tiles
            raw = (plan.dc if plan.chunks > 1 else plan.dk_in) * s
            for st, raw_at, warps, kinds, end, rows_end in (
                    (plan.f_st, plan.f_raw, plan.fwd_warps, 1,
                     plan.f_floats, plan.f_x),
                    (plan.b_st, plan.b_raw, plan.bwd_warps, 2,
                     plan.b_floats, plan.b_pd)):
                if st:
                    assert st % 32 == 0 and st >= raw_at + raw >= rows_end
                    assert (st + plan.dc * (2 * sp + 16 * kinds * warps) // 2
                            <= end)
            if dk % 8 == 0 and not plan.f_st and not plan.b_st:
                assert plan[:-3] == fp32[:-3]
            chunked += plan.chunks > 1
            staged += bool(plan.f_st and plan.b_st)
            dk += 1
    assert chunked > 39000 and staged > 30000
    recipe = att.attention_plan(64, 116, 32, bf16=True)
    assert recipe.f_st and recipe.b_st


def _widen_passes(rows, dc, ld):
    """The passes of `csrc/attention.cuh:widen` over a region of `rows` fp32
    rows at ld whose bf16 box (rows of dc values) landed at its end: each
    pass the rows [done, upto) whose fp32 writes end before the bf16 rows
    still unread begin; then the last row alone."""
    done, passes = 0, []
    while True:
        start = rows * (4 * ld - 2 * dc) + 2 * dc * done
        upto = min(start // (4 * ld), rows)
        if upto <= done:
            return passes + [(done, rows)]
        passes.append((done, upto))
        done = upto


@pytest.mark.parametrize("n,s,dk", PLAN_SHAPES)
def test_bf16_boxes_widen_in_place_without_overwriting(n, s, dk):
    """Replayed on the bytes of a region, the in-place widening reads every
    bf16 value before any fp32 write covers it: within a pass no write
    reaches the bf16 rows it or a later pass reads, the passes cover every
    row once, the last row (which covers its own bf16 row) goes alone
    through registers, and the rows come out as the fp32 boxes leave them,
    zeros in each row's last 4 floats."""
    plan = att.attention_plan(n, s, dk, bf16=True)
    for rows in (16 * plan.tiles, 16):
        dc, ld = plan.dc, plan.ld
        base = rows * (4 * ld - 2 * dc)    # byte of bf16 row 0
        passes = _widen_passes(rows, dc, ld)
        assert [r for a, b in passes for r in range(a, b)] == list(
            range(rows))
        assert passes[-1] == (rows - 1, rows)
        assert len(passes) <= 2 + int(np.log2(rows))
        for a, b in passes[:-1]:
            assert 4 * ld * b <= base + 2 * dc * a
        region = np.full(4 * ld * rows, 255, np.uint8)
        values = np.arange(rows * dc, dtype=np.float32).reshape(rows, dc)
        src = torch.from_numpy(values).to(torch.bfloat16).view(torch.int16)
        region[base:] = src.numpy().view(np.uint8).reshape(-1)
        for a, b in passes:
            read = region[base + 2 * dc * a:base + 2 * dc * b].copy()
            widened = torch.from_numpy(read.view(np.int16)).view(
                torch.bfloat16).float().reshape(b - a, dc)
            out = torch.zeros(b - a, ld)
            out[:, :dc] = widened
            region[4 * ld * a:4 * ld * b] = out.numpy().view(np.uint8).reshape(
                -1)
        got = region.view(np.float32).reshape(rows, ld)
        want = torch.zeros(rows, ld)
        want[:, :dc] = torch.from_numpy(values).to(torch.bfloat16).float()
        np.testing.assert_array_equal(got, want.numpy())


def _mtile_range(rank, ctas, tiles):
    """The m-tiles (16 columns of dk and dv, 16 rows of dKrelpos) that CTA
    `rank` of the backward's cluster finishes (`csrc/attention.cuh`: rank
    rho finishes [rho T / R, (rho + 1) T / R))."""
    return rank * tiles // ctas, (rank + 1) * tiles // ctas


_KORDER = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])  # k = t <-> 2t, t + 4 <-> 2t + 1


def _permuted(cols):
    """Column (or row) indices `cols` (a multiple of 8 long) in the order the
    kernels take them as the k index of a product from a C fragment."""
    return cols.reshape(-1, 8)[:, _KORDER].reshape(-1)


def _swz(j):
    return ((j & 3) << 3) | (j & 4)


def _widened(plan, x):
    """A bf16 (N, S, dk) operand's rows as the bf16 kernels stage them: the
    wrapper pads dk to dk_in with zeros; chunk c's TMA box (dc values from
    column c dc, zeros past S and past dk_in) lands as bf16 in the staging
    region and is widened to fp32 rows of ld = dc + 4 floats, zeros in the
    last 4; the chunks' columns side by side (dkp of them), NaN where no
    chunk writes."""
    n, s, dk = x.shape
    sp = 16 * plan.tiles
    src = torch.zeros(n, s, plan.dk_in, dtype=torch.bfloat16)
    src[..., :dk] = x
    out = torch.full((n, sp, plan.dkp), float("nan"))
    for c in range(plan.chunks):
        x0 = c * plan.dc
        box = torch.zeros(n, sp, plan.dc, dtype=torch.bfloat16)
        w = min(plan.dc, plan.dk_in - x0)
        box[:, :s, :w] = src[..., x0:x0 + w]
        rows = torch.zeros(n, sp, plan.ld)
        rows[..., :plan.dc] = box.float()
        cols = min(plan.dc, plan.dkp - x0)
        out[..., x0:x0 + cols] = rows[..., :cols]
    return out


def _emulate(plan, q, k, v, krel, seed, rate, g):
    """The kernels' tiled algorithm in torch, every index from `plan`: the
    forward's output and the backward's dq, dk, dv and dKrelpos. dk comes
    in the plan's chunks: each chunk's krel_t is staged and swizzled on its
    own, the products over dk add up chunk by chunk, and the outputs are
    written a chunk of columns at a time. Planes and outputs the kernels
    leave unwritten hold NaN here, so a read or a gap shows. A bf16 plan
    (`io`) takes bf16 q, k, v and g through their widened rows
    (`_widened`), rounds p~ to bf16 as p~ . v's operand only, and rounds
    out, dq, dk and dv to bf16 once."""
    n, s, dk, t = plan.n, plan.s, plan.dk, plan.tiles
    sp, dkp, lds = 16 * t, plan.dkp, plan.lds
    scale, ks = 1.0 / dk ** 0.5, 1.0 / (1.0 - rate)

    def pad(x):
        if plan.io:
            return _widened(plan, x)
        out = torch.zeros(n, sp, dkp)
        out[:, :s, :dk] = x
        return out
    Q, K, V, G = map(pad, (q, k, v, g))
    chunks = [(c * plan.dc, min(plan.dc, dkp - c * plan.dc))
              for c in range(plan.chunks)]
    j = torch.arange(s)
    krel_t = []                     # each chunk's staged, swizzled krel_t
    for x0, cols in chunks:
        rows = min(cols, plan.dk_in - x0)
        kt = torch.zeros(sp, plan.ldr)
        d = torch.arange(rows)
        kt[j[:, None], d[None, :] ^ _swz(j)[:, None]] = torch.cat(
            [krel.T, torch.zeros(s, plan.dk_in - dk)], 1)[:, x0 + d]
        krel_t.append(kt)

    def krow(c, rows):  # chunk c's krel_t rows, columns unswizzled
        cols = torch.arange(chunks[c][1])
        return krel_t[c][rows[:, None], cols[None, :] ^ _swz(rows)[:, None]]

    def over_dk(x, y):  # x[..., :dkp] . y[..., :dkp]^T, chunk by chunk
        total = 0
        for c, (x0, cols) in enumerate(chunks):
            total = total + x(c, x0, cols) @ y(c, x0, cols).transpose(-1, -2)
        return total
    keep = (keep_mask(seed, n * s, s, rate).reshape(n, s, s) if rate > 0
            else torch.ones(n, s, s, dtype=torch.bool))

    def probs(tile):
        r0 = 16 * tile
        ncol = min(2 * (tile + 1), -(-s // 8))
        jlo = max(0, s - 16 - r0) // 8
        njt = -(-s // 8) - jlo
        qt = Q[:, r0:r0 + 16]
        qp = torch.full((n, 16, lds), float("nan"))
        cols = torch.arange(8 * jlo, 8 * (jlo + njt))
        qp[:, :, cols] = over_dk(lambda c, x0, w: qt[..., x0:x0 + w],
                                 lambda c, x0, w: krow(c, cols))
        r = r0 + torch.arange(16)[:, None]
        c = torch.arange(8 * ncol)[None, :]
        valid = (c <= r) & (r < s)
        rel = qp.gather(2, (s - 1 - r + c).clamp(0, lds - 1).expand(n, -1, -1))
        qk = over_dk(lambda _, x0, w: qt[..., x0:x0 + w],
                     lambda _, x0, w: K[:, :8 * ncol, x0:x0 + w])
        logits = torch.where(valid, (qk + rel) * scale, float("-inf"))
        m = logits.amax(2, keepdim=True)
        m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        e = torch.where(valid, torch.exp(logits - m), torch.zeros_like(m))
        tot = e.sum(2, keepdim=True)
        p = e * torch.where(tot > 0, 1 / tot, torch.zeros_like(tot))
        kp = keep[:, r.clamp(max=s - 1), c.clamp(max=s - 1)]
        return r0, ncol, jlo, njt, p, kp, valid

    def put(out, r0, rows, x0, cols, val):  # a chunk of an output's columns
        hi = min(x0 + cols, dk)
        if hi > x0:
            out[:, r0:r0 + rows, x0:hi] = val[:, :rows, :hi - x0]

    out = torch.full((n, s, dk), float("nan"))
    for rank in range(plan.fwd_ctas):
        for w in range(plan.fwd_warps):
            tile = att.own_tile(rank, plan.fwd_ctas, t, w)
            if tile < 0:
                continue
            r0, ncol, _, _, p, kp, _ = probs(tile)
            order = _permuted(torch.arange(8 * ncol))
            pt = torch.where(kp, p * ks, torch.zeros_like(p))
            if plan.io:
                pt = pt.to(torch.bfloat16).float()
            for x0, cols in chunks:
                put(out, r0, min(16, s - r0), x0, cols,
                    pt[:, :, order] @ V[:, order, x0:x0 + cols])

    # backward: a cluster of bwd_ctas CTAs a unit
    rb, wb = plan.bwd_ctas, plan.bwd_warps
    dq = torch.full((n, s, dk), float("nan"))
    parts = {}
    for rank in range(rb):
        pd = torch.full((n, 16 * wb, lds), float("nan"))
        ds = torch.full((n, 16 * wb, lds), float("nan"))
        dqp = torch.full((n, 16 * wb, lds), float("nan"))
        sq = torch.full((n, 16 * wb, dkp), float("nan"))  # the CTA's rows
        sg = torch.full((n, 16 * wb, dkp), float("nan"))
        for w in range(wb):
            tile = att.own_tile(rank, rb, t, w)
            if tile < 0:
                continue
            r0, ncol, jlo, njt, p, kp, valid = probs(tile)
            sq[:, 16 * w:16 * w + 16] = Q[:, r0:r0 + 16]
            sg[:, 16 * w:16 * w + 16] = G[:, r0:r0 + 16]
            dp = over_dk(lambda _, x0, w: G[:, r0:r0 + 16, x0:x0 + w],
                         lambda _, x0, w: V[:, :8 * ncol, x0:x0 + w])
            dp = torch.where(kp, dp * ks, torch.zeros_like(dp))
            d_r = (dp * p).sum(2, keepdim=True)
            dsc = p * (dp - d_r) * scale
            loc = slice(16 * w, 16 * w + 16)
            pd[:, loc, :8 * ncol] = torch.where(kp, p * ks, torch.zeros_like(p))
            ds[:, loc, :8 * ncol] = dsc
            skew = torch.zeros(n, 16, lds)
            rr, cc = valid.nonzero(as_tuple=True)
            skew[:, rr, s - 1 - (r0 + rr) + cc] = dsc[:, rr, cc]
            dqp[:, loc] = skew
            order = _permuted(torch.arange(8 * ncol))
            cols = torch.arange(8 * jlo, 8 * (jlo + njt))
            for c, (x0, width) in enumerate(chunks):
                put(dq, r0, min(16, s - r0), x0, width,
                    dsc[:, :, order] @ K[:, order, x0:x0 + width]
                    + skew[:, :, cols] @ krow(c, cols))
        for m in range(t):
            for x, (plane, src) in enumerate(((ds, sq), (pd, sg), (dqp, sq))):
                acc = torch.zeros(n, 16, dkp)
                first = 16 * m if x < 2 else s - 16 - 16 * m
                for w in range(wb):
                    tile = att.own_tile(rank, rb, t, w)
                    if tile < 0:
                        continue
                    for h in range(2):
                        b0 = 16 * tile + 8 * h
                        if b0 + 7 < first or b0 >= s:
                            continue
                        lr = 16 * w + 8 * h + _KORDER
                        blk = plane[:, lr, 16 * m:16 * m + 16]
                        for x0, width in chunks:
                            acc[..., x0:x0 + width] += (
                                blk.transpose(1, 2)
                                @ src[:, lr, x0:x0 + width])
                parts[rank, m, x] = acc
    # the exchange: each rank's partials of another's m-tiles into that
    # rank's slots, then the owner's sum in rank order
    frag = (dkp // 8) * 128
    exch = [[None] * (plan.exchange // frag) for _ in range(rb)]
    for rank in range(rb):
        for m in range(t):
            owner = next(o for o in range(rb)
                         if _mtile_range(o, rb, t)[0] <= m
                         < _mtile_range(o, rb, t)[1])
            if owner == rank:
                continue
            src = rank if rank < owner else rank - 1
            for x in range(3):
                slot = (src * plan.mtiles + m
                        - _mtile_range(owner, rb, t)[0]) * 3 + x
                assert exch[owner][slot] is None
                exch[owner][slot] = parts[rank, m, x]
    grads = [torch.full((n, sp, dkp), float("nan")) for _ in range(3)]
    for owner in range(rb):
        lo, hi = _mtile_range(owner, rb, t)
        for m in range(lo, hi):
            for x in range(3):
                total = None
                for r in range(rb):
                    part = (parts[owner, m, x] if r == owner else exch[owner][
                        ((r if r < owner else r - 1) * plan.mtiles + m - lo)
                        * 3 + x])
                    total = part if total is None else total + part
                grads[x][:, 16 * m:16 * m + 16] = total
    dk_, dv, partial = (x[:, :s, :dk] for x in grads)
    dkrel = partial[0].T.clone()
    for u in range(1, n):
        dkrel = dkrel + partial[u].T
    if plan.io:
        out, dq, dk_, dv = (x.to(torch.bfloat16) for x in (out, dq, dk_, dv))
    return out, dq, dk_, dv, dkrel


EMULATED_SHAPES = [(8, 116, 32), (5, 37, 8), (3, 134, 32), (2, 1, 32),
                   (4, 64, 4), (3, 17, 6), (2, 60, 128), (3, 8, 256),
                   (2, 43, 248), (1, 1, 1999), (2, 58, 177)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n,s,dk", EMULATED_SHAPES)
def test_tiled_emulation_matches_plain(n, s, dk, rate):
    """The kernels' algorithm, emulated from the plan alone (tiles, the skew
    S-1-r+c into QP and dQP, krel_t's swizzle, the k order that lets a C
    fragment serve as an A fragment, skipped blocks, per-CTA partials, the
    exchange's slots and the rank-order sum, dKrelpos summed over units in
    order, and the chunks of dk of the wide kernels), against
    `attention_plain` and its autograd gradients: rtol 1e-5 forward, 1e-4
    on gradients, atol 1e-6."""
    rs = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rs.randn(n, s, dk).astype(np.float32))
               for _ in range(3))
    krel = torch.from_numpy(0.3 * rs.randn(dk, s).astype(np.float32))
    g = torch.from_numpy(rs.randn(n, s, dk).astype(np.float32))
    seed = torch.tensor([321], dtype=torch.int32)
    plan = att.attention_plan(n, s, dk)
    got = _emulate(plan, q, k, v, krel, seed, rate, g)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, krel)]
    want = attention_plain(*leaves, seed, rate)
    want.backward(g)
    torch.testing.assert_close(got[0], want.detach(), **FWD)
    for name, a, b in zip(("dq", "dk", "dv", "dKrelpos"), got[1:], leaves):
        torch.testing.assert_close(a, b.grad, msg=name, **GRAD)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n,s,dk", EMULATED_SHAPES)
def test_tiled_emulation_matches_plain_on_bf16(n, s, dk, rate):
    """The bf16 kernels' algorithm, emulated from their plan (rows of dk
    padded to 8, each chunk's boxes widened from bf16 to the fp32 rows,
    p~ rounded for p~ . v only, out, dq, dk and dv rounded once) against
    `attention_plain` on the same bf16 tensors and its autograd gradients
    (bf16 for q, k and v, rounded once from fp32; fp32 for dKrelpos). The
    two take their fp32 sums in other orders, so a value that lies within
    that of a bf16 rounding boundary (p~, or an output) may round one step
    apart: each bf16 tensor within 1e-3 of its 2-norm and no element more
    than 2 bf16 steps of its largest value away; dKrelpos, whose terms a
    flipped p~ moves by about 2^-9, within 1e-4 of its 2-norm."""
    rs = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rs.randn(n, s, dk).astype(np.float32)).to(
        torch.bfloat16) for _ in range(3))
    krel = torch.from_numpy(0.3 * rs.randn(dk, s).astype(np.float32))
    g = torch.from_numpy(rs.randn(n, s, dk).astype(np.float32)).to(
        torch.bfloat16)
    seed = torch.tensor([321], dtype=torch.int32)
    plan = att.attention_plan(n, s, dk, bf16=True)
    got = _emulate(plan, q, k, v, krel, seed, rate, g)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, krel)]
    want = attention_plain(*leaves, seed, rate)
    want.backward(g)
    for name, a, b in zip(("out", "dq", "dk", "dv", "dKrelpos"), got,
                          [want.detach()] + [x.grad for x in leaves]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        a, b = a.double(), b.double()
        rel = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
        if name == "dKrelpos":
            assert rel <= 1e-4, (name, rel)
            continue
        top = b.abs().max().item()
        step = 2.0 ** (np.floor(np.log2(top)) - 7) if top else 0.0
        assert (a - b).abs().max().item() <= 2 * step, name
        assert rel <= 1e-3, (name, rel)


@pytest.mark.parametrize("n,s,dk", [x for x in PLAN_SHAPES if x[0]])
def test_fragment_loads_hit_32_banks(n, s, dk):
    """The kernels' fragment loads from shared memory, at the plan's
    strides, each touch 32 distinct banks (no conflicts): the row-major
    tiles at ld and the S-wide planes at lds read as [g][t] (rows g,
    columns t) and as [2t][g] (rows 2t and 2t + 1, the permuted k order);
    krel_t, XOR-swizzled, read as [g][t] for QP and as [t][g] for dq's
    relative part."""
    plan = att.attention_plan(n, s, dk)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4

    def distinct(addr):
        return len(set((addr % 32).tolist())) == 32
    for stride in (plan.ld, plan.lds):
        for k0 in range(0, 32, 8):
            assert distinct(g * stride + k0 + t)          # [g][t]
            assert distinct(2 * t * stride + k0 + g)      # [2t][g]
            assert distinct((2 * t + 1) * stride + k0 + g)
    for j0 in range(0, 16 * plan.tiles, 8):
        for k0 in range(0, plan.dc, 8):
            for dt in (0, 4):
                rows = j0 + g                                  # QP: [g][t]
                assert distinct(rows * plan.ldr + ((k0 + t + dt) ^ _swz(rows)))
                rows = j0 + t + dt                             # dq: [t][g]
                assert distinct(rows * plan.ldr + ((k0 + g) ^ _swz(rows)))
