"""The FFN's routes on the CPU (`cpc2_torch/ops/ffn.py`): `ffn_plain(...,
bf16=True)` against an explicit float64 computation with the bf16 kernels'
rounding points, against the fp32 route, and the module's choice of route
under each precision; then the fp32 kernels' plan (`ffn_fp32_plan`), their
decomposition emulated from that plan, and their 3xTF32 products.

The explicit computation takes inputs that are multiples of 1/8 in [-1, 1]:
they are bf16 values, and every sum of their products up to the hidden is
exact in fp32, so no value lies within fp32 reordering noise of a bf16
rounding boundary and the two sides round alike. Tolerances are then fp32
reordering: rtol 1e-5, atol 1e-6 for the forward and rtol 1e-4, atol 1e-6
for the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc2_tpu.ops.ffn_pallas import fused_ffn as jax_fused_ffn
from cpc2_torch.models import transformer
from cpc2_torch.ops.ffn import (ALIGN, K_TILE, PAD, SPLIT_ROWS, TILE,
                                FFNPlan, Product, ffn_fp32_plan, ffn_plain,
                                keep_mask)
from cpc2_torch.training import full_fp32, set_precision

torch.set_num_threads(1)

M, DIN, DFF, DOUT = 16, 8, 32, 8


@pytest.fixture
def tf32_flags():
    """Restore the library-precision switches that a test sets."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _eighths(rs, *shape):
    return (rs.randint(-8, 9, size=shape) / 8.0).astype(np.float32)


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).double().numpy()


def _explicit(x, w1, b1, w2, b2, g, keep, rate):
    """The bf16 kernels' arithmetic in float64: operands and the hidden
    rounded, the incoming gradient rounded for dW2 and dh, dh rounded for
    dW1 and dx, the bias gradients from the unrounded values."""
    x, w1, b1, w2, b2, g = (a.astype(np.float64) for a in (x, w1, b1, w2,
                                                           b2, g))
    xr, w1r, w2r, gr = _bf16(x), _bf16(w1), _bf16(w2), _bf16(g)
    pre = xr @ w1r.T + b1
    scale = np.where(keep, 1.0 / (1.0 - rate), 0.0)
    hr = _bf16(np.maximum(pre, 0.0) * scale)
    y = hr @ w2r.T + b2
    dh = (gr @ w2r) * scale * (pre > 0)
    dhr = _bf16(dh)
    return [y], [dhr @ w1r, dhr.T @ xr, dh.sum(0), gr.T @ hr, g.sum(0)]


def _plain_grads(arrays, g, seed, rate, bf16):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = ffn_plain(*leaves, seed, rate, bf16)
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_plain_bf16_matches_explicit_rounding(rate):
    """Forward and all five gradients of `ffn_plain(bf16=True)`."""
    rs = np.random.RandomState(4)
    arrays = [_eighths(rs, M, DIN), _eighths(rs, DFF, DIN),
              _eighths(rs, DFF), _eighths(rs, DOUT, DFF), _eighths(rs, DOUT)]
    g = _eighths(rs, M, DOUT)
    seed = torch.tensor([5], dtype=torch.int32)
    y, grads = _plain_grads(arrays, g, seed, rate, True)
    keep = keep_mask(seed, M, DFF, rate).numpy()
    (y_want,), grads_want = _explicit(*arrays, g, keep, rate)
    np.testing.assert_allclose(y, y_want, rtol=1e-5, atol=1e-6)
    for got, want, name in zip(grads, grads_want,
                               ["dx", "dw1", "db1", "dw2", "db2"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_ffn_plain_bf16_matches_pallas_at_the_tpus_default_precision(
        monkeypatch):
    """Under `bf16mix` the JAX package's FFN kernel takes its products at
    the TPU's default precision: each operand of every `dot_general` rounded
    to bf16 once, the sums in fp32. XLA on the CPU computes them in full
    fp32 whatever the precision asked, so here every `jax.lax.dot_general`
    rounds its operands first, and the kernel runs in interpret mode with
    dropout off (its mask is the TPU's own). On normal inputs the two sides
    then round the same values at the same points; their fp32 sums run in
    other orders, so the forward is held to rtol 1e-5, atol 1e-6 and the
    gradients to rtol 1e-4, atol 1e-5 (atol at 1e-5: the weight gradients
    sum 16 rows of products of order 1)."""
    real = jax.lax.dot_general

    def tpu_default(lhs, rhs, *args, **kwargs):
        return real(lhs.astype(jnp.bfloat16).astype(jnp.float32),
                    rhs.astype(jnp.bfloat16).astype(jnp.float32), *args,
                    **kwargs)
    monkeypatch.setattr(jax.lax, "dot_general", tpu_default)
    rs = np.random.RandomState(7)
    arrays = [rs.randn(M, DIN).astype(np.float32),
              (0.3 * rs.randn(DFF, DIN)).astype(np.float32),
              (0.3 * rs.randn(DFF)).astype(np.float32),
              (0.3 * rs.randn(DOUT, DFF)).astype(np.float32),
              (0.3 * rs.randn(DOUT)).astype(np.float32)]
    g = rs.randn(M, DOUT).astype(np.float32)
    y, grads = _plain_grads(arrays, g, torch.zeros(1, dtype=torch.int32),
                            0.0, True)
    seed = jnp.zeros((1, 1), jnp.int32)
    y_j, vjp = jax.vjp(lambda *a: jax_fused_ffn(*a, seed, 0.0, True),
                       *[jnp.asarray(a) for a in arrays])
    grads_j = vjp(jnp.asarray(g))
    np.testing.assert_allclose(y, np.asarray(y_j), rtol=1e-5, atol=1e-6)
    for got, want, name in zip(grads, grads_j,
                               ["dx", "dw1", "db1", "dw2", "db2"]):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_plain_bf16_is_within_bf16_of_fp32(rate):
    """On normal inputs the bf16 route stays within bf16 rounding (8
    significant bits, a relative step of 2**-8) of the fp32 route, in the
    2-norm of the difference over the fp32 route's: y, dW2 and db2 within
    1e-2. dx, dW1 and db1 pass through the ReLU's gradient, and a
    pre-activation within the operands' rounding (about 3e-3 of its spread)
    of 0 switches its element of dh on or off whole: about 0.2% of the
    hidden, which moves those gradients by 1-6% in the 2-norm at this size.
    They are held within 1e-1."""
    rs = np.random.RandomState(5)
    m, din, dff, dout = 64, 32, 128, 32
    arrays = [rs.randn(m, din).astype(np.float32),
              (rs.randn(dff, din) / np.sqrt(din)).astype(np.float32),
              (0.1 * rs.randn(dff)).astype(np.float32),
              (rs.randn(dout, dff) / np.sqrt(dff)).astype(np.float32),
              (0.1 * rs.randn(dout)).astype(np.float32)]
    g = rs.randn(m, dout).astype(np.float32)
    seed = torch.tensor([6], dtype=torch.int32)
    y16, grads16 = _plain_grads(arrays, g, seed, rate, True)
    y32, grads32 = _plain_grads(arrays, g, seed, rate, False)
    for got, want, name, tol in zip(
            [y16] + grads16, [y32] + grads32,
            ["y", "dx", "dw1", "db1", "dw2", "db2"],
            [1e-2, 1e-1, 1e-1, 1e-1, 1e-2, 1e-2]):
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < tol, (name, rel)
    # it does round: the output moved by more than fp32 reordering
    assert np.linalg.norm(y16 - y32) / np.linalg.norm(y32) > 1e-5


@pytest.mark.parametrize("precision,bf16", [("bf16mix", True),
                                            ("fp32", False),
                                            ("full_fp32", False)])
def test_ffnetwork_takes_the_route_of_the_precision(precision, bf16,
                                                    monkeypatch, tf32_flags):
    """`bf16mix` routes the module's FFN to bf16, `fp32` and the inside of
    `full_fp32()` (features, ABX) to fp32."""
    calls = []
    real = transformer.fused_ffn
    monkeypatch.setattr(transformer, "fused_ffn", lambda *a, bf16: (
        calls.append(bf16), real(*a, bf16=bf16))[1])
    module = transformer.FFNetwork(8, 8, 32, 0.0)
    x = torch.randn(2, 3, 8)
    if precision == "full_fp32":
        set_precision("bf16mix")
        with full_fp32():
            y = module(x)
        assert torch.backends.cuda.matmul.allow_tf32
    else:
        set_precision(precision)
        y = module(x)
    assert calls == [bf16]
    assert y.shape == (2, 3, 8)
    with torch.no_grad():
        want = ffn_plain(x.reshape(6, 8), module.lin1.weight,
                         module.lin1.bias, module.lin2.weight,
                         module.lin2.bias, torch.zeros(1, dtype=torch.int32),
                         0.0, bf16)
    torch.testing.assert_close(y.detach().reshape(6, 8), want, rtol=0,
                               atol=0)


# --- the fp32 route: plan, decomposition and 3xTF32 products ---------------

# The recipe (M = 8 x 116 rows, 256 -> 2048 -> 256) and `chip_smoke.py`'s
# ragged shapes: the small step's and one off the kernels' tiles.
RECIPE = (928, 256, 2048, 256)
FFN_EDGE_SHAPES = ((84, 64, 2048, 64), (200, 72, 136, 24))


def test_ffn_fp32_plan_at_the_recipe():
    """128 x 128 tiles: the hidden and dh products 8 x 16 tiles over 8 k
    tiles, unsplit; y and dx 16 tiles split 8 ways, dW2 and dW1 32 tiles
    split 4 ways over 29 k tiles, so that each product runs 128 blocks on
    the 132 multiprocessors. No row needs padding. The workspace: the
    planes, then the partials."""
    plan = ffn_fp32_plan(*RECIPE)
    assert plan[:4] == (928, 256, 2048, 256)
    assert plan.hidden == plan.dh == Product(8, 16, 8, 8, 1)
    assert plan.y == plan.dx == Product(8, 2, 64, 8, 8)
    assert plan.dw2 == Product(2, 16, 29, 8, 4)
    assert plan.dw1 == Product(16, 2, 29, 8, 4)
    mb = 2 ** 20
    # x, W1, W2, hidden planes; y's 8 partials
    assert plan.fwd_bytes == int((1.8125 + 4 + 4 + 14.5 + 7.25) * mb)
    # x, x^T, W1, W1^T, W2^T, g, g^T, hidden^T, dh planes; db2's 29 and
    # db1's 8 partial rows; the hidden's signs, 8 bytes a thread of 128
    # tiles; dW2's and dW1's 4 partials, dx's 8
    assert plan.bwd_bytes == int((4 * 1.8125 + 3 * 4 + 2 * 14.5
                                  + 29 * 1024 / mb + 8 * 8192 / mb
                                  + 128 * 256 * 8 / mb + 8 + 8 + 7.25) * mb)


def _walk_covers(p: Product, k: int) -> bool:
    """The splits' runs of k tiles cover K, each run at least one tile."""
    return (p.k_tiles == -(-k // K_TILE) and p.per >= 1 and p.splits >= 1
            and p.splits * p.per >= p.k_tiles
            and (p.k_tiles == 0 or (p.splits - 1) * p.per < p.k_tiles))


def _bytes(plan: FFNPlan, m: int, din: int, dff: int, dout: int):
    """The workspace from the kernels' regions, in C's order, each rounded
    up to ALIGN bytes."""
    def region(floats):
        return -(-4 * floats // ALIGN) * ALIGN

    def partials(p, n):
        return region(p.splits * n) if p.splits > 1 else 0
    ld = dict(m=plan.ld_m, din=plan.ld_din, dff=plan.ld_dff,
              dout=plan.ld_dout)
    fwd = [(m, "din"), (dff, "din"), (dout, "dff"), (m, "dff")]
    bwd = [(m, "din"), (din, "m"), (dff, "din"), (din, "dff"),
           (dff, "dout"), (m, "dout"), (dout, "m"), (dff, "m"), (m, "dff")]
    return (sum(region(2 * r * ld[w]) for r, w in fwd)
            + partials(plan.y, m * dout),
            sum(region(2 * r * ld[w]) for r, w in bwd)
            + region(-(-m // SPLIT_ROWS) * dout) + region(-(-m // TILE) * dff)
            + region(2 * 256 * -(-m // TILE) * -(-dff // TILE))
            + partials(plan.dw2, dout * dff) + partials(plan.dw1, dff * din)
            + partials(plan.dx, m * din))


@pytest.mark.parametrize("shape", [RECIPE, *FFN_EDGE_SHAPES,
                                   (37, 30, 75, 13),   # no width of 4s
                                   (1, 256, 2048, 256),
                                   (0, 256, 2048, 256)])
@pytest.mark.parametrize("sms", [132, 114, 7])
def test_ffn_fp32_plan_covers_every_shape(shape, sms):
    """At the ragged shapes, a width that is not a multiple of 4, one row
    and none: rows padded to PAD floats (TMA's 16-byte strides) and no
    more; every product's splits cover its K, the hidden and dh unsplit,
    the split ones at most one block a multiprocessor beyond their tiles;
    the workspace the sum of the kernels' regions."""
    m, din, dff, dout = shape
    plan = ffn_fp32_plan(m, din, dff, dout, sms)
    for ld, w in zip(plan[:4], shape):
        assert ld % PAD == 0 and w <= ld < w + PAD
    products = dict(hidden=(m, dff, din), y=(m, dout, dff),
                    dw2=(dout, dff, m), dh=(m, dff, dout), dw1=(dff, din, m),
                    dx=(m, din, dff))
    for name, (rows, cols, k) in products.items():
        p = getattr(plan, name)
        assert (p.m_tiles, p.n_tiles) == (-(-rows // TILE), -(-cols // TILE))
        assert _walk_covers(p, k), (name, p)
        tiles = p.m_tiles * p.n_tiles
        if name in ("hidden", "dh"):
            assert p.splits == 1
        else:
            assert tiles * p.splits <= max(sms, tiles)
    assert (plan.fwd_bytes, plan.bwd_bytes) == _bytes(plan, *shape)
    assert plan.fwd_bytes % ALIGN == plan.bwd_bytes % ALIGN == 0
    if m == 0:
        assert plan.hidden.m_tiles == plan.y.m_tiles == plan.dx.m_tiles == 0
        assert plan.dw2.k_tiles == plan.dw1.k_tiles == 0


def test_ffn_fp32_plan_raises_on_a_negative_width():
    with pytest.raises(ValueError):
        ffn_fp32_plan(4, -1, 8, 8)


def _truncated(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor as the tensor core reads it in TF32: the low 13
    bits cleared."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(t: torch.Tensor):
    """The kernels' TF32 planes of a float32 tensor (`csrc/hopper_gemm.cuh:
    tf32_split`): big = t rounded to TF32 by adding half an ulp and
    clearing the low 13 bits, small = t - big; and small as the tensor core
    reads it."""
    bits = t.contiguous().view(torch.int32)
    big = ((bits + 0x1000) & -0x2000).view(torch.float32)
    small = t - big
    return big, small, _truncated(small)


def _planes(t: torch.Tensor, ld: int) -> torch.Tensor:
    """A float32 matrix as the kernels lay out its planes: (2, rows, ld),
    big then small, each row padded to ld with NaN, which no read may
    reach."""
    big, small, _ = _split(t)
    out = torch.full((2, t.shape[0], ld), float("nan"))
    out[0, :, :t.shape[1]], out[1, :, :t.shape[1]] = big, small
    return out


def _gemm(a: torch.Tensor, b: torch.Tensor, k: int, p: Product):
    """C = A B^T from K-major planes as the kernel takes it: the TMA boxes
    read columns [0, k) (the tensor map's width), split z sums its run of
    k tiles, small_A big_B + big_A small_B + big_A big_B with small
    truncated, and the splits are summed in order; in float64 (each
    product of two TF32 values is exact in fp32, so only the order of the
    sums differs from the card's)."""
    a, b = a[:, :, :k].double(), b[:, :, :k].double()
    trunc = [_truncated(t[1].float()).double() for t in (a, b)]
    out = 0.0
    for z in range(p.splits):
        k0, k1 = z * p.per * K_TILE, min(k, (z + 1) * p.per * K_TILE)
        part = (trunc[0][:, k0:k1] @ b[0][:, k0:k1].T
                + a[0][:, k0:k1] @ trunc[1][:, k0:k1].T
                + a[0][:, k0:k1] @ b[0][:, k0:k1].T)
        out = out + part
    return out


def _tile_sums(v: torch.Tensor, rows: int) -> torch.Tensor:
    """Column sums of v per block of `rows` rows, the blocks summed in
    order."""
    out = torch.zeros(v.shape[1], dtype=v.dtype)
    for r0 in range(0, v.shape[0], rows):
        out = out + v[r0:r0 + rows].sum(0)
    return out


def _emulate_fp32_route(plan, x, w1, b1, w2, b2, g, keep, rate):
    """The fp32 kernels' decomposition (`csrc/ffn.cu:ffn_fwd_fp32`,
    `ffn_bwd_fp32`) from the plan: the split pass's planes, padded; the
    products from K-major planes; the epilogues (bias, ReLU, dropout to
    the hidden's planes; its gradient from the hidden's sign, to dh's
    planes both ways); db2 per 32 rows and db1 per 128-row tile; the
    partials summed in order."""
    m, din = x.shape
    dff, dout = w1.shape[0], w2.shape[0]
    scale = 1.0 / (1.0 - rate)

    def hidden_of(pre):
        v = torch.relu(pre.float() + b1)
        return torch.where(keep, v * scale, torch.zeros_like(v))
    # forward
    h = hidden_of(_gemm(_planes(x, plan.ld_din), _planes(w1, plan.ld_din),
                        din, plan.hidden))
    y = _gemm(_planes(h, plan.ld_dff), _planes(w2, plan.ld_dff), dff,
              plan.y) + b2.double()
    # backward: the hidden recomputed to (Dff, M) planes
    ht = _planes(hidden_of(_gemm(_planes(x, plan.ld_din),
                                 _planes(w1, plan.ld_din), din,
                                 plan.hidden)).T, plan.ld_m)
    gt = _planes(g.T, plan.ld_m)
    dw2 = _gemm(gt, ht, m, plan.dw2)
    acc = _gemm(_planes(g, plan.ld_dout), _planes(w2.T, plan.ld_dout), dout,
                plan.dh).float()
    mask = (ht[0, :, :m] + ht[1, :, :m]).T > 0
    dh = acc * torch.where(mask, scale, 0.0)
    dw1 = _gemm(_planes(dh.T, plan.ld_m), _planes(x.T, plan.ld_m), m,
                plan.dw1)
    dx = _gemm(_planes(dh, plan.ld_dff), _planes(w1.T, plan.ld_dff), dff,
               plan.dx)
    return y, [dx, dw1, _tile_sums(dh.double(), TILE), dw2,
               _tile_sums(g.double(), SPLIT_ROWS)]


@pytest.mark.parametrize("shape,sms", [((37, 30, 75, 13), 132),
                                       ((37, 30, 75, 13), 7),
                                       ((200, 72, 136, 24), 132),
                                       ((84, 64, 2048, 64), 132)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_fp32_route_emulated_from_its_plan(shape, sms, rate):
    """The fp32 kernels' decomposition (`_emulate_fp32_route`), with every
    plane's padding NaN, gives the unpadded plain result in float64, at
    widths that are not multiples of 4, several splits over K (sms = 7)
    and dropout: within 1e-6 of each tensor's largest value, the 3xTF32
    products' own error (2.5 * 2^-21 of each |a b|) summed."""
    m, din, dff, dout = shape
    rs = np.random.RandomState(11)
    arrays = [rs.randn(m, din), rs.randn(dff, din) / 8, rs.randn(dff) / 8,
              rs.randn(dout, dff) / 16, rs.randn(dout) / 16]
    g = rs.randn(m, dout)
    seed = torch.tensor([7], dtype=torch.int32)
    keep = keep_mask(seed, m, dff, rate)
    args = [torch.from_numpy(a.astype(np.float32)) for a in arrays + [g]]
    plan = ffn_fp32_plan(m, din, dff, dout, sms)
    y, grads = _emulate_fp32_route(plan, *args[:5], args[5], keep, rate)
    leaves = [a.double().requires_grad_(True) for a in args[:5]]
    want = ffn_plain(*leaves, seed, rate, False)
    want.backward(args[5].double())
    for name, got, ref in zip(["y", "dx", "dw1", "db1", "dw2", "db2"],
                              [y] + grads,
                              [want.detach()] + [t.grad for t in leaves]):
        assert torch.isfinite(got).all(), name
        err = (got - ref).abs().max().item()
        assert err <= 1e-6 * ref.abs().max().item(), (name, err)


def _recipe_operands():
    rs = np.random.RandomState(12)
    m, din, dff, dout = RECIPE
    x = rs.randn(m, din).astype(np.float32)
    w1 = (rs.randn(dff, din) / 16).astype(np.float32)
    w2 = (rs.randn(dout, dff) / 45).astype(np.float32)
    g = rs.randn(m, dout).astype(np.float32)
    keep = rs.rand(m, dff) >= 0.1
    h = (np.maximum(x @ w1.T, 0) * keep / 0.9).astype(np.float32)
    dh = ((g @ w2) * (h > 0) / 0.9).astype(np.float32)
    return dict(x=x, w1=w1, w2=w2, g=g, h=h, dh=dh)


# Each product as C = A B^T with both operands K-major, as the kernels take
# it, and its K at the recipe: the forward's hidden, then the backward's
# products that read an operand M- or N-major (g^T, hidden^T, W2^T, dh^T,
# x^T and W1^T, transposed by the split pass or an epilogue).
PRODUCTS = {"hidden": (lambda o: (o["x"], o["w1"]), 256),
            "dw2": (lambda o: (o["g"].T, o["h"].T), 928),
            "dh": (lambda o: (o["g"], o["w2"].T), 256),
            "dw1": (lambda o: (o["dh"].T, o["x"].T), 928),
            "dx": (lambda o: (o["dh"], o["w1"].T), 2048)}


@pytest.mark.parametrize("name", list(PRODUCTS))
def test_three_tf32_products_keep_fp32_accuracy_at_the_recipe(name):
    """The kernels' 3xTF32 products emulated in fp32, operands split as
    `tf32_split` splits them (after any transpose) and small truncated by
    the tensor core, each TF32 product exact in fp32: within 2e-6 of the
    largest value of the float64 product at K = 256, 928 and 2,048, as
    plain fp32 (about 3e-7 to 8e-7 here); one TF32 product alone errs by
    over 1e-4."""
    ops, k = PRODUCTS[name]
    a, b = (torch.from_numpy(np.ascontiguousarray(t))
            for t in ops(_recipe_operands()))
    assert a.shape[1] == b.shape[1] == k
    (ab, _, at), (bb, _, bt) = _split(a), _split(b)
    three = at @ bb.T + ab @ bt.T + ab @ bb.T
    exact = a.double() @ b.double().T
    scale = exact.abs().max().item()
    assert (three.double() - exact).abs().max().item() <= 2e-6 * scale
    one = ab @ bb.T
    assert (one.double() - exact).abs().max().item() > 1e-4 * scale
