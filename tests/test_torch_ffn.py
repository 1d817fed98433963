"""The FFN's routes on the CPU (`cpc2_torch/ops/ffn.py`): `ffn_plain(...,
bf16=True)` against an explicit float64 computation with the bf16 kernels'
rounding points, against the fp32 route, and the module's choice of route
under each precision; then the fp32 kernels' plan (`ffn_fp32_plan`), their
decomposition emulated from that plan, and their 3xTF32 products; then the
bf16-io kernels' plan (`ffn_bf16io_plan`) and their decomposition emulated
from it.

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
from cpc2_torch.ops.ffn import (ALIGN, H100_CLUSTER_FITS, IO_CLUSTERS,
                                IO_K_TILE, IO_SUM_ROWS, IO_TILE, K_TILE, PAD,
                                SPLIT_ROWS, TILE,
                                FFNPlan, IoProduct, Product, ffn_bf16io_plan,
                                ffn_fp32_plan, ffn_plain, keep_mask)
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


# --- the bf16-io route: plan and decomposition --------------------------------

# The recipe, the small step's shape, the multi-head trunk's 3,072 columns
# and widths that are no multiples of 64 or 128.
IO_SHAPES = (RECIPE, (84, 64, 2048, 64), (928, 256, 2048, 3072),
             (200, 72, 136, 24), (37, 8, 24, 16))
SMEM_LIMIT = 232448


def _io_launches(plan):
    """The split launches' products, as `csrc/ffn.cu` groups them: y; dW2
    and dW1; dx."""
    return [[plan.y], [plan.dw2, plan.dw1], [plan.dx]]


def _io_ctas(products):
    """Each CTA of one `ffn_io_split` launch as the kernel maps it
    (`hopper_gemm.cuh:ffn_io_split`): (product, m tile, n tile, rank, its
    k tiles [k0, k1), the tile's rows it sums over the cluster)."""
    r = products[0].cluster
    firsts = [0]
    for p in products:
        firsts.append(firsts[-1] + p.m_tiles * p.n_tiles)
    out = []
    for b in range(firsts[-1] * r):
        cid, rank = divmod(b, r)
        pi = 1 if len(products) > 1 and cid >= firsts[1] else 0
        p = products[pi]
        tile = cid - firsts[pi]
        k0, k1 = p.k_runs()[rank]
        rows = IO_TILE // r
        out.append((pi, tile // p.n_tiles, tile % p.n_tiles, rank, k0, k1,
                    range(rank * rows, rank * rows + rows)))
    return out


@pytest.mark.parametrize("shape", IO_SHAPES)
@pytest.mark.parametrize("fits", [H100_CLUSTER_FITS, (7, 3, 1), (0, 0, 0)])
def test_ffn_bf16io_plan_owns_every_tile_and_k_tile_once(shape, fits):
    """Every output tile of each product is owned by one cluster, whose
    ranks take each k tile once (none empty) and sum each of the tile's
    rows once; a cluster has 1, 2, 4 or 8 CTAs, and a split launch of
    clusters holds no more of them than the card holds at once (`fits`:
    one wave); the hidden and dh are not split;
    shared memory within a block's 232,448 bytes; the workspace holds the
    bf16 hidden and dh and the bias
    gradients' partials, region by region, and no fp32 partial of y, dx,
    dW1 or dW2 (the bf16 weights, W1 then W2, are the forward's, kept for
    the backward)."""
    m, din, dff, dout = shape
    plan = ffn_bf16io_plan(m, din, dff, dout, fits)
    widths = dict(hidden=(m, dff, din), dh=(m, dff, dout), y=(m, dout, dff),
                  dw2=(dout, dff, m), dw1=(dff, din, m), dx=(m, din, dff))
    for name, (rows, cols, k) in widths.items():
        p = getattr(plan, name)
        assert (p.m_tiles, p.n_tiles, p.k_tiles) == (
            -(-rows // IO_TILE), -(-cols // IO_TILE), -(-k // IO_K_TILE))
        assert p.cluster in (1, *IO_CLUSTERS) and p.cluster <= p.k_tiles
    assert plan.hidden.cluster == plan.dh.cluster == 1
    assert plan.dw2.cluster == plan.dw1.cluster
    for products in _io_launches(plan):
        ctas = _io_ctas(products)
        r = products[0].cluster
        assert r == 1 or len(ctas) // r <= fits[IO_CLUSTERS.index(r)]
        for pi, p in enumerate(products):
            for mt in range(p.m_tiles):
                for nt in range(p.n_tiles):
                    mine = [c for c in ctas if c[:3] == (pi, mt, nt)]
                    assert sorted(c[3] for c in mine) == list(range(r))
                    k_tiles = [t for c in mine for t in range(c[4], c[5])]
                    assert sorted(k_tiles) == list(range(p.k_tiles))
                    assert all(c[5] > c[4] for c in mine)
                    rows = sorted(i for c in mine for i in c[6])
                    assert rows == list(range(IO_TILE))
    assert plan.smem <= SMEM_LIMIT
    assert plan.weights == dff * din + dout * dff

    def region(n, size):
        return -(-n * size // ALIGN) * ALIGN
    fwd = region(m * dff, 2)
    assert plan.fwd_bytes == fwd
    assert plan.bwd_bytes == (fwd + region(m * dff, 2)
                              + region(plan.hidden.m_tiles * dff, 4)
                              + region(IO_TILE // IO_SUM_ROWS
                                       * plan.hidden.m_tiles * dout, 4))


def test_ffn_bf16io_plan_at_the_recipe():
    """At the recipe on an H100 (66, 30 and 15 clusters of 2, 4 and 8 at
    once): y and dx 16 tiles in clusters of 4 (8 of their 32 k tiles a
    rank, 64 CTAs: 16 clusters of 8 would take two waves), dW2 and dW1 64
    tiles in clusters of 2 (7 and 8 of their 15 k tiles, 128 CTAs); the
    hidden and dh 8 x 16 tiles of 4 k tiles. The C layout's fields, as the
    entry points read them."""
    plan = ffn_bf16io_plan(*RECIPE)
    assert plan.hidden == plan.dh == IoProduct(8, 16, 4, 1)
    assert plan.y == plan.dx == IoProduct(8, 2, 32, 4)
    assert plan.dw2 == IoProduct(2, 16, 15, 2)
    assert plan.dw1 == IoProduct(16, 2, 15, 2)
    assert plan.y.k_runs() == [(8 * r, 8 * r + 8) for r in range(4)]
    assert plan.dw2.k_runs() == [(0, 7), (7, 15)]
    assert list(plan.as_c_longs()) == [928, 256, 2048, 256, 66, 30, 15, 4, 2,
                                       4, 171072, plan.fwd_bytes,
                                       plan.bwd_bytes]
    assert plan.fwd_bytes == 928 * 2048 * 2


def test_ffn_bf16io_plan_refuses_what_the_kernels_do_not_take():
    for shape in ((0, 256, 2048, 256), (8, 12, 16, 16), (8, 16, 16, 4)):
        with pytest.raises(ValueError):
            ffn_bf16io_plan(*shape)
    for fits in ((66, 30), (66, -1, 15)):
        with pytest.raises(ValueError):
            ffn_bf16io_plan(*RECIPE, fits)


def _round(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to bf16 (to nearest even), as float32."""
    return t.to(torch.bfloat16).float()


def _io_product(a: torch.Tensor, b: torch.Tensor, p: IoProduct, k: int):
    """C = A B^T (float32 tensors holding bf16 values) as an `ffn_io_split`
    cluster takes it: each rank sums its run of k tiles of 64, a tile at a
    time in fp32 (a tile's products exact, summed in float64), then the
    ranks' partials are added in rank order in fp32."""
    out = None
    for k0, k1 in p.k_runs():
        part = torch.zeros(a.shape[0], b.shape[0])
        for t in range(k0, k1):
            cols = slice(IO_K_TILE * t, min(IO_K_TILE * (t + 1), k))
            part = part + (a[:, cols].double() @ b[:, cols].double().T).float()
        out = part if out is None else out + part
    return out


def _row_block_sums(v: torch.Tensor, rows: int) -> torch.Tensor:
    """Column sums of v per block of `rows` rows, in fp32, the blocks added
    in order."""
    out = torch.zeros(v.shape[1])
    for r0 in range(0, v.shape[0], rows):
        out = out + v[r0:r0 + rows].sum(0)
    return out


def _emulate_bf16io_route(plan, x, w1, b1, w2, b2, g, keep, rate):
    """The bf16-io kernels' decomposition (`csrc/ffn.cu:ffn_fwd_io`,
    `ffn_bwd_io`) from the plan, on a bf16 x and g held in float32: the
    weights rounded to bf16 by the cast launch; the hidden by 128 x 128
    tiles (bias, ReLU, dropout in fp32, rounded to bf16; its signs kept
    unrounded); y split over its cluster, summed in rank order with b2
    and rounded once; dh from the same tiles (g W2 scaled by the signs,
    rounded to bf16; db1's column sums of the unrounded dh per 128-row
    tile, the tiles added in order); db2 from g's sums per 32 rows, added
    in order; dW2 = g^T h and dW1 = dh^T x, and dx = dh W1 rounded once,
    each split over its cluster as the plan says. The backward reads the
    forward's bf16 weights."""
    m, din = x.shape
    dff, dout = w1.shape[0], w2.shape[0]
    w1b, w2b = _round(w1), _round(w2)
    scale = 1.0 / (1.0 - rate)
    pre = _io_product(x, w1b, plan.hidden, din) + b1
    v = torch.where(keep, torch.relu(pre) * scale, torch.zeros_like(pre))
    h = _round(v)
    y = _round(_io_product(h, w2b, plan.y, dff) + b2)
    dh = _io_product(g, w2b.T, plan.dh, dout) * torch.where(v > 0, scale,
                                                             0.0)
    dhb = _round(dh)
    db1 = _row_block_sums(dh, IO_TILE)
    db2 = _row_block_sums(g, IO_SUM_ROWS)
    dw2 = _io_product(g.T, h.T, plan.dw2, m)
    dw1 = _io_product(dhb.T, x.T, plan.dw1, m)
    dx = _round(_io_product(dhb, w1b.T, plan.dx, dff))
    return y, [dx, dw1, db1, dw2, db2]


def _io_inputs(shape, seed=13):
    m, din, dff, dout = shape
    rs = np.random.RandomState(seed)
    arrays = [rs.randn(m, din), rs.randn(dff, din) / 16, rs.randn(dff) / 16,
              rs.randn(dout, dff) / 45, rs.randn(dout) / 45, rs.randn(m, dout)]
    t = [torch.from_numpy(a.astype(np.float32)) for a in arrays]
    t[0], t[5] = _round(t[0]), _round(t[5])  # x and g are bf16
    return t


@pytest.mark.parametrize("shape,fits", [((200, 72, 136, 24), H100_CLUSTER_FITS),
                                        ((84, 64, 2048, 64), H100_CLUSTER_FITS),
                                        ((200, 72, 136, 24), (0, 0, 0)),
                                        ((37, 8, 24, 16), H100_CLUSTER_FITS)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_bf16io_route_emulated_from_its_plan(shape, fits, rate):
    """The bf16-io kernels' decomposition (`_emulate_bf16io_route`) against
    `ffn_plain` on the same bf16 x and g, with clusters of 2, 4 and 8
    (uneven runs of k tiles included) and unsplit ones (no cluster fits). The
    plain version computes its sums in float64 here, with the same
    rounding points (the output and dx rounded to bf16), so the two differ
    by the kernels' fp32 sums and by the bf16 values that those move
    across a rounding boundary: y and dx (bf16) within 2e-3 of their
    2-norm, and no element more than 2 bf16 steps of the largest value
    away; the fp32 gradients within 1e-5 of their 2-norm (the fp32 sums
    leave about 1e-7 here, and a flip in a stored hidden or dh value moves
    them by about 2^-9 of one of their terms: 2e-7 at (84, 64, 2048,
    64))."""
    m, din, dff, dout = shape
    x, w1, b1, w2, b2, g = _io_inputs(shape)
    seed = torch.tensor([3], dtype=torch.int32)
    keep = keep_mask(seed, m, dff, rate)
    plan = ffn_bf16io_plan(m, din, dff, dout, fits)
    y, grads = _emulate_bf16io_route(plan, x, w1, b1, w2, b2, g, keep, rate)
    leaves = [t.double().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    want = ffn_plain(*leaves, seed, rate, True)
    want.backward(g.double())
    refs = [_round(want.detach().float()), _round(leaves[0].grad.float())]
    refs += [t.grad for t in leaves[1:]]
    for name, got, ref in zip(["y", "dx", "dw1", "db1", "dw2", "db2"],
                              [y] + grads, refs):
        assert got.shape == ref.shape and torch.isfinite(got).all(), name
        ref = ref.double()
        rel = ((got.double() - ref).norm() / ref.norm()).item()
        if name in ("y", "dx"):
            top = ref.abs().max().item()
            step = 2.0 ** (np.floor(np.log2(top)) - 7)
            assert (got.double() - ref).abs().max().item() <= 2 * step, name
            assert rel <= 2e-3, (name, rel)
        else:
            assert rel <= 1e-5, (name, rel)
