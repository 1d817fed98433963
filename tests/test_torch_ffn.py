"""The FFN's bf16 route on the CPU (`cpc2_torch/ops/ffn.py`): `ffn_plain(...,
bf16=True)` against an explicit float64 computation with the kernels'
rounding points, against the fp32 route, and the module's choice of route
under each precision.

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
from cpc2_torch.ops.ffn import ffn_plain, keep_mask
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
