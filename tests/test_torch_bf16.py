"""`--precision bf16` on the CPU: the bf16-in/bf16-out FFN and attention
(`ffn_plain`, `attention_plain` on bf16 inputs) against the JAX package's
Pallas kernels in interpret mode on the same bf16 inputs, one transformer
head and the 12-head `PredictionNetwork` against the JAX package's under
its `apply_precision('bf16')`, and one whole training step at width 64.

A bf16 output is compared after its rounding: the unrounded values of the
two sides agree within fp32 reordering (rtol 1e-5, atol 1e-6 forward; rtol
1e-4, atol 1e-6 for gradients), so the port's bf16 value must lie between
the bf16 roundings of the reference's value less and plus that tolerance
(`assert_rounds_alike`): equal, or one bf16 step away where the reference
lies within the tolerance of a rounding midpoint. The reference's
unrounded values come from the JAX kernel run on fp32 inputs that hold
the same bf16 values, which computes the same fp32 sums and stops short of
the final rounding (its FFN casts its inputs to fp32 first; its attention
backward recomputes p~ in fp32 from the inputs either way).
"""

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cpc2_tpu.ops.attention_pallas import \
    fused_relpos_attention as jax_attention
from cpc2_tpu.ops.ffn_pallas import fused_ffn as jax_fused_ffn
from cpc2_torch.ops import attention as att
from cpc2_torch.ops.attention import attention_plain
from cpc2_torch.ops.ffn import ffn_bf16io_plan, ffn_plain, keep_mask

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
BF16 = torch.bfloat16


def _bf16(a) -> np.ndarray:
    """float64 copy of `a` rounded to bf16 (round to nearest even)."""
    return np.asarray(a, np.float64).astype(np.float32).astype(
        ml_dtypes.bfloat16).astype(np.float64)


def assert_rounds_alike(got, want, rtol, atol, name=""):
    """`got` (bf16 values) is the bf16 rounding of a value within rtol /
    atol of `want` (the reference's unrounded values): between the
    roundings of want -/+ the tolerance, which rounding keeps in order."""
    got = np.asarray(torch.as_tensor(got).double())
    want = np.asarray(want, np.float64)
    tol = atol + rtol * np.abs(want)
    lo, hi = _bf16(want - tol), _bf16(want + tol)
    bad = (got < lo) | (got > hi)
    assert not bad.any(), (name, int(bad.sum()), got[bad][:5], want[bad][:5])


def _as_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(BF16)


# --- the FFN ---------------------------------------------------------------

M, DIN, DFF, DOUT = 16, 8, 32, 8


def _eighths(rs, *shape):
    return (rs.randint(-8, 9, size=shape) / 8.0).astype(np.float32)


def _port_ffn(x, w1, b1, w2, b2, g, seed, rate):
    """ffn_plain on a bf16 x: y and the five gradients."""
    xt = _as_bf16(x).requires_grad_(True)
    ws = [torch.from_numpy(a).requires_grad_(True) for a in (w1, b1, w2, b2)]
    y = ffn_plain(xt, *ws, seed, rate, True)
    assert y.dtype == BF16
    y.backward(_as_bf16(g))
    assert xt.grad.dtype == BF16
    return y.detach(), [xt.grad] + [w.grad for w in ws]


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_plain_bf16io_matches_explicit_rounding(rate):
    """Inputs that are multiples of 1/8 (bf16 values, exact sums up to the
    hidden) through `ffn_plain` on a bf16 x, against float64 with the bf16
    kernels' rounding points and the io ones: y rounded once after its sum
    with b2, dx once after its sum; the weights' gradients fp32."""
    rs = np.random.RandomState(4)
    x, w1, b1, w2, b2 = (_eighths(rs, M, DIN), _eighths(rs, DFF, DIN),
                         _eighths(rs, DFF), _eighths(rs, DOUT, DFF),
                         _eighths(rs, DOUT))
    g = _eighths(rs, M, DOUT)
    seed = torch.tensor([5], dtype=torch.int32)
    y, grads = _port_ffn(x, w1, b1, w2, b2, g, seed, rate)
    keep = keep_mask(seed, M, DFF, rate).numpy()
    x64, w1r, w2r, g64 = (a.astype(np.float64) for a in (x, w1, w2, g))
    pre = x64 @ w1r.T + b1
    scale = np.where(keep, 1.0 / (1.0 - rate), 0.0)
    hr = _bf16(np.maximum(pre, 0.0) * scale)
    dh = (g64 @ w2r) * scale * (pre > 0)
    dhr = _bf16(dh)
    assert_rounds_alike(y, hr @ w2r.T + b2, name="y", **FWD)
    assert_rounds_alike(grads[0], dhr @ w1r, name="dx", **GRAD)
    for got, want, name in zip(grads[1:], [dhr.T @ x64, dh.sum(0),
                                           g64.T @ hr, g64.sum(0)],
                               ["dw1", "db1", "dw2", "db2"]):
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **GRAD)


def test_ffn_plain_bf16io_matches_pallas(monkeypatch):
    """`ffn_plain` on a bf16 x against the JAX kernel in interpret mode on
    the same bf16 x, at the TPU's default precision (each `dot_general`
    operand rounded to bf16, as `tests/test_torch_ffn.py` emulates it),
    dropout off (the TPU kernel's mask is its own generator's). The JAX
    kernel returns y and dx in bf16, rounded once from its fp32 block and
    its summed dx partials; its run on fp32 inputs holding the same values
    gives those sums unrounded, and both sides round alike from them."""
    _tpu_default_precision(monkeypatch)
    rs = np.random.RandomState(7)
    x = _bf16(rs.randn(M, DIN)).astype(np.float32)
    ws = [(0.3 * rs.randn(*s)).astype(np.float32)
          for s in ((DFF, DIN), (DFF,), (DOUT, DFF), (DOUT,))]
    g = _bf16(rs.randn(M, DOUT)).astype(np.float32)
    y, grads = _port_ffn(x, *ws, g, torch.zeros(1, dtype=torch.int32), 0.0)

    seed = jnp.zeros((1, 1), jnp.int32)

    def run(dtype):
        out, vjp = jax.vjp(lambda *a: jax_fused_ffn(*a, seed, 0.0, True),
                           jnp.asarray(x, dtype), *map(jnp.asarray, ws))
        return out, vjp(jnp.asarray(g, dtype))
    y16, grads16 = run(jnp.bfloat16)
    y32, grads32 = run(jnp.float32)
    assert y16.dtype == jnp.bfloat16 and grads16[0].dtype == jnp.bfloat16
    # the JAX kernel's bf16 outputs are its fp32 ones rounded once
    np.testing.assert_array_equal(np.asarray(y16, np.float64), _bf16(y32))
    np.testing.assert_array_equal(np.asarray(grads16[0], np.float64),
                                  _bf16(grads32[0]))
    assert_rounds_alike(y, y32, name="y", **FWD)
    assert_rounds_alike(grads[0], grads32[0], name="dx", rtol=1e-4,
                        atol=1e-5)
    for got, want, name in zip(grads[1:], grads16[1:],
                               ["dw1", "db1", "dw2", "db2"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_ffn_bf16io_emulation_matches_pallas(monkeypatch):
    """The bf16-io kernels' decomposition emulated from their plan
    (`tests/test_torch_ffn.py:_emulate_bf16io_route`: y in clusters of 2,
    dW2 and dW1 in clusters of 4, uneven runs of k tiles, ragged tiles)
    against the JAX kernel in interpret mode on the same numpy inputs at
    the TPU's default precision, dropout off, as
    `test_ffn_plain_bf16io_matches_pallas` runs it. The inputs are
    multiples of 1/8, so every sum up to the hidden and dh is exact in any
    order and both sides round the same hidden and dh; y and dx then round
    alike from sums within FWD and GRAD of the JAX kernel's unrounded ones
    (`assert_rounds_alike`), and the weights' gradients are held to GRAD
    (fp32 sums in other orders)."""
    from tests.test_torch_ffn import _emulate_bf16io_route
    _tpu_default_precision(monkeypatch)
    m, din, dff, dout = 200, 72, 136, 24
    rs = np.random.RandomState(9)
    arrays = [_eighths(rs, m, din), _eighths(rs, dff, din), _eighths(rs, dff),
              _eighths(rs, dout, dff), _eighths(rs, dout)]
    g = _eighths(rs, m, dout)
    plan = ffn_bf16io_plan(m, din, dff, dout)
    assert (plan.y.cluster, plan.dw2.cluster, plan.dx.cluster) == (2, 4, 2)
    keep = torch.ones(m, dff, dtype=torch.bool)
    y, grads = _emulate_bf16io_route(
        plan, *(torch.from_numpy(a) for a in arrays + [g]), keep, 0.0)

    seed = jnp.zeros((1, 1), jnp.int32)

    def run(dtype):
        out, vjp = jax.vjp(lambda *a: jax_fused_ffn(*a, seed, 0.0, True),
                           jnp.asarray(arrays[0], dtype),
                           *map(jnp.asarray, arrays[1:]))
        return out, vjp(jnp.asarray(g, dtype))
    _y16, grads16 = run(jnp.bfloat16)
    y32, grads32 = run(jnp.float32)
    assert_rounds_alike(y, y32, name="y", **FWD)
    assert_rounds_alike(grads[0], grads32[0], name="dx", **GRAD)
    for got, want, name in zip(grads[1:], grads16[1:],
                               ["dw1", "db1", "dw2", "db2"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **GRAD)


def test_ffnetwork_takes_bf16_in_and_out():
    """A bf16 input to the module takes the bf16 route's io variant whatever
    the matmul switch says, and returns bf16."""
    from cpc2_torch.models.transformer import FFNetwork
    module = FFNetwork(8, 8, 32, 0.0)
    x = torch.randn(2, 3, 8).to(BF16)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        y = module(x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert y.dtype == BF16 and y.shape == (2, 3, 8)
    with torch.no_grad():
        want = ffn_plain(x.reshape(6, 8), module.lin1.weight,
                         module.lin1.bias, module.lin2.weight,
                         module.lin2.bias, torch.zeros(1, dtype=torch.int32),
                         0.0, True)
    assert torch.equal(y.detach().reshape(6, 8), want)
    with pytest.raises(TypeError):
        ffn_plain(x.reshape(6, 8), module.lin1.weight, module.lin1.bias,
                  module.lin2.weight, module.lin2.bias,
                  torch.zeros(1, dtype=torch.int32), 0.0, False)


# --- the attention -----------------------------------------------------------

def _w2(krelpos, s):
    offs = jnp.clip(jnp.arange(s)[:, None] - jnp.arange(s)[None, :], 0, s - 1)
    return jnp.take(krelpos[:, ::-1], offs, axis=1)


def _attention_inputs(seed, n, s, dk):
    rs = np.random.RandomState(seed)
    qkv = [_bf16(rs.randn(n, s, dk)).astype(np.float32) for _ in range(3)]
    return qkv, rs.randn(dk, s).astype(np.float32), _bf16(
        rs.randn(n, s, dk)).astype(np.float32)


def _jax_attention_run(qkv, krel, cot, dtype):
    """The JAX kernel's output and, with `cot`, its four gradients."""
    seed = jnp.zeros((1, 1), jnp.int32)
    s = qkv[0].shape[1]

    def f(q, k, v, kr):
        return jax_attention(q, k, v, _w2(kr, s), seed, 0.0, True)
    args = [jnp.asarray(a, dtype) for a in qkv] + [jnp.asarray(krel)]
    if cot is None:
        return jax.jit(f)(*args), None
    out, vjp = jax.vjp(jax.jit(f), *args)
    return out, vjp(jnp.asarray(cot, dtype))


def _port_attention(qkv, krel, cot, seed, rate):
    leaves = [_as_bf16(a).requires_grad_(True) for a in qkv]
    kr = torch.from_numpy(krel).requires_grad_(True)
    out = attention_plain(*leaves, kr, seed, rate)
    assert out.dtype == BF16
    out.backward(_as_bf16(cot))
    return out.detach(), [a.grad for a in leaves] + [kr.grad]


def test_attention_plain_bf16io_matches_pallas():
    """`attention_plain` on bf16 q, k, v against the JAX kernel in interpret
    mode on the same values at (4, 17, 8), dropout off: forward, dq, dk, dv
    and dKrelpos. Backward: the JAX kernel recomputes p~ in fp32 from the
    inputs, so its bf16 dq, dk and dv are its fp32-input run's rounded
    once; the port's round alike from those (dKrelpos fp32 at rtol 1e-4).
    Forward: both round p~ to bf16 for p~ .
    v, and a probability within fp32 reordering of a rounding midpoint can
    round either way on the two sides, moving its row of o by a bf16 step
    of p~ times v; so the JAX bf16 o must round alike from the port's
    unrounded o except at such rows, where it is held within 2**-8 of the
    largest |o|, in at most 2% of the elements."""
    n, s, dk = 4, 17, 8
    qkv, krel, cot = _attention_inputs(1, n, s, dk)
    zero = torch.zeros(1, dtype=torch.int32)
    out, grads = _port_attention(qkv, krel, cot, zero, 0.0)
    out16, _ = _jax_attention_run(qkv, krel, None, jnp.bfloat16)
    _out32, grads32 = _jax_attention_run(qkv, krel, cot, jnp.float32)
    assert out16.dtype == jnp.bfloat16
    for got, want, name in zip(grads[:3], grads32[:3], ["dq", "dk", "dv"]):
        assert_rounds_alike(got, want, name=name, **GRAD)
    np.testing.assert_allclose(grads[3].numpy(), np.asarray(grads32[3]),
                               err_msg="dKrelpos", **GRAD)

    with torch.no_grad():
        unrounded = att._attention_f32(
            *(torch.from_numpy(a) for a in qkv), torch.from_numpy(krel),
            zero, 0.0, True).double().numpy()
    jax_o = np.asarray(out16, np.float64)
    tol = FWD["atol"] + FWD["rtol"] * np.abs(unrounded)
    alike = (jax_o >= _bf16(unrounded - tol)) & (jax_o <= _bf16(unrounded
                                                                + tol))
    assert (~alike).mean() <= 0.02, (~alike).mean()
    np.testing.assert_allclose(jax_o, unrounded, rtol=0,
                               atol=2.0 ** -8 * np.abs(unrounded).max())
    assert torch.equal(out, torch.from_numpy(unrounded).to(BF16))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_plain_bf16io_backward_is_straight_through(rate):
    """The backward takes p~ unrounded: dv = p~^T g and the softmax
    gradient from the fp32 p~, against float64 with the kernel's hash mask
    (at rate 0.1 too); the same with p~ rounded in the backward lies
    outside the band, so the check tells the two apart."""
    n, s, dk = 3, 12, 8
    qkv, krel, cot = _attention_inputs(2, n, s, dk)
    seed = torch.tensor([77], dtype=torch.int32)
    _out, grads = _port_attention(qkv, krel, cot, seed, rate)

    q, k, v, g = (torch.from_numpy(a).double() for a in qkv + [cot])
    q.requires_grad_(True)
    k.requires_grad_(True)
    kr = torch.from_numpy(krel).double().requires_grad_(True)
    logits = (q @ k.transpose(1, 2) + torch.einsum(
        "nrd,drc->nrc", q, att.relpos_table(kr))) / math.sqrt(dk)
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    p = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=2)
    keep = keep_mask(seed, n * s, s, rate).reshape(n, s, s)
    pd = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
    dv = pd.transpose(1, 2) @ g
    (pd * (g @ v.transpose(1, 2))).sum().backward()
    for got, want, name in zip(grads, [q.grad, k.grad, dv, kr.grad],
                               ["dq", "dk", "dv", "dKrelpos"]):
        if name == "dKrelpos":
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       err_msg=name, **GRAD)
        else:
            assert_rounds_alike(got, want.detach().numpy(), name=name,
                                **GRAD)
    rounded = torch.from_numpy(_bf16(pd.detach().numpy()))
    with pytest.raises(AssertionError):
        assert_rounds_alike(grads[2], (rounded.transpose(1, 2) @ g).numpy(),
                            **GRAD)


# --- the heads ---------------------------------------------------------------

B, W, D, K = 2, 20, 32, 12


def _tpu_default_precision(monkeypatch):
    """Each operand of a `jax.lax.dot_general` (the calls in the JAX
    package's Pallas FFN) rounded to bf16: the TPU's single-pass default,
    which XLA on the CPU does not take (`tests/test_torch_ffn.py`)."""
    real = jax.lax.dot_general

    def tpu_default(lhs, rhs, *args, **kwargs):
        return real(lhs.astype(jnp.bfloat16).astype(jnp.float32),
                    rhs.astype(jnp.bfloat16).astype(jnp.float32), *args,
                    **kwargs)
    monkeypatch.setattr(jax.lax, "dot_general", tpu_default)


@pytest.fixture
def jax_bf16(monkeypatch):
    """The JAX package's `apply_precision('bf16')`, with the config value
    and the activation dtype it sets restored after, and its heads' FFN
    the Pallas kernel in interpret mode at the TPU's precision
    (`CPC2_FUSED_FFN_INTERPRET=1`): the TPU's path, which the port's FFN
    follows. On the CPU the JAX package runs the XLA chain instead, which
    rounds the hidden after lin1 + b1 and adds both biases in bf16: a
    pre-activation within that rounding of 0 flips its ReLU, and the
    lin1 gradients then differ by about 5% in the 2-norm at this width."""
    from cpc2_tpu.utils import misc
    monkeypatch.setenv("CPC2_FUSED_FFN_INTERPRET", "1")
    _tpu_default_precision(monkeypatch)
    before = (jax.config.jax_default_matmul_precision,
              misc._ACTIVATION_DTYPE)
    misc.apply_precision('bf16')
    try:
        yield
    finally:
        jax.config.update('jax_default_matmul_precision', before[0])
        misc._ACTIVATION_DTYPE = before[1]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


LIN1_TOL = 1e-1


def _hold_head(f_jax, params, module, x, cot, fwd_tol, grad_tol):
    """f_jax(params, x) against `module(x)`: the forward within fwd_tol of
    the largest value, every gradient (the input's and each weight's)
    within grad_tol in the 2-norm of the difference over the JAX one's, the
    FFN's lin1 within LIN1_TOL (the `bf16mix` step's band for them,
    `chip_smoke.py`): its input is a bf16 LayerNorm's output, which a bf16
    step moves on one side, and a pre-activation that step carries across
    0 switches its unit's gradient on or off whole."""
    from cpc2_torch.io import state_dict_from_jax
    out_j, vjp = jax.vjp(jax.jit(f_jax), params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot, out_j.dtype))
    module.load_state_dict(state_dict_from_jax(_np_tree(params)))
    module.eval()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = module(xt)
    out.backward(torch.from_numpy(cot).to(out.dtype))
    want = np.asarray(out_j, np.float64)
    got = out.detach().double().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < fwd_tol, ("forward", err)
    grads = {"input": (xt.grad, gx)}
    ref = state_dict_from_jax(_np_tree(gp))
    for name, p in module.named_parameters():
        grads[name] = (p.grad, ref[name].numpy())
    for name, (g, want) in grads.items():
        want = np.asarray(want, np.float64)
        rel = (np.linalg.norm(g.double().numpy() - want)
               / np.linalg.norm(want))
        assert rel < (LIN1_TOL if ".lin1." in name else grad_tol), (name,
                                                                     rel)
    return out


def test_transformer_head_bf16_matches_jax(jax_bf16):
    """One `TransformerAR` head (width 32, 20 frames, one layer) on a bf16
    input, dropout off, against the JAX package's (`jax_bf16`). The two
    round at the same points, but each rounding to bf16 (8 significant
    bits) of a value that fp32 reordering moved across a rounding midpoint
    lands a bf16 step away, and the outputs are bf16 LayerNorms': the
    forward is held within 1e-2 of the largest value; the gradients, where
    such a step through a ReLU or a softmax moves further, within 5e-2 in
    the 2-norm of the difference over the JAX gradient's (lin1's within
    LIN1_TOL). At this size the forward differs by 5.2e-3 and the
    gradients by 1.5e-2 but lin1's by 5.0e-2."""
    from cpc2_tpu.models.transformer import TransformerAR as JaxHead
    from cpc2_torch.models.transformer import TransformerAR
    head = JaxHead(dim_encoded=D, dim_ar=D, n_layers=1, size_seq=W)
    rs = np.random.RandomState(0)
    x = _bf16(rs.randn(B, W, D)).astype(np.float32)
    cot = _bf16(rs.randn(B, W, D)).astype(np.float32)
    params = head.init(jax.random.PRNGKey(0), jnp.zeros((B, W, D),
                                                        jnp.bfloat16),
                       None, False)["params"]

    def f(p, xx):
        return head.apply({"params": p}, xx.astype(jnp.bfloat16), None,
                          False)[0]

    class Port(TransformerAR):
        def forward(self, xx):
            return super().forward(xx.to(BF16))[0]
    out = _hold_head(f, params, Port(D, D, 1, W), x, cot, 1e-2, 5e-2)
    assert out.dtype == BF16


def test_prediction_network_bf16_matches_jax(jax_bf16):
    """The 12-head `PredictionNetwork` with `head_dtype` bf16 against the
    JAX package's under `apply_precision('bf16')`: the context cast to bf16
    before the heads, the predictions back in fp32; bands and reasons as
    for one head."""
    from cpc2_tpu.losses.criterion import PredictionNetwork as JaxNet
    from cpc2_torch.losses import PredictionNetwork
    net = JaxNet(n_predicts=K, dim_ar=D, dim_enc=D, rnn_mode='transformer',
                 size_input_seq=W)
    rs = np.random.RandomState(1)
    c = rs.randn(B, W, D).astype(np.float32)
    cot = rs.randn(B, K, W, D).astype(np.float32)
    params = net.init(jax.random.PRNGKey(1), jnp.zeros((B, W, D)),
                      False)["params"]

    def f(p, cc):
        return net.apply({"params": p}, cc, False)
    port = PredictionNetwork(K, D, D, size_input_seq=W, head_dtype=BF16)
    out = _hold_head(f, params, port, c, cot, 1e-2, 5e-2)
    assert out.dtype == torch.float32 and out.shape == (B, K, W, D)


def test_head_dtype_follows_the_precision_flag():
    """`--precision bf16` builds the criterion's transformer heads in bf16;
    other modes, `--multihead_rnn` and the other precisions stay fp32."""
    from cpc2_torch.config import parse_args
    from cpc2_torch.train import get_criterion
    base = ["--pathDB", ".", "--file_extension", ".wav", "--hiddenEncoder",
            "16", "--hiddenGar", "16", "--nPredicts", "2"]
    for flags, want in ((["--precision", "bf16"], BF16),
                        (["--precision", "bf16mix"], None),
                        (["--precision", "bf16", "--rnnMode", "LSTM"], None),
                        (["--precision", "bf16", "--multihead_rnn"], None)):
        crit = get_criterion(parse_args(base + flags))
        assert getattr(crit.wPrediction, "head_dtype", None) == want, flags


# --- one training step ---------------------------------------------------------

STEP_B, WINDOW, STEP_K, STEP_N, STEP_WIDTH = 2, 3840, 3, 8, 64
FRAMES = WINDOW // 160


def _jax_bf16_step(batch, neg):
    """The JAX package's step (`cpc2_tpu/training.py:build_steps`' forward,
    dropout off) at width 64 under `--precision bf16 --adam_mu_dtype bf16`:
    the gradients, the losses and accuracies, and Adam's moments after the
    update."""
    import argparse

    from cpc2_tpu.losses.criterion import \
        CPCUnsupervisedCriterion as JaxCriterion
    from cpc2_tpu.models.ar import CPCAR as JaxCPCAR
    from cpc2_tpu.models.cpc import CPCModel as JaxCPCModel
    from cpc2_tpu.models.encoder import CPCEncoder as JaxCPCEncoder
    from cpc2_tpu.training import create_train_state
    from cpc2_tpu.training import make_optimizer as jax_opt
    w = STEP_WIDTH
    model = JaxCPCModel(gEncoder=JaxCPCEncoder(size_hidden=w,
                                               norm_mode="layerNorm"),
                        gAR=JaxCPCAR(w, w, mode="LSTM"))
    crit = JaxCriterion(n_predicts=STEP_K, dim_ar=w, dim_enc=w,
                        negative_sampling_ext=STEP_N, rnn_mode="transformer",
                        size_input_seq=FRAMES)
    model_vars = jax.jit(model.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((STEP_B, WINDOW)))
    crit_vars = jax.jit(lambda rngs, c, e: crit.init(rngs, c, e, None,
                                                      train=False))(
        {"params": jax.random.PRNGKey(1), "negatives": jax.random.PRNGKey(2)},
        jnp.zeros((STEP_B, FRAMES, w)), jnp.zeros((STEP_B, FRAMES, w)))
    args = argparse.Namespace(optimizer="adam", learningRate=2e-4, beta1=0.9,
                              beta2=0.999, epsilon=1e-8, adam_mu_dtype="bf16")
    tx = jax_opt(args)
    state = create_train_state(model_vars, crit_vars, tx)

    def loss_fn(params):
        x = jnp.asarray(batch)
        both = jnp.concatenate([x[:, 0, 0], x[:, 1, 0]], axis=0)
        enc = model.apply({"params": params["model"]}, both,
                          method=lambda m, z: m.gEncoder(z))
        c, _ = model.apply({"params": params["model"]}, enc[:STEP_B],
                           method=lambda m, z: m.gAR(z))
        losses, accs = crit.apply({"params": params["criterion"]}, c,
                                  enc[STEP_B:], None, train=False,
                                  negative_indices=jnp.asarray(neg))
        return jnp.sum(losses), (losses, accs)

    @jax.jit
    def step(state):
        grads, (losses, accs) = jax.grad(loss_fn, has_aux=True)(state.params)
        _updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return grads, opt_state, losses, accs

    grads, opt_state, losses, accs = step(state)
    return (_np_tree(state.params), _np_tree(grads),
            _np_tree(opt_state.inner_state[0].mu), np.asarray(losses),
            np.asarray(accs))


def test_training_step_bf16_matches_jax(jax_bf16):
    """One step of the port under `--precision bf16 --adam_mu_dtype bf16`
    from the JAX weights, dropout off, the same negatives, against the JAX
    step under the same flags (`jax_bf16`: its heads' FFN the TPU's
    kernel). The step band of `tests/test_torch_step.py` and `chip_smoke.py`:
    losses within rtol 1e-3, every gradient within
    5e-2 in the 2-norm (lin1's within LIN1_TOL, as for one head), and Adam's
    stored bf16 first moments, 0.1 g rounded, as the gradients (at this
    size the gradients differ by up to 2.9e-2, lin1's by 7.1e-2, as the
    `bf16mix` step's by 7.3e-2). Each head's
    accuracy may differ by one window of the 2 x 21: bf16 predictions move
    a window's positive score by about 2**-8 of it, and where a negative
    scores that close the window's argmax goes either way."""
    from cpc2_torch.config import parse_args
    from cpc2_torch.feature_loader import build_model
    from cpc2_torch.io import state_dict_from_jax
    from cpc2_torch.optim import AdamBF16Moment
    from cpc2_torch.train import get_criterion
    from cpc2_torch.training import Trainer, make_optimizer, precision
    rs = np.random.RandomState(0)
    batch = rs.randn(STEP_B, 2, 1, WINDOW).astype(np.float32)
    neg = rs.randint(0, STEP_B * FRAMES, size=(
        STEP_B, STEP_N, FRAMES - STEP_K)).astype(np.int32)
    params, grads, mu, losses_j, accs_j = _jax_bf16_step(batch, neg)

    w = str(STEP_WIDTH)
    args = parse_args(["--pathDB", ".", "--file_extension", ".wav",
                       "--device", "cpu", "--sizeWindow", str(WINDOW),
                       "--hiddenEncoder", w, "--hiddenGar", w, "--nPredicts",
                       str(STEP_K), "--negativeSamplingExt", str(STEP_N),
                       "--batchSizeGPU", str(STEP_B), "--random_seed", "0",
                       "--precision", "bf16", "--adam_mu_dtype", "bf16"])
    with precision(args.precision):
        model, crit = build_model(args), get_criterion(args)
        model.load_state_dict(state_dict_from_jax(params["model"]))
        crit.load_state_dict(state_dict_from_jax(params["criterion"]))
        for layer in (h[0] for h in crit.wPrediction.predictors):
            layer.ffnetwork.dropout = 0.0
            layer.multihead.Att.drop.rate = 0.0
        named = dict(list(model.named_parameters(prefix="model"))
                     + list(crit.named_parameters(prefix="criterion")))
        opt = make_optimizer(args, named.values())
        assert isinstance(opt, AdamBF16Moment)
        losses, accs = Trainer(model, crit, opt).train_step(
            torch.from_numpy(batch), torch.from_numpy(neg))

    np.testing.assert_allclose(losses.numpy(), losses_j, rtol=1e-3)
    windows = STEP_B * (FRAMES - STEP_K)
    np.testing.assert_allclose(accs.numpy(), accs_j, rtol=0,
                               atol=1.0 / windows + 1e-6)
    ref = {f"{scope}.{k}": v for scope in ("model", "criterion")
           for k, v in state_dict_from_jax(grads[scope]).items()}
    ref_mu = {f"{scope}.{k}": v for scope in ("model", "criterion")
              for k, v in state_dict_from_jax(mu[scope]).items()}
    assert set(named) == set(ref)
    for name, p in named.items():
        tol = LIN1_TOL if ".lin1." in name else 5e-2
        for got, want, what in ((p.grad, ref[name], "grad"),
                                (opt.state[p]["exp_avg"], ref_mu[name],
                                 "exp_avg")):
            want = want.double().numpy().reshape(got.shape)
            err = (np.linalg.norm(got.double().numpy() - want)
                   / np.linalg.norm(want))
            assert err < tol, (name, what, err)
        assert opt.state[p]["exp_avg"].dtype == BF16


def test_fp32_and_fp64_heads_keep_their_dtype():
    """The bf16 flow leaves wider inputs alone: a head on fp32 and on
    float64 input (the float64 reference steps of `chip_smoke.py`) computes
    in that dtype throughout, and the two agree within fp32 reordering."""
    from cpc2_torch.models.transformer import TransformerAR
    torch.manual_seed(0)
    head = TransformerAR(16, 16, 1, 12).eval()
    x = torch.randn(2, 12, 16)
    y32 = head(x)[0]
    y64 = head.double()(x.double())[0]
    assert y32.dtype == torch.float32 and y64.dtype == torch.float64
    torch.testing.assert_close(y32.double(), y64, rtol=1e-5, atol=1e-5)
