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
from cpc2_torch.ops.infonce import negative_scores
from cpc2_torch.ops.lstm import _LSTMResident, _LSTMSteps, fused_lstm

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


def test_negative_scores_plain_matches_pallas():
    """Forward, dpreds and the scatter-add dz, with repeated indices. The
    Pallas kernel carries its f32 values through bf16 planes (three for
    the scores, two for the spread cotangent), which keep about 24 and 16
    bits: the forward is held to rtol 1e-5 with atol 1e-5 and the
    gradients to rtol 1e-4 with atol 2e-5 for that reason."""
    rs = np.random.RandomState(2)
    b, k, w, d, p, n = 2, 3, 11, 16, 40, 12
    idx = rs.randint(0, p, size=(b, w, n)).astype(np.int32)
    idx[:, :, ::3] = 7                      # one pool row drawn many times
    arrays = [rs.randn(b, k, w, d).astype(np.float32),
              rs.randn(p, d).astype(np.float32)]
    cots = [rs.randn(b, k, w, n).astype(np.float32)]
    idx_t, idx_j = torch.from_numpy(idx), jnp.asarray(idx)
    out_t, grad_t = _torch_grads(lambda a, z: negative_scores(a, z, idx_t),
                                 arrays, cots)
    out_j, grad_j = _jax_grads(
        lambda a, z: negative_scores_pallas(a, z, idx_j, interpret=True),
        arrays, cots)
    _assert_all_close(out_t, out_j, ["neg"], dict(rtol=1e-5, atol=1e-5))
    _assert_all_close(grad_t, grad_j, ["dpreds", "dz"],
                      dict(rtol=1e-4, atol=2e-5))


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
            # each route's own entry, at the recipe's width
            args = (torch.empty(2, 3, 1024, **meta),
                    torch.empty(2, 256, **meta), torch.empty(2, 256, **meta),
                    torch.empty(1024, 256, **meta), torch.empty(1024, **meta))
            if call == "lstm_resident":
                _LSTMResident.apply(*args, 8, 2)
            else:
                _LSTMSteps.apply(*args)
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
