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
