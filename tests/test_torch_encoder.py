"""The port's encoder kernels' plain version (`cpc2_torch/ops/encoder.py`)
against the JAX package's Pallas encoder, run in interpret mode on the CPU
as the JAX package's own tests run it, with the same inputs made from a
seed with numpy; the opt-in module path; and the gate.

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

from cpc2_tpu.ops.encoder_pallas import fused_encoder as jax_fused_encoder
from cpc2_torch.models.encoder import CPCEncoder
from cpc2_torch.ops import encoder as enc
from cpc2_torch.ops.encoder import (CONV_STACK, encoder_plain, fused_encoder,
                                    use_fused_encoder)
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
