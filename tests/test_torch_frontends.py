"""The MFCC and learned-filterbank front-ends (`--encoder_type mfcc|lfb`)
against the JAX package's modules on the CPU, forward and backward, and one
whole training step with each (`tests/test_torch_modes.py`'s harness).
Inputs are made from a seed with numpy; the LFB's weights come across
through `cpc2_torch.io.state_dict_from_jax`.

Tolerances: the forwards rtol 1e-5 with atol 1e-6 of the output's largest
magnitude (the MFCC's dB values reach about 1e2, so fp32 rounding of the
FFT and the log is absolute there), the gradients rtol 1e-4 with atol
1e-6 of the largest magnitude (summed over every frame and tap), as
`tests/test_torch_modules.py` states for summed gradients. The MFCC's
input gradient is held to atol 1e-4 of its largest magnitude: the log's
derivative, 1 / mel, turns the fp32 rounding of the FFT in the weakest mel
bands into differences up to 3.6e-5 of that magnitude (seen at width 32;
nothing trains through it, the front-end has no parameters).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc2_tpu.models.encoder import LFBEncoder as JaxLFBEncoder
from cpc2_tpu.models.encoder import MFCCEncoder as JaxMFCCEncoder
from cpc2_tpu.models.encoder import _dct_matrix as jax_dct
from cpc2_tpu.models.encoder import melscale_fbanks as jax_fbanks
from cpc2_torch.io import state_dict_from_jax
from cpc2_torch.models import LFBEncoder, MFCCEncoder, encoded_seq_len
from cpc2_torch.models.encoder import _dct_matrix, melscale_fbanks
from tests.test_torch_modes import (B, S, WINDOW, _args, _case, _close_sums,
                                    jax_step, port_step)

torch.set_num_threads(1)


def _close(got, want, rtol, name, scale=1e-6):
    want = np.asarray(want)
    atol = scale * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=atol, err_msg=name)


def test_tables_match_jax():
    np.testing.assert_array_equal(melscale_fbanks(161, 0.0, 8000.0, 128,
                                                  16000),
                                  jax_fbanks(161, 0.0, 8000.0, 128, 16000))
    np.testing.assert_array_equal(_dct_matrix(40, 128), jax_dct(40, 128))


@pytest.mark.parametrize("kind,dim", [("mfcc", 32), ("mfcc", 160),
                                      ("lfb", 16)])
def test_frontend_matches_jax(kind, dim):
    """Forward, the input's gradient, and the LFB's weight gradients; the
    frames are `encoded_seq_len`'s (and 128 at 20,480 samples)."""
    rs = np.random.RandomState(0)
    x = (0.3 * rs.randn(B, WINDOW)).astype(np.float32)
    jmod = (JaxMFCCEncoder(dim_encoded=dim) if kind == "mfcc"
            else JaxLFBEncoder(dim_encoded=dim))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmod.init)(
        jax.random.PRNGKey(0), jnp.asarray(x)).get("params", {}))
    mod = MFCCEncoder(dim) if kind == "mfcc" else LFBEncoder(dim)
    mod.load_state_dict(state_dict_from_jax(params))

    y_j, vjp = jax.vjp(jax.jit(lambda p, xx: jmod.apply({"params": p}, xx)),
                       params, jnp.asarray(x))
    cot = rs.randn(*y_j.shape).astype(np.float32)
    gp, gx = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = mod(xt)
    y.backward(torch.from_numpy(cot))
    assert y.shape == (B, encoded_seq_len(WINDOW, kind), dim) == y_j.shape
    assert encoded_seq_len(20480, kind) == 128
    _close(y, y_j, 1e-5, "forward")
    _close(xt.grad, gx, 1e-4, "input gradient",
           1e-4 if kind == "mfcc" else 1e-6)
    grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, gp))
    assert set(grads) == {n for n, _ in mod.named_parameters()}
    for name, p in mod.named_parameters():
        _close_sums(p.grad.numpy(), grads[name].numpy(), name)


def test_mfcc_top_db_couples_the_batch():
    """The top-dB clamp is against the whole batch's maximum: a loud
    second row changes the first row's MFCCs (the training step encodes
    both views as one batch, as the JAX package's does)."""
    rs = np.random.RandomState(1)
    x = torch.from_numpy((1e-3 * rs.randn(2, WINDOW)).astype(np.float32))
    mod = MFCCEncoder(32)
    alone = mod(x[:1])
    loud = x.clone()
    loud[1] *= 1e5
    assert not torch.equal(mod(loud)[:1], alone)
    torch.testing.assert_close(mod(x)[:1], alone, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["mfcc", "lfb"])
def test_step_matches_jax(kind, monkeypatch):
    """One whole training step (`test_torch_modes.py`'s checks) with the
    front-end in place of the conv encoder."""
    args = _args(["--encoder_type", kind])
    batch, neg, mask, quality = _case(kind)
    params, grads, new_params, losses_j, accs_j = jax_step(
        args, batch, neg, mask, quality, monkeypatch)
    named, _opt, losses, accs = port_step(args, params, batch, neg, mask,
                                          quality)
    np.testing.assert_allclose(losses.numpy(), losses_j, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(accs.numpy(), accs_j)
    ref = {f"{scope}.{k}": v for scope in ("model", "criterion")
           for k, v in state_dict_from_jax(grads[scope]).items()}
    assert set(named) == set(ref)
    assert any(k.startswith("model.gEncoder") for k in named) == (
        kind == "lfb")
    for name, p in named.items():
        _close_sums(p.grad.numpy(), ref[name].numpy(), name)
    assert S == encoded_seq_len(WINDOW, kind)
