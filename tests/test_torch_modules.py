"""The port's modules against the JAX package's at tiny widths on the CPU,
with the JAX weights carried across by `cpc2_torch.io.state_dict_from_jax`.
The same inputs, made from a seed with numpy, go to both sides.

Tolerances are fp32 reordering: rtol 1e-5, atol 1e-6 for forwards and
rtol 1e-4, atol 1e-6 for gradients, unless a test states a looser one
with its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc2_tpu.io.torch_ckpt import params_to_torch_state_dict
from cpc2_tpu.losses.criterion import (
    CPCUnsupervisedCriterion as JaxCriterion)
from cpc2_tpu.models.ar import CPCAR as JaxCPCAR
from cpc2_tpu.models.encoder import CPCEncoder as JaxCPCEncoder
from cpc2_tpu.models.transformer import TransformerAR as JaxTransformerAR
from cpc2_torch.io import state_dict_from_jax
from cpc2_torch.losses import CPCUnsupervisedCriterion
from cpc2_torch.models import CPCAR, CPCEncoder, TransformerAR

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), err_msg=name, **tol)


def _close_sums(got, want, name):
    """Weight gradients that sum many products over rows and frames: an
    element that cancels to near zero keeps the absolute rounding of the
    tensor's larger terms (seen up to 1.5e-6 beside values of 2), so atol
    is 1e-6 times the tensor's largest magnitude when that exceeds 1."""
    want = np.asarray(want)
    atol = 1e-6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=atol, err_msg=name)


@pytest.mark.parametrize("norm_mode",
                         ["layerNorm", "ID", "instanceNorm", "batchNorm"])
def test_encoder_matches_jax(norm_mode):
    """Forward in training mode, and the gradients of every weight and of
    the input. The normalized forwards are held to atol 1e-5: a norm
    divides by a standard deviation, which scales fp32 reordering errors
    of the convolutions up to about 1e-6 absolute at outputs of order 1.
    BatchNorm's running mean after the step matches too (its running
    variance does not: torch averages the unbiased batch variance, flax
    the biased one)."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 1600).astype(np.float32)
    jmod = JaxCPCEncoder(size_hidden=16, norm_mode=norm_mode)
    variables = _np(jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                       jnp.asarray(x)))
    params, stats = variables["params"], variables.get("batch_stats")
    cot = rs.randn(2, 10, 16).astype(np.float32)

    mod = CPCEncoder(16, norm_mode)
    mod.load_state_dict(state_dict_from_jax(params, stats,
                                            norm_mode=norm_mode))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = mod(xt)
    y.backward(torch.from_numpy(cot))

    def f(p, xx):
        if stats is None:
            return jmod.apply({"params": p}, xx)
        y, updates = jmod.apply({"params": p, "batch_stats": stats}, xx,
                                mutable=["batch_stats"])
        return y, updates["batch_stats"]
    if stats is None:
        y_j, vjp = jax.vjp(jax.jit(f), params, jnp.asarray(x))
    else:
        y_j, vjp, new_stats = jax.vjp(jax.jit(f), params, jnp.asarray(x),
                                      has_aux=True)
        running = state_dict_from_jax({}, _np(new_stats))
        for name, buf in mod.named_buffers():
            if name.endswith("running_mean"):
                _close(buf, running[name].numpy(), FWD, name)
    gp, gx = vjp(jnp.asarray(cot))
    assert tuple(y.shape) == y_j.shape == (2, 10, 16)
    _close(y, y_j, dict(rtol=1e-5, atol=1e-5), "y")
    _close(xt.grad, gx, GRAD, "dx")
    grads = state_dict_from_jax(_np(gp), norm_mode=norm_mode)
    for name, p in mod.named_parameters():
        if norm_mode in ("instanceNorm", "batchNorm") and \
                name.endswith(".bias") and name.startswith("conv"):
            # a per-channel bias before a norm over time cancels: its exact
            # gradient is 0, and both sides hold rounding noise
            assert p.grad.abs().max().item() < 1e-4, name
            assert np.abs(grads[name].numpy()).max() < 1e-4, name
            continue
        _close_sums(p.grad, grads[name].numpy(), name)


def test_lstm_ar_with_carry_matches_jax():
    """Two chained calls threading the (h, c) carry, and the gradients of
    the second call's output w.r.t. every weight and the input."""
    rs = np.random.RandomState(1)
    x1 = rs.randn(2, 9, 8).astype(np.float32)
    x2 = rs.randn(2, 9, 8).astype(np.float32)
    jmod = JaxCPCAR(dim_encoded=8, dim_output=6, keep_hidden=True,
                    n_levels=2, mode="LSTM")
    params = _np(jax.jit(jmod.init)(jax.random.PRNGKey(1),
                                    jnp.asarray(x1))["params"])
    mod = CPCAR(8, 6, keep_hidden=True, n_levels=2, mode="LSTM")
    mod.load_state_dict(state_dict_from_jax(params))

    y1_j, hid_j = jmod.apply({"params": params}, jnp.asarray(x1))
    y1, hid = mod(torch.from_numpy(x1))
    _close(y1, y1_j, FWD, "y1")
    for a, b in zip(hid, hid_j):
        _close(a, b, FWD, "hidden")

    def f(p, xx):
        return jmod.apply({"params": p}, xx, hid_j)[0]
    y2_j, vjp = jax.vjp(jax.jit(f), params, jnp.asarray(x2))
    cot = rs.randn(*y2_j.shape).astype(np.float32)
    gp, gx = vjp(jnp.asarray(cot))
    x2t = torch.from_numpy(x2).requires_grad_(True)
    y2, _ = mod(x2t, tuple(h.detach() for h in hid))
    y2.backward(torch.from_numpy(cot))
    _close(y2, y2_j, FWD, "y2")
    _close(x2t.grad, gx, GRAD, "dx")
    grads = state_dict_from_jax(_np(gp))
    for name, p in mod.named_parameters():
        _close(p.grad, grads[name].numpy(), GRAD, name)


def test_transformer_head_with_block_padding_matches_jax():
    """One transformer head, dropout off, at S = 13 over blocks of 8 (the
    last block is zero-padded): forward and every gradient."""
    rs = np.random.RandomState(2)
    x = rs.randn(2, 13, 16).astype(np.float32)
    jmod = JaxTransformerAR(dim_encoded=12, dim_ar=16, n_layers=1,
                            size_seq=8)
    params = _np(jax.jit(lambda key, xx: jmod.init(key, xx, None, False))(
        jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    mod = TransformerAR(12, 16, 1, 8)
    mod.load_state_dict(state_dict_from_jax(params))
    mod.eval()
    cot = rs.randn(2, 13, 12).astype(np.float32)

    def f(p, xx):
        return jmod.apply({"params": p}, xx, None, False)[0]
    y_j, vjp = jax.vjp(jax.jit(f), params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = mod(xt)
    y.backward(torch.from_numpy(cot))
    _close(y, y_j, FWD, "y")
    _close(xt.grad, gx, GRAD, "dx")
    grads = state_dict_from_jax(_np(gp))
    for name, p in mod.named_parameters():
        _close_sums(p.grad, grads[name].numpy(), name)


def test_negative_sampling_distribution():
    """`sample_negative_indices` draws the reference's distribution: a
    batch element uniform in [0, B) and a frame (U[1, S) + w) mod S, so
    never the window position's own frame."""
    from cpc2_torch.losses import sample_negative_indices
    b, s, n, w = 4, 12, 64, 9
    gen = torch.Generator()
    gen.manual_seed(0)
    idx = sample_negative_indices(gen, b, s, n, w, torch.device("cpu"))
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (b, n, w)
    batch_of, frame = idx // s, idx % s
    shift = (frame - torch.arange(w)[None, None, :]) % s
    assert shift.min().item() == 1 and shift.max().item() == s - 1
    assert set(batch_of.unique().tolist()) == set(range(b))
    counts = torch.bincount(shift.flatten(), minlength=s)[1:].float()
    assert (counts / counts.mean() - 1).abs().max().item() < 0.15
    again = torch.Generator()
    again.manual_seed(0)
    assert torch.equal(idx, sample_negative_indices(again, b, s, n, w,
                                                    torch.device("cpu")))


def _criterion_case():
    rs = np.random.RandomState(3)
    b, s, d, k, n = 2, 20, 16, 3, 8
    w = s - k
    c = rs.randn(b, s, d).astype(np.float32)
    e = rs.randn(b, s, d).astype(np.float32)
    neg = rs.randint(0, b * s, size=(b, n, w)).astype(np.int32)
    # a collision: one negative of (b=1, w=10) is head 3's positive frame
    neg[1, 2, 10] = 1 * s + 10 + 3
    # an exact tie: every negative of (b=0, w=5) is head 1's positive, so
    # max(neg) == pos there and the position counts as correct
    neg[0, :, 5] = 0 * s + 5 + 1
    return c, e, neg


def test_criterion_matches_jax():
    """Per-head losses and accuracies with fixed negatives, including a
    forced collision and an exact tie, and the gradients w.r.t. the
    context, the encodings and every weight, dropout off."""
    c, e, neg = _criterion_case()
    jcrit = JaxCriterion(n_predicts=3, dim_ar=16, dim_enc=16,
                         negative_sampling_ext=8, rnn_mode="transformer",
                         size_input_seq=20)
    rngs = {"params": jax.random.PRNGKey(3),
            "negatives": jax.random.PRNGKey(4)}
    params = _np(jax.jit(lambda r, cc, ee: jcrit.init(
        r, cc, ee, None, train=False))(rngs, jnp.asarray(c),
                                       jnp.asarray(e))["params"])
    crit = CPCUnsupervisedCriterion(3, 16, 16, 8, size_input_seq=20)
    crit.load_state_dict(state_dict_from_jax(params))
    crit.eval()

    def f(p, cc, ee):
        return jcrit.apply({"params": p}, cc, ee, None, train=False,
                           negative_indices=jnp.asarray(neg))
    (loss_j, acc_j), vjp = jax.vjp(jax.jit(f), params, jnp.asarray(c),
                                   jnp.asarray(e))
    gp, gc, ge = vjp((jnp.ones_like(loss_j), jnp.zeros_like(acc_j)))

    ct = torch.from_numpy(c).requires_grad_(True)
    et = torch.from_numpy(e).requires_grad_(True)
    loss, acc = crit(ct, et, negative_indices=torch.from_numpy(neg))
    loss.sum().backward()
    assert tuple(loss.shape) == (1, 3)
    _close(loss, loss_j, FWD, "losses")
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    _close(ct.grad, gc, GRAD, "dc")
    _close(et.grad, ge, GRAD, "de")
    grads = state_dict_from_jax(_np(gp))
    for name, p in crit.named_parameters():
        _close_sums(p.grad, grads[name].numpy(), name)

    # every negative on head 1's positive frame: an exact tie everywhere,
    # which counts as correct on both sides
    tie = _all_positive(neg.shape, 20)
    _, acc_tie_j = jcrit.apply({"params": params}, jnp.asarray(c),
                               jnp.asarray(e), None, train=False,
                               negative_indices=jnp.asarray(tie))
    _, acc_tie = crit(ct.detach(), et.detach(),
                      negative_indices=torch.from_numpy(tie))
    assert acc_tie[0, 0].item() == 1.0 == float(acc_tie_j[0, 0])


def _all_positive(shape, s):
    """Negatives that all sit on head 1's positive frame, w + 1."""
    b, _n, w = shape
    rows = (np.arange(b)[:, None, None] * s + np.arange(w)[None, None, :] + 1)
    return np.ascontiguousarray(np.broadcast_to(rows, shape), np.int32)


@pytest.mark.parametrize("which", ["model", "criterion"])
def test_state_dict_keys_match_torch_ckpt(which):
    """`state_dict_from_jax` gives the keys, shapes and values of the JAX
    package's reference-format converter, and exactly the port modules'
    keys."""
    from cpc2_tpu.models.cpc import CPCModel as JaxCPCModel
    from cpc2_torch.models import CPCModel
    if which == "model":
        jmod = JaxCPCModel(gEncoder=JaxCPCEncoder(16),
                           gAR=JaxCPCAR(16, 8, mode="LSTM"))
        variables = jax.jit(jmod.init)(jax.random.PRNGKey(5),
                                       jnp.zeros((2, 800)))
        port = CPCModel(CPCEncoder(16), CPCAR(16, 8, mode="LSTM"))
        ref = params_to_torch_state_dict(_np(variables["params"]),
                                         norm_mode="layerNorm")
    else:
        jmod = JaxCriterion(n_predicts=2, dim_ar=8, dim_enc=8,
                            negative_sampling_ext=4, rnn_mode="transformer",
                            size_input_seq=10)
        variables = jax.jit(lambda r, c, e: jmod.init(
            r, c, e, None, train=False))(
            {"params": jax.random.PRNGKey(6),
             "negatives": jax.random.PRNGKey(7)},
            jnp.zeros((2, 10, 8)), jnp.zeros((2, 10, 8)))
        port = CPCUnsupervisedCriterion(2, 8, 8, 4, size_input_seq=10)
        ref = params_to_torch_state_dict(_np(variables["params"]),
                                         rnn_mode="transformer")
    ours = state_dict_from_jax(_np(variables["params"]))
    assert set(ours) == set(ref) == set(port.state_dict())
    for key, value in ref.items():
        assert tuple(ours[key].shape) == tuple(value.shape), key
        np.testing.assert_array_equal(ours[key].numpy(), value.numpy())
    port.load_state_dict(ours)
