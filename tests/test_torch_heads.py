"""The port's prediction heads (`--rnnMode`, `--multihead_rnn`) against the
JAX package's on the CPU, at tiny widths: batch 2, 20 frames, width 32,
nPredicts 4, 8 negatives passed in, dropout off. The JAX weights come
across through `cpc2_torch.io.state_dict_from_jax`; the inputs are made
from a seed with numpy.

Each case checks the per-head losses and accuracies of one criterion call
(rtol 1e-5, atol 1e-6), the gradients of the context, the encodings and
every weight (rtol 1e-4; summed weight gradients with atol 1e-6 of the
tensor's largest value, as `tests/test_torch_modules.py` states), and that
the port's state-dict keys are `params_to_torch_state_dict(...,
rnn_mode=...)`'s, the JAX package's writer, with equal values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc2_tpu.io.torch_ckpt import params_to_torch_state_dict
from cpc2_tpu.losses.criterion import (
    CPCUnsupervisedCriterion as JaxCriterion)
from cpc2_torch.io import state_dict_from_jax
from cpc2_torch.io.from_jax import jax_param_order
from cpc2_torch.losses import CPCUnsupervisedCriterion

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
B, S, D, K, N = 2, 20, 32, 4, 8

MODES = ["RNN", "LSTM", "linear", "ffd", "conv4", "conv8", "conv12",
         "transformer_adaptive_span", "multihead"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_sums(got, want, name):
    want = np.asarray(want)
    atol = 1e-6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=atol, err_msg=name)


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    c = rs.randn(B, S, D).astype(np.float32)
    e = rs.randn(B, S, D).astype(np.float32)
    neg = rs.randint(0, B * S, size=(B, N, S - K)).astype(np.int32)
    return c, e, neg


def _kwargs(mode):
    multihead = mode == "multihead"
    return dict(rnn_mode="transformer" if multihead else mode,
                multihead_rnn=multihead)


def _jax_criterion(mode, c, e, **extra):
    jcrit = JaxCriterion(n_predicts=K, dim_ar=D, dim_enc=D,
                         negative_sampling_ext=N, size_input_seq=S,
                         **_kwargs(mode), **extra)
    rngs = {"params": jax.random.PRNGKey(3),
            "negatives": jax.random.PRNGKey(4)}
    params = _np(jax.jit(lambda r, cc, ee: jcrit.init(
        r, cc, ee, None, train=False))(rngs, jnp.asarray(c),
                                       jnp.asarray(e))["params"])
    return jcrit, params


def _port_criterion(mode, params, **extra):
    crit = CPCUnsupervisedCriterion(K, D, D, N, size_input_seq=S,
                                    **_kwargs(mode), **extra)
    crit.load_state_dict(state_dict_from_jax(params))
    return crit.eval()


def hold_criterion(jcrit, params, crit, c, e, neg, quality=None):
    """One call of each side on the same inputs: losses, accuracies and
    every gradient."""
    extra = {} if quality is None else {"signal_quality":
                                        jnp.asarray(quality)}

    def f(p, cc, ee):
        return jcrit.apply({"params": p}, cc, ee, None, train=False,
                           negative_indices=jnp.asarray(neg), **extra)
    (loss_j, acc_j), vjp = jax.vjp(jax.jit(f), params, jnp.asarray(c),
                                   jnp.asarray(e))
    gp, gc, ge = vjp((jnp.ones_like(loss_j), jnp.zeros_like(acc_j)))

    ct = torch.from_numpy(c).requires_grad_(True)
    et = torch.from_numpy(e).requires_grad_(True)
    loss, acc = crit(ct, et, negative_indices=torch.from_numpy(neg),
                     quality=None if quality is None
                     else torch.from_numpy(quality))
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(loss_j),
                               err_msg="losses", **FWD)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(gc),
                               err_msg="dc", **GRAD)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(ge),
                               err_msg="de", **GRAD)
    grads = state_dict_from_jax(_np(gp))
    assert set(grads) == {n for n, _ in crit.named_parameters()}
    for name, p in crit.named_parameters():
        _close_sums(p.grad, grads[name].numpy(), name)


@pytest.mark.parametrize("mode", MODES)
def test_head_matches_jax(mode):
    c, e, neg = _inputs()
    jcrit, params = _jax_criterion(mode, c, e)
    crit = _port_criterion(mode, params)
    hold_criterion(jcrit, params, crit, c, e, neg)

    # the keys, shapes and values the JAX package's writer gives
    ref = params_to_torch_state_dict(
        params, rnn_mode="transformer" if mode == "multihead" else mode)
    ours = crit.state_dict()
    assert set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), value.numpy(),
                                      err_msg=key)
    # and the optimizer's leaf order of the JAX tree
    order = jax_param_order({"criterion": crit})
    flat = jax.tree_util.tree_flatten_with_path({"criterion": params})[0]
    assert [(tuple(k.key for k in path), tuple(v.shape))
            for path, v in flat] == order


def test_multihead_runs_one_ffn():
    """The K heads share one FFN call of width dim_ar -> 2048 -> K x
    dim_ar (the kernel's only launch a step on the card)."""
    from cpc2_torch.ops import ffn
    calls = []
    plain = ffn.ffn_plain

    def spy(x, w1, *rest, **kw):
        calls.append((tuple(x.shape), tuple(w1.shape), tuple(rest[1].shape)))
        return plain(x, w1, *rest, **kw)
    c, e, neg = _inputs()
    crit = CPCUnsupervisedCriterion(K, D, D, N, size_input_seq=S,
                                    multihead_rnn=True)
    ffn.ffn_plain = spy
    try:
        crit(torch.from_numpy(c), torch.from_numpy(e),
             negative_indices=torch.from_numpy(neg))
    finally:
        ffn.ffn_plain = plain
    assert calls == [((B * (S - K), D), (2048, D), (K * D, 2048))]


def test_rnn_head_scans_the_batch_axis():
    """The JAX package's RNN head (like the reference's `nn.RNN` without
    `batch_first`) scans (B, W, C) over its first axis: the first batch
    element's predictions do not see the second's context, the second's
    see the first's, and every frame is independent of the others."""
    c, e, neg = _inputs()
    crit = CPCUnsupervisedCriterion(K, D, D, N, size_input_seq=S,
                                    rnn_mode="RNN").eval()
    ct = torch.from_numpy(c)
    base = crit.wPrediction(ct[:, :S - K])
    moved = ct.clone()
    moved[1] += 1.0
    out = crit.wPrediction(moved[:, :S - K])
    torch.testing.assert_close(out[0], base[0], rtol=0, atol=0)
    assert not torch.equal(out[1], base[1])
    moved = ct.clone()
    moved[0, 3] += 1.0
    out = crit.wPrediction(moved[:, :S - K])
    changed = (out != base).any(dim=-1).any(dim=1)          # (B, W)
    assert changed[:, 3].all() and changed.sum() == B


def test_adaptive_span_is_the_linear_head():
    """`transformer_adaptive_span` builds the linear head, as the JAX
    package does (it has no adaptive span): the same keys, and the same
    losses from the same weights."""
    c, e, neg = _inputs()
    span = CPCUnsupervisedCriterion(K, D, D, N, size_input_seq=S,
                                    rnn_mode="transformer_adaptive_span")
    linear = CPCUnsupervisedCriterion(K, D, D, N, size_input_seq=S,
                                      rnn_mode="linear")
    assert set(span.state_dict()) == set(linear.state_dict()) == {
        f"wPrediction.predictors.{k}.weight" for k in range(K)}
    linear.load_state_dict(span.state_dict())
    args = (torch.from_numpy(c), torch.from_numpy(e))
    neg_t = torch.from_numpy(neg)
    assert torch.equal(span(*args, negative_indices=neg_t)[0],
                       linear(*args, negative_indices=neg_t)[0])


@pytest.mark.parametrize("layer", ["normalization", "upscale2d", "linear",
                                   "conv1d"])
def test_custom_layers_match_jax(layer):
    """The equalized layers' forward and gradients through
    `state_dict_from_jax`, `NormalizationLayer` and `upscale2d` (which no
    head runs) against `cpc2_tpu/losses/custom_layers.py`."""
    from cpc2_tpu.losses import custom_layers as jcl
    from cpc2_torch.losses import custom_layers as tcl
    rs = np.random.RandomState(3)
    if layer == "normalization":
        x = rs.randn(B, 6, S).astype(np.float32)
        np.testing.assert_allclose(
            tcl.NormalizationLayer()(torch.from_numpy(x)).numpy(),
            np.asarray(jcl.NormalizationLayer().apply({}, jnp.asarray(x))),
            **FWD)
        return
    if layer == "upscale2d":
        x = rs.randn(B, 3, 4, 5).astype(np.float32)
        for factor in (1, 2, 3):
            np.testing.assert_array_equal(
                tcl.upscale2d(torch.from_numpy(x), factor).numpy(),
                np.asarray(jcl.upscale2d(jnp.asarray(x), factor)))
        with pytest.raises(AssertionError):
            tcl.upscale2d(torch.from_numpy(x), 0)
        return
    x = rs.randn(B, S, D).astype(np.float32)
    if layer == "linear":
        jmod, port = jcl.EqualizedLinear(features=24), tcl.EqualizedLinear(
            D, 24)
    else:
        jmod = jcl.EqualizedConv1d(features=24, kernel_size=3,
                                   padding=(2, 0))
        port = tcl.EqualizedConv1d(D, 24, 3, padding=(2, 0))
    params = _np(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))["params"]
    params["bias"] = rs.randn(24).astype(np.float32)
    wrapped = {"module": params}
    port.load_state_dict(state_dict_from_jax(wrapped))

    def jloss(p, xx):
        return jnp.sum(jnp.sin(jmod.apply({"params": p}, xx)))

    (jval, (jgrad, jgx)) = (jloss(params, jnp.asarray(x)), jax.grad(
        jloss, argnums=(0, 1))(params, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt) if layer == "linear" else port(
        xt.transpose(1, 2)).transpose(1, 2)
    loss = torch.sin(out).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), **FWD)
    _close_sums(xt.grad, jgx, "x")
    _close_sums(port.module.weight.grad, jgrad["weight"], "weight")
    _close_sums(port.module.bias.grad, jgrad["bias"], "bias")
