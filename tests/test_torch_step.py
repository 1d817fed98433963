"""One whole training step of the port against the JAX package's on the
CPU: a tiny configuration (sizeWindow 3,840 -> 24 frames, width 32,
nPredicts 3, 8 negatives, batch 2), dropout off, the same weights and the
same negatives. It checks the per-head losses and accuracies, every
gradient, and the parameters after one Adam step.

Tolerances: rtol 1e-4, atol 1e-6 for losses, gradients and parameters,
except where stated. Parameters whose JAX gradient is below 1e-7 in
magnitude are left out of the post-step comparison: Adam's first step is
lr * g / (|g| + eps), so there it is +-lr times the sign of a rounding
error.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from cpc2_tpu.losses.criterion import (
    CPCUnsupervisedCriterion as JaxCriterion)
from cpc2_tpu.models.ar import CPCAR as JaxCPCAR
from cpc2_tpu.models.cpc import CPCModel as JaxCPCModel
from cpc2_tpu.models.encoder import CPCEncoder as JaxCPCEncoder
from cpc2_tpu.training import create_train_state, make_optimizer as jax_opt
from cpc2_torch.config import parse_args
from cpc2_torch.feature_loader import build_model
from cpc2_torch.io import state_dict_from_jax
from cpc2_torch.train import get_criterion
from cpc2_torch.training import Trainer, make_optimizer

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-6)


def _close_sums(got, want, name):
    """Weight gradients summed over the batch, frames and heads: an element
    that cancels to near zero keeps the absolute rounding of the tensor's
    larger terms, so atol is 1e-6 times the tensor's largest magnitude
    (when that exceeds 1)."""
    atol = 1e-6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol,
                               err_msg=name)

B, WINDOW, WIDTH, K, N = 2, 3840, 32, 3, 8
FRAMES = WINDOW // 160


def _jax_step(batch, neg):
    encoder = JaxCPCEncoder(size_hidden=WIDTH, norm_mode="layerNorm")
    model = JaxCPCModel(gEncoder=encoder,
                        gAR=JaxCPCAR(WIDTH, WIDTH, mode="LSTM"))
    crit = JaxCriterion(n_predicts=K, dim_ar=WIDTH, dim_enc=WIDTH,
                        negative_sampling_ext=N, rnn_mode="transformer",
                        size_input_seq=FRAMES)
    model_vars = jax.jit(model.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((B, WINDOW)))
    crit_vars = jax.jit(lambda rngs, c, e: crit.init(rngs, c, e, None,
                                                      train=False))(
        {"params": jax.random.PRNGKey(1), "negatives": jax.random.PRNGKey(2)},
        jnp.zeros((B, FRAMES, WIDTH)), jnp.zeros((B, FRAMES, WIDTH)))
    args = argparse.Namespace(optimizer="adam", learningRate=2e-4, beta1=0.9,
                              beta2=0.999, epsilon=1e-8, adam_mu_dtype="fp32")
    tx = jax_opt(args)
    state = create_train_state(model_vars, crit_vars, tx)

    # the forward of `cpc2_tpu/training.py:build_steps`, dropout off
    def loss_fn(params):
        x = jnp.asarray(batch)
        combined = jnp.concatenate([x[:, 0, 0], x[:, 1, 0]], axis=0)
        encoded = model.apply({"params": params["model"]}, combined,
                              method=lambda m, z: m.gEncoder(z))
        c, _ = model.apply({"params": params["model"]}, encoded[:B],
                           method=lambda m, z: m.gAR(z))
        losses, accs = crit.apply({"params": params["criterion"]}, c,
                                  encoded[B:], None, train=False,
                                  negative_indices=jnp.asarray(neg))
        return jnp.sum(losses), (losses, accs)

    @jax.jit
    def step(state):
        grads, (losses, accs) = jax.grad(loss_fn, has_aux=True)(state.params)
        updates, _ = tx.update(grads, state.opt_state, state.params)
        return grads, optax.apply_updates(state.params, updates), losses, accs

    grads, new_params, losses, accs = step(state)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (to_np(state.params), to_np(grads), to_np(new_params),
            np.asarray(losses), np.asarray(accs))


def test_training_step_matches_jax():
    rs = np.random.RandomState(0)
    batch = rs.randn(B, 2, 1, WINDOW).astype(np.float32)
    neg = rs.randint(0, B * FRAMES, size=(B, N, FRAMES - K)).astype(np.int32)
    params, grads, new_params, losses_j, accs_j = _jax_step(batch, neg)

    args = parse_args(["--pathDB", ".", "--file_extension", ".wav",
                       "--device", "cpu", "--sizeWindow", str(WINDOW),
                       "--hiddenEncoder", str(WIDTH), "--hiddenGar",
                       str(WIDTH), "--nPredicts", str(K),
                       "--negativeSamplingExt", str(N), "--batchSizeGPU",
                       str(B), "--random_seed", "0"])
    model, crit = build_model(args), get_criterion(args)
    model.load_state_dict(state_dict_from_jax(params["model"]))
    crit.load_state_dict(state_dict_from_jax(params["criterion"]))
    # dropout off, as on the JAX side (its criterion runs with train=False)
    for mod in crit.modules():
        if hasattr(mod, "rate"):
            mod.rate = 0.0
    for layer in (h[0] for h in crit.wPrediction.predictors):
        layer.ffnetwork.dropout = 0.0
    named = dict(list(model.named_parameters(prefix="model"))
                 + list(crit.named_parameters(prefix="criterion")))
    trainer = Trainer(model, crit, make_optimizer(args, named.values()))
    losses, accs = trainer.train_step(torch.from_numpy(batch),
                                      torch.from_numpy(neg))

    np.testing.assert_allclose(losses.numpy(), losses_j, **TOL)
    np.testing.assert_array_equal(accs.numpy(), accs_j)
    ref_grads = {f"{scope}.{k}": v for scope in ("model", "criterion")
                 for k, v in state_dict_from_jax(grads[scope]).items()}
    ref_new = {f"{scope}.{k}": v for scope in ("model", "criterion")
               for k, v in state_dict_from_jax(new_params[scope]).items()}
    assert set(named) == set(ref_grads)
    n_moved = n_total = 0
    for name, p in named.items():
        g_ref = ref_grads[name].numpy()
        _close_sums(p.grad.numpy(), g_ref, name)
        moved = np.abs(g_ref) >= 1e-7
        n_moved, n_total = n_moved + moved.sum(), n_total + moved.size
        np.testing.assert_allclose(p.detach().numpy()[moved],
                                   ref_new[name].numpy()[moved],
                                   err_msg=name, **TOL)
    assert n_moved > 0.5 * n_total
