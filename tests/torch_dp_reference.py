"""The JAX package's data-parallel step at the port's tests' tiny
configuration (`tests/torch_ranks.py`): `cpc2_tpu.training.build_steps` on
a mesh of the forced CPU devices, with the negatives given per device
(`sample_negative_indices` patched to read device `axis_index('data')`'s
table) and the weights carried to the port by `state_dict_from_jax`."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from cpc2_tpu import feature_loader as fl
from cpc2_tpu.config import get_default_cpc_config
from cpc2_tpu.losses import criterion as jax_criterion
from cpc2_tpu.parallel.mesh import make_mesh, shard_batch
from cpc2_tpu.train import get_criterion, init_criterion_vars
from cpc2_tpu.training import build_steps, create_train_state, make_optimizer
from cpc2_torch.io import state_dict_from_jax

from torch_ranks import K, N, WIDTH, WINDOW


def setup(world: int, norm_mode: str = "layerNorm",
          global_negatives: bool = False):
    args = get_default_cpc_config()
    args.hiddenEncoder = args.hiddenGar = WIDTH
    args.nPredicts, args.negativeSamplingExt = K, N
    args.sizeWindow, args.rnnMode, args.arMode = WINDOW, "linear", "LSTM"
    args.normMode, args.global_negatives = norm_mode, global_negatives
    args.random_seed = 0
    mesh = make_mesh(world)
    # `init_model` and `init_criterion_vars` under one `jit` each: the
    # same values as their eager op-by-op inits, compiled in a third of
    # the time
    bundle = fl.ModelBundle(
        module=fl.build_model(args),
        variables=jax.jit(lambda: fl.init_model(args, seed=0).variables)(),
        args=args, hidden_gar=WIDTH, hidden_encoder=WIDTH)
    criterion = get_criterion(args, 160, n_speakers=4, n_phones=None,
                              pool_axis_size=world if global_negatives
                              else 1)
    crit_vars = jax.jit(lambda: init_criterion_vars(criterion, args,
                                                    bundle))()
    tx = make_optimizer(args)
    state = create_train_state(jax.tree.map(jnp.array, bundle.variables),
                               jax.tree.map(jnp.array, crit_vars), tx)
    return args, mesh, bundle, criterion, tx, state


def port_state(params, batch_stats, norm_mode):
    """The JAX tree as the port's {model.*, criterion.*} state dicts."""
    model = state_dict_from_jax(
        params["model"], (batch_stats or {}).get("model"),
        norm_mode=norm_mode)
    crit = state_dict_from_jax(params["criterion"])
    return ({k: v.numpy() for k, v in model.items()},
            {k: v.numpy() for k, v in crit.items()})


def prepare(world, norm_mode="layerNorm", global_negatives=False):
    """The JAX setup (`setup`) and its weights as the port's state dicts
    (model, criterion), which the ranks can start from while `run` runs
    JAX's steps."""
    ctx = setup(world, norm_mode, global_negatives)
    state = ctx[-1]
    return port_state(jax.tree.map(np.asarray, state.params),
                      jax.tree.map(np.asarray, state.batch_stats),
                      norm_mode), ctx


def run(ctx, batches, neg_table, valid=None, monkeypatch=None):
    """`build_steps`' train step of `prepare`'s `ctx` on each global
    batch, every device drawing `neg_table[device]` (B_local, N, W).
    Returns each step's (losses, accs), the state dicts after, and the
    first step's gradients by port name (from Adam's first moment: mu =
    (1 - b1) g)."""
    args, mesh, bundle, criterion, tx, state = ctx
    norm_mode = args.normMode
    table = jnp.asarray(np.asarray(neg_table, np.int32))
    real = jax_criterion.sample_negative_indices

    def given(*a, **k):
        try:
            return table[jax.lax.axis_index("data")]
        except NameError:           # traced outside the mesh: an init
            return real(*a, **k)
    monkeypatch.setattr(jax_criterion, "sample_negative_indices", given)
    step, _ = build_steps(bundle.module, criterion, tx, mesh,
                          example_weighted=valid is not None)
    key = jax.random.PRNGKey(0)
    out, grads = [], None
    for i, batch in enumerate(batches):
        b = batch.shape[0]
        lab = np.zeros((b,), np.int32)
        if valid is None:
            xb, lb = shard_batch(mesh, batch, lab)
            extra = ()
        else:
            xb, lb, vb = shard_batch(mesh, batch, lab,
                                     np.asarray(valid[i], np.float32))
            extra = (vb,)
        state, losses, accs = step(state, xb, lb, key, *extra)[:3]
        if grads is None:
            mu = state.opt_state.inner_state[0].mu
            g = jax.tree.map(lambda m: np.asarray(m) / (1 - args.beta1), mu)
            gm, gc = port_state(g, None, norm_mode)
            grads = {**{f"model.{k}": v for k, v in gm.items()},
                     **{f"criterion.{k}": v for k, v in gc.items()}}
        out.append((np.asarray(losses), np.asarray(accs)))
    after_m, after_c = port_state(jax.tree.map(np.asarray, state.params),
                                  jax.tree.map(np.asarray,
                                               state.batch_stats), norm_mode)
    after = {**{f"model.{k}": v for k, v in after_m.items()},
             **{f"criterion.{k}": v for k, v in after_c.items()}}
    return out, after, grads
