"""The port's criterion and model modes against the JAX package's on the
CPU: `--cpc_mode reverse`, `none` and `bert`, `--mask_prob` and
`--signal_quality_path` (the last two together), each as one whole
training step at tiny widths
(sizeWindow 3,200 -> 20 frames, width 32, nPredicts 4, 8 negatives, batch
2, linear prediction heads, no dropout), from the same weights, batch,
masks, quality and negatives; the host's mask draws; and the signal-quality
windows of a tiny WAV corpus with its `.pt` files.

Both sides are built by their own packages' factories from one flag
namespace (`build_model`, `get_criterion`); the JAX step is the forward of
`cpc2_tpu/training.py:build_steps`, written out. Tolerances are
`tests/test_torch_step.py`'s: rtol 1e-4, atol 1e-6 for losses, gradients
and parameters after one Adam step (summed weight gradients with atol
1e-6 of the tensor's largest value), parameters whose JAX gradient is
below 1e-7 left out of the post-step comparison.
"""

import argparse
import copy
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cpc2_tpu import dispatch as jax_dispatch
from cpc2_tpu.data.dataset import AudioBatchData as JaxAudioBatchData
from cpc2_tpu.feature_loader import build_model as jax_build_model
from cpc2_tpu.models import cpc as jax_cpc
from cpc2_tpu.train import get_criterion as jax_get_criterion
from cpc2_tpu.training import create_train_state, make_optimizer as jax_opt
from cpc2_torch.config import parse_args
from cpc2_torch.data import AudioBatchData, find_all_seqs, save_wav
from cpc2_torch.feature_loader import build_model
from cpc2_torch.io import state_dict_from_jax
from cpc2_torch.models import cpc
from cpc2_torch.train import get_criterion, step_mask
from cpc2_torch.training import Trainer, make_optimizer

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-6)
B, WINDOW, D, K, N = 2, 3200, 32, 4, 8
S = WINDOW // 160


def _args(flags):
    return parse_args(["--pathDB", ".", "--file_extension", ".wav",
                       "--device", "cpu", "--sizeWindow", str(WINDOW),
                       "--hiddenEncoder", str(D), "--hiddenGar", str(D),
                       "--nPredicts", str(K), "--negativeSamplingExt",
                       str(N), "--batchSizeGPU", str(B), "--random_seed",
                       "0", "--rnnMode", "linear"] + flags)


def _close_sums(got, want, name):
    atol = 1e-6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol,
                               err_msg=name)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_step(args, batch, neg, mask, quality, monkeypatch):
    """One JAX training step: (params, grads, params after Adam, losses,
    accs). BERT's categorical draw is replaced by `neg` (B*S, N)."""
    args = copy.deepcopy(args)
    model = jax_build_model(args)
    crit = jax_get_criterion(args, 160, 2, None)
    bert = args.cpc_mode == "bert"
    model_vars = jax.jit(model.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((B, WINDOW)))
    label0 = jnp.zeros((B, S), jnp.int32) if bert else None
    crit_vars = jax.jit(lambda r, c, e: crit.init(r, c, e, label0,
                                                  train=False))(
        {"params": jax.random.PRNGKey(1), "negatives": jax.random.PRNGKey(2)},
        jnp.zeros((B, S, D)), jnp.zeros((B, S, D)))
    tx = jax_opt(argparse.Namespace(
        optimizer="adam", learningRate=2e-4, beta1=0.9, beta2=0.999,
        epsilon=1e-8, adam_mu_dtype="fp32"))
    state = create_train_state(model_vars, crit_vars, tx)
    if bert:
        monkeypatch.setattr(jax.random, "categorical",
                            lambda *a, **k: jnp.asarray(neg))
    rngs = {"negatives": jax.random.PRNGKey(5),
            "dropout": jax.random.PRNGKey(6)}
    q = None if quality is None else jnp.asarray(quality)

    def loss_fn(params):
        """The forward of `cpc2_tpu/training.py:build_steps`."""
        x = jnp.asarray(batch)
        combined = jnp.concatenate([x[:, 0, 0], x[:, 1, 0]], axis=0)
        mv = {"params": params["model"]}
        if bert:
            c, e, lab, _ = model.apply(mv, combined, None,
                                       mask_indices=jnp.asarray(mask))
            c, e, lab = c[:B], e[B:], lab[:B]
        else:
            encoded = model.apply(mv, combined,
                                  method=lambda m, z: m.gEncoder(z))
            ar_input = encoded[:B]
            if mask is not None:
                ar_input = jnp.where(jnp.asarray(mask)[:B][..., None],
                                     params["model"]["mask_emb"], ar_input)
            c, _ = model.apply(mv, ar_input, method=lambda m, z: m.gAR(z))
            e, lab = encoded[B:], None
        kw = {} if bert or args.cpc_mode == "none" else {
            "negative_indices": jnp.asarray(neg)}
        losses, accs = crit.apply({"params": params["criterion"]}, c, e,
                                  lab, q, rngs=rngs, **kw)
        return jnp.sum(losses), (losses, accs)

    @jax.jit
    def step(state):
        grads, (losses, accs) = jax.grad(loss_fn, has_aux=True)(state.params)
        updates, _ = tx.update(grads, state.opt_state, state.params)
        return grads, optax.apply_updates(state.params, updates), losses, accs

    grads, new_params, losses, accs = step(state)
    return (_np(state.params), _np(grads), _np(new_params),
            np.asarray(losses), np.asarray(accs))


def port_step(args, params, batch, neg, mask, quality):
    model, crit = build_model(copy.deepcopy(args)), get_criterion(args)
    model.load_state_dict(state_dict_from_jax(params["model"]))
    crit.load_state_dict(state_dict_from_jax(params.get("criterion", {})))
    named = dict(list(model.named_parameters(prefix="model"))
                 + list(crit.named_parameters(prefix="criterion")))
    optimizer = make_optimizer(args, named.values())
    trainer = Trainer(model, crit, optimizer)
    losses, accs = trainer.train_step(
        torch.from_numpy(batch), torch.from_numpy(neg),
        mask=None if mask is None else torch.from_numpy(mask),
        quality=None if quality is None else torch.from_numpy(quality))
    return named, optimizer, losses, accs


def _case(mode):
    rs = np.random.RandomState(0)
    batch = rs.randn(B, 2, 1, WINDOW).astype(np.float32)
    mask = quality = None
    if mode == "bert":
        np.random.seed(3)
        mask = cpc.compute_bert_mask((2 * B, S), 2, K)
        free = np.flatnonzero(~mask[:B].reshape(-1))
        neg = free[rs.randint(0, free.size, size=(B * S, N))].astype(np.int32)
    else:
        neg = rs.randint(0, B * S, size=(B, N, S - K)).astype(np.int32)
    if mode == "mask_quality":
        np.random.seed(4)
        mask = cpc.compute_mask_indices((2 * B, S), 0.005, 3, min_masks=2)
    if mode == "mask_quality":
        quality = rs.uniform(0, 1, size=(B, WINDOW // 1600)).astype(
            np.float32)
    return batch, neg, mask, quality


FLAGS = {"reverse": ["--cpc_mode", "reverse"],
         "none": ["--cpc_mode", "none"],
         "bert": ["--cpc_mode", "bert", "--arMode", "GRU"],
         "mask_quality": ["--mask_prob", "0.005", "--mask_length", "3",
                          "--growth_rate", "4", "--inflection_point_x",
                          "0.3"]}


@pytest.mark.parametrize("mode", list(FLAGS))
def test_step_matches_jax(mode, monkeypatch):
    args = _args(FLAGS[mode])
    batch, neg, mask, quality = _case(mode)
    params, grads, new_params, losses_j, accs_j = jax_step(
        args, batch, neg, mask, quality, monkeypatch)
    named, optimizer, losses, accs = port_step(args, params, batch, neg,
                                               mask, quality)
    np.testing.assert_allclose(losses.numpy(), losses_j, **TOL)
    np.testing.assert_array_equal(accs.numpy(), accs_j)

    def by_name(tree):
        return {f"{scope}.{k}": v for scope in ("model", "criterion")
                for k, v in state_dict_from_jax(tree.get(scope, {})).items()}
    ref_grads, ref_new = by_name(grads), by_name(new_params)
    assert set(named) == set(ref_grads)
    for name, p in named.items():
        g_ref = ref_grads[name].numpy()
        _close_sums(p.grad.numpy(), g_ref, name)
        moved = np.abs(g_ref) >= 1e-7
        np.testing.assert_allclose(p.detach().numpy()[moved],
                                   ref_new[name].numpy()[moved],
                                   err_msg=name, **TOL)
    if mode == "none":
        # a constant loss: zero gradients, Adam steps and moves nothing
        assert not losses.any() and not accs.any()
        for name, p in named.items():
            np.testing.assert_array_equal(p.detach().numpy(),
                                          ref_new[name].numpy())
            assert float(optimizer.state[p]["step"]) == 1.0
    else:
        assert sum(np.abs(g.numpy()).max() > 0
                   for g in ref_grads.values()) > 0.5 * len(ref_grads)
    if mode.startswith("mask"):
        assert np.abs(grads["model"]["mask_emb"]).max() > 0


def test_bert_pairs_the_past_context_with_the_future_encodings():
    """The JAX step (kept): the past half's context and mask against the
    future half's encodings; both halves' masked blocks are zeroed before
    the bidirectional context network. A change to the past view's
    encodings at a masked frame moves nothing."""
    args = _args(FLAGS["bert"])
    batch, neg, mask, _q = _case("bert")
    torch.manual_seed(0)
    model, crit = build_model(copy.deepcopy(args)), get_criterion(args)
    trainer = Trainer(model, crit, make_optimizer(
        args, list(model.parameters()) + list(crit.parameters())))
    seen = {}

    def spy(c, e, label, generator=None, negative_indices=None):
        seen.update(c=c, e=e, label=label)
        return torch.zeros((1, 1)), torch.zeros((1, 1))
    crit.forward = spy
    x = torch.from_numpy(batch)
    m = torch.from_numpy(mask)
    with torch.no_grad():
        trainer._forward(x, torch.from_numpy(neg), False, mask=m)
        encoded = model.encode(torch.cat([x[:, 0, 0], x[:, 1, 0]]))
        context, _ = model.gAR(torch.where(m[..., None], 0.0, encoded))
    torch.testing.assert_close(seen["e"], encoded[B:], rtol=0, atol=0)
    torch.testing.assert_close(seen["c"], context[:B], rtol=0, atol=0)
    assert torch.equal(seen["label"], m[:B])


@pytest.mark.parametrize("flags", [["--mask_prob", "0.005", "--mask_length",
                                    "3"], ["--cpc_mode", "bert"]])
def test_host_masks_match_jax(flags):
    """For one numpy seed, the masks the loader side draws for a batch
    (2 x batch rows) equal `cpc2_tpu/dispatch.py:stack_batch`'s."""
    args = _args(flags)
    full = (np.zeros((B, 2, 1, WINDOW), np.float32), np.zeros(B, np.int64))
    got, want = [], []
    for seed in (0, 1):
        np.random.seed(seed)
        got.append(step_mask(args, B))
        np.random.seed(seed)
        want.append(jax_dispatch.stack_batch(full, S, args, True)[3])
    for g, w in zip(got, want):
        assert g.shape == (2 * B, S) and g.dtype == bool
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], got[1])
    np.random.seed(7)
    a = cpc.compute_mask_indices((6, 40), 0.01, 5, min_masks=2)
    np.random.seed(7)
    np.testing.assert_array_equal(
        a, jax_cpc.compute_mask_indices((6, 40), 0.01, 5, min_masks=2))


def test_mask_emb():
    """`--mask_prob` gives the model `mask_emb` (dim,), drawn from U[0, 1)
    like the JAX package's (its key and gradient are held in
    `test_step_matches_jax[mask_quality]`); the model's forward (features)
    masks nothing."""
    args = _args(FLAGS["mask_quality"])
    model = build_model(copy.deepcopy(args))
    emb = model.mask_emb.detach()
    assert emb.shape == (D,) and 0 <= emb.min() and emb.max() < 1
    assert "mask_emb" in model.state_dict()
    x = torch.randn(B, WINDOW)
    c, e, _ = model(x)
    torch.testing.assert_close(e, model.encode(x), rtol=0, atol=0)


@pytest.fixture(scope="module")
def quality_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("qdb")
    qdir = tmp_path_factory.mktemp("quality")
    rs = np.random.RandomState(0)
    for spk in ("a", "b"):
        (root / spk / "c").mkdir(parents=True)
        (qdir / spk / "c").mkdir(parents=True)
        for i in range(2):
            n = 32000 + 800 * i       # a tail beyond the last estimate
            x = (0.2 * np.sin(np.arange(n) * 0.04)
                 + 0.05 * rs.randn(n)).astype(np.float32)
            save_wav(str(root / spk / "c" / f"{spk}-{i}.wav"), x, 16000)
            n_est = 32000 // 1600
            torch.save([torch.from_numpy(rs.uniform(0, 30, (n_est, 1))
                                         .astype(np.float32)),
                        torch.from_numpy(rs.uniform(0, 60, (n_est, 1))
                                         .astype(np.float32))],
                       str(qdir / spk / "c" / f"{spk}-{i}.pt"))
    (qdir / "min_max.csv").write_text(
        "min_snr,max_snr,min_c50,max_c50\n0,30,0,60\n")
    return root, qdir


@pytest.mark.parametrize("mode", ["snr", "c50", "snr_c50"])
def test_quality_windows_match_jax(quality_corpus, mode):
    """The corpus's windows and their quality estimates, batch by batch
    and offset by offset, equal the JAX package's loader's."""
    root, qdir = quality_corpus
    seqs, speakers = find_all_seqs(str(root), extension=".wav",
                                   loadCache=False)
    kw = dict(nProcessLoader=1, signal_quality_path=str(qdir),
              signal_quality_step=1600, signal_quality_mode=mode)
    random.seed(0)
    ours = AudioBatchData(str(root), 3200, seqs, None, len(speakers), **kw)
    random.seed(0)
    ref = JaxAudioBatchData(str(root), 3200, seqs, None, len(speakers), **kw)
    try:
        np.testing.assert_array_equal(ours.data, ref.data)
        np.testing.assert_array_equal(ours.data_quality, ref.data_quality)
        idx = [0, 1600, 4800, 30000]
        got, want = ours.get_batch(idx), ref.get_batch(idx)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[2].shape == (4, 2) and 0 <= got[2].min() <= 1
        for g, w in zip(ours.get_batch_meta(idx), ref.get_batch_meta(idx)):
            np.testing.assert_array_equal(g, w)
    finally:
        ours.close()
