"""`--adam_mu_dtype bf16` on the CPU: `cpc2_torch.optim.AdamBF16Moment`
(its plain version `adam_bf16_plain`, which the kernel of `csrc/adam.cu`
follows) against the JAX package's optimizer, its state dicts, a resume
across the two moment dtypes, and the trainer's CLI run, resumed, with
both bf16 flags.

The JAX package's Adam is `optax.inject_hyperparams(optax.adam)(...,
mu_dtype=bfloat16)` (`cpc2_tpu/training.py:make_optimizer`), whose
injected b1 is an fp32 array: `b1 * mu` is taken in fp32 and mu rounded
once when stored. (`optax.adam(mu_dtype=bfloat16)` alone takes b1 as a
weak-typed float and rounds it to bf16's 0.8984375 for `b1 * mu`: a
different optimizer, which the port does not follow.)
"""

import argparse
import io
import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cpc2_tpu.training import make_optimizer as jax_make_optimizer
from cpc2_torch.optim import AdamBF16Moment, adam_bf16_plain
from cpc2_torch.train import main
from cpc2_torch.training import make_optimizer

torch.set_num_threads(1)

SHAPES = ((64, 64), (64,), (3, 64, 5), (1,))
LR, B1, B2, EPS = 2e-4, 0.9, 0.999, 1e-8


def _args(mu_dtype="bf16", optimizer="adam"):
    return argparse.Namespace(optimizer=optimizer, learningRate=LR,
                              beta1=B1, beta2=B2, epsilon=EPS,
                              adam_mu_dtype=mu_dtype)


def _draws(seed=0, steps=5):
    """Parameters of width 64, and gradients over six decades of scale."""
    rs = np.random.RandomState(seed)
    params = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[(rs.randn(*s) * 10.0 ** rs.uniform(-6, 0)).astype(np.float32)
              for s in SHAPES] for _ in range(steps)]
    return params, grads


def _port(params, grads, opt=None):
    """Steps on `grads` from new leaves holding `params`, or with `opt`
    over its own parameters."""
    if opt is None:
        leaves = [torch.from_numpy(p.copy()).requires_grad_(True)
                  for p in params]
        opt = AdamBF16Moment(leaves, lr=LR, betas=(B1, B2), eps=EPS)
    leaves = opt.param_groups[0]["params"]
    for g in grads:
        for p, x in zip(leaves, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    return leaves, opt


def test_adam_bf16_moment_matches_the_jax_optimizer():
    """Five steps against the JAX package's optimizer on the same
    gradients: the stored bf16 mu and the fp32 nu equal in every entry, the
    parameters within rtol 1e-5 (the bias corrections' powers and quotients
    in another order), the counts 5."""
    params, grads = _draws()
    tx = jax_make_optimizer(_args())
    pj = [jnp.asarray(p) for p in params]
    state = tx.init(pj)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, pj)
        pj = optax.apply_updates(pj, updates)
    inner = state.inner_state[0]
    leaves, opt = _port(params, grads)
    for p, want_p, mu, nu in zip(leaves, pj, inner.mu, inner.nu):
        st = opt.state[p]
        assert st["exp_avg"].dtype == torch.bfloat16
        np.testing.assert_array_equal(st["exp_avg"].float().numpy(),
                                      np.asarray(mu.astype(jnp.float32)))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(nu))
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want_p),
                                   rtol=1e-5, atol=0)
        assert st["step"].item() == 5


def test_plain_update_is_optax_arithmetic():
    """One `adam_bf16_plain` call from a nonzero state against the formula
    written out in float32 numpy, operation by operation."""
    rs = np.random.RandomState(3)
    p, g, nu = (rs.randn(257).astype(np.float32) for _ in range(3))
    nu = np.abs(nu)
    mu = torch.from_numpy(rs.randn(257).astype(np.float32)).to(
        torch.bfloat16)
    step = torch.tensor(7.0)
    tp, tmu, tnu = torch.from_numpy(p.copy()), mu.clone(), torch.from_numpy(
        nu.copy())
    adam_bf16_plain([tp], [torch.from_numpy(g)], [tmu], [tnu], [step], LR,
                    B1, B2, EPS)
    f = np.float32
    b1, b2 = f(B1), f(B2)
    m = (f(1) - b1) * g + b1 * mu.float().numpy()
    v = (f(1) - b2) * (g * g) + b2 * nu
    bc1, bc2 = f(1) - b1 ** f(7), f(1) - b2 ** f(7)
    want = p + ((m / bc1) / (np.sqrt(v / bc2) + f(EPS))) * -f(LR)
    np.testing.assert_array_equal(tmu.float().numpy(), torch.from_numpy(
        m).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(tnu.numpy(), v)
    np.testing.assert_allclose(tp.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("mu_dtype,kind", [("bf16", AdamBF16Moment),
                                           ("fp32", torch.optim.Adam)])
def test_make_optimizer_takes_the_moment_dtype(mu_dtype, kind):
    opt = make_optimizer(_args(mu_dtype), [torch.zeros(3,
                                                       requires_grad=True)])
    assert type(opt) is kind
    assert opt.param_groups[0]["betas"] == (B1, B2)


def test_state_dict_round_trip_resumes_bit_for_bit():
    """Two steps, the state dict through `torch.save` (exp_avg saved as
    bf16), three more from it, equal bit for bit to five straight."""
    params, grads = _draws(1)
    whole, _ = _port(params, grads)
    part, opt = _port(params, grads[:2])
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    assert all(s["exp_avg"].dtype == torch.bfloat16
               for s in saved["state"].values())
    resumed = [p.detach().clone().requires_grad_(True) for p in part]
    again = AdamBF16Moment(resumed, lr=LR, betas=(B1, B2), eps=EPS)
    again.load_state_dict(saved)
    _port(None, grads[2:], again)
    for a, b in zip(whole, resumed):
        assert torch.equal(a, b)


def test_a_resume_under_the_other_moment_dtype_casts_exp_avg():
    """AdamBF16Moment's state into torch's Adam: exp_avg the same values
    in fp32; torch's Adam's into AdamBF16Moment: exp_avg rounded to bf16;
    nu and the counts as they were."""
    params, grads = _draws(2, steps=2)
    leaves, opt = _port(params, grads)
    adam = torch.optim.Adam([p.detach().clone() for p in leaves], lr=LR)
    adam.load_state_dict(opt.state_dict())
    for p, q in zip(leaves, adam.param_groups[0]["params"]):
        a, b = opt.state[p], adam.state[q]
        assert b["exp_avg"].dtype == torch.float32
        assert torch.equal(b["exp_avg"], a["exp_avg"].float())
        assert torch.equal(b["exp_avg_sq"], a["exp_avg_sq"])

    fp32 = [torch.from_numpy(p.copy()).requires_grad_(True) for p in params]
    adam = torch.optim.Adam(fp32, lr=LR)
    for p, x in zip(fp32, grads[0]):
        p.grad = torch.from_numpy(x)
    adam.step()
    bf = AdamBF16Moment([p.detach().clone() for p in fp32], lr=LR)
    bf.load_state_dict(adam.state_dict())
    for p, q in zip(fp32, bf.param_groups[0]["params"]):
        assert bf.state[q]["exp_avg"].dtype == torch.bfloat16
        assert torch.equal(bf.state[q]["exp_avg"],
                           adam.state[p]["exp_avg"].to(torch.bfloat16))
        assert bf.state[q]["step"].item() == 1


def _train_argv(corpus, ck, *extra):
    return ["--pathDB", str(corpus), "--file_extension", ".wav",
            "--device", "cpu", "--pathCheckpoint", str(ck),
            "--hiddenEncoder", "16", "--hiddenGar", "16", "--nPredicts", "3",
            "--negativeSamplingExt", "4", "--sizeWindow", "3840",
            "--batchSizeGPU", "4", "--random_seed", "5", "--logging_step",
            "100", "--n_process_loader", "1", "--save_step", "1",
            "--precision", "bf16", "--adam_mu_dtype", "bf16", *extra]


def test_cli_bf16_trains_and_resumes_bit_for_bit(mini_corpus, tmp_path):
    """`python -m cpc2_torch.train --precision bf16 --adam_mu_dtype bf16`
    on the CPU: its checkpoints keep exp_avg in bf16 and the flags in
    `checkpoint_args.json`, and one epoch resumed to two equals two straight
    epochs bit for bit (weights, criterion, Adam's state, generator)."""
    whole, split = tmp_path / "whole", tmp_path / "split"
    main(_train_argv(mini_corpus, whole, "--nEpoch", "2"))
    main(_train_argv(mini_corpus, split, "--nEpoch", "1"))
    main(_train_argv(mini_corpus, split, "--nEpoch", "2"))
    saved = json.loads((split / "checkpoint_args.json").read_text())
    assert saved["precision"] == "bf16" and saved["adam_mu_dtype"] == "bf16"
    a = torch.load(whole / "checkpoint_1.pt", weights_only=True)
    b = torch.load(split / "checkpoint_1.pt", weights_only=True)
    assert all(s["exp_avg"].dtype == torch.bfloat16
               for s in a["optimizer"]["state"].values())
    for part in ("gEncoder", "cpcCriterion", "best"):
        assert a[part].keys() == b[part].keys()
        for key in a[part]:
            assert torch.equal(a[part][key], b[part][key]), (part, key)
    for i, st in a["optimizer"]["state"].items():
        for key, value in st.items():
            assert torch.equal(value, b["optimizer"]["state"][i][key]), (
                i, key)
    assert torch.equal(a["optimizer"]["generator_state"],
                       b["optimizer"]["generator_state"])

