"""Checkpoints of the model and criterion modes across the two packages on
the CPU, at width 16 and 20 frames: for each family of new keys (the `ffd`
and `conv8` heads' `.module` wrappers, `--multihead_rnn`'s unstacked
`predictor`, `--cpc_mode bert`'s `_reverse` GRU and `wPrediction`,
`--encoder_type lfb`'s `conv`, `--mask_prob`'s `mask_emb`; `reverse` and
`mfcc` add none) a checkpoint the JAX package writes loads
in the port's `feature_loader.load_model` and criterion (every key, no
other), and the one the port then writes loads in the JAX package's
reader, `params_from_torch_state_dict(strict=True)` (what its `load_model`
runs on the saved state dicts), with no key left over; the features
of both loads agree with the model that wrote them (rtol 1e-5, atol 1e-6
of the largest magnitude: fp32 reordering), and every weight comes back
bit for bit.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpc2_tpu import feature_loader as jax_fl
from cpc2_tpu.io.checkpoint import save_args as jax_save_args
from cpc2_tpu.io.torch_ckpt import (params_from_torch_state_dict,
                                    params_to_torch_state_dict)
from cpc2_tpu.io.torch_ckpt import save_checkpoint as jax_save_checkpoint
from cpc2_tpu.train import get_criterion as jax_get_criterion
from cpc2_torch import feature_loader as fl
from cpc2_torch.config import parse_args
from cpc2_torch.io import load_torch_checkpoint, save_args, save_checkpoint
from cpc2_torch.train import get_criterion

torch.set_num_threads(1)

WIDTH, WINDOW = 16, 3200
FAMILIES = {"ffd": ["--rnnMode", "ffd"], "conv8": ["--rnnMode", "conv8"],
            "multihead": ["--multihead_rnn"],
            "bert": ["--cpc_mode", "bert"],
            "lfb": ["--encoder_type", "lfb"],
            "mask": ["--mask_prob", "0.005", "--mask_length", "3"]}


def _close(got, want, name):
    want = np.asarray(want)
    atol = 1e-6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=atol,
                               err_msg=name)


def _context_of(module):
    """The JAX model's context on a batch, one compile for both calls."""
    apply = jax.jit(lambda p, xx: module.apply({"params": p}, xx, None,
                                               train=False)[0])
    return lambda params, x: np.asarray(apply(params, jnp.asarray(x)))


def _bit_for_bit(got, want):
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert set(got) == set(want)
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value, err_msg=str(path))


def _run_dir(path, write, args, writer_args):
    path.mkdir()
    write(str(path / "checkpoint_0.pt"))
    writer_args(args, str(path / "checkpoint_args.json"))
    (path / "checkpoint_logs.json").write_text("{}")
    return str(path / "checkpoint_0.pt")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_checkpoint_loads_across_packages(family, tmp_path):
    args = parse_args(["--pathDB", ".", "--file_extension", ".wav",
                       "--device", "cpu", "--hiddenEncoder", str(WIDTH),
                       "--hiddenGar", str(WIDTH), "--nPredicts", "3",
                       "--negativeSamplingExt", "4", "--sizeWindow",
                       str(WINDOW), "--random_seed", "0"] + FAMILIES[family])
    jargs = copy.deepcopy(args)
    module = jax_fl.build_model(jargs)
    jcrit = jax_get_criterion(jargs, 160, 2, None)
    x = np.random.RandomState(0).randn(2, WINDOW).astype(np.float32)
    model_params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r, xx: module.init(r, xx, None, train=False))(
            jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    frames = WINDOW // 160
    label = (jnp.zeros((2, frames), jnp.int32) if args.cpc_mode == "bert"
             else None)
    crit_params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r, c, e: jcrit.init(r, c, e, label, train=False))(
            {"params": jax.random.PRNGKey(1),
             "negatives": jax.random.PRNGKey(2)},
            jnp.zeros((2, frames, WIDTH)),
            jnp.zeros((2, frames, WIDTH)))["params"])
    context = _context_of(module)
    c_jax = context(model_params, x)

    def write_jax(path):
        jax_save_checkpoint(
            params_to_torch_state_dict(model_params,
                                       norm_mode=args.normMode),
            params_to_torch_state_dict(crit_params, rnn_mode=args.rnnMode),
            {}, None, path)
    path = _run_dir(tmp_path / "jax", write_jax, jargs, jax_save_args)

    # the JAX package's checkpoint in the port
    model = fl.load_model([path])[0].eval()
    crit = get_criterion(args)
    crit.load_state_dict(load_torch_checkpoint(path)["cpcCriterion"])
    with torch.no_grad():
        c_port = model(torch.from_numpy(x))[0].numpy()
    _close(c_port, c_jax, f"{family}: port features of the JAX checkpoint")

    # the port's checkpoint in the JAX package
    def write_port(path):
        save_checkpoint(model.state_dict(), crit.state_dict(), {}, None,
                        path)
    path = _run_dir(tmp_path / "port", write_port, args, save_args)
    saved = load_torch_checkpoint(path)
    params, _stats, unmatched = params_from_torch_state_dict(
        saved["gEncoder"], model_params, strict=True)
    _bit_for_bit(params, model_params)
    _close(context(params, x), c_port,
           f"{family}: JAX features of the port's checkpoint")
    params, _stats, unmatched = params_from_torch_state_dict(
        saved["cpcCriterion"], crit_params, strict=True)
    _bit_for_bit(params, crit_params)
