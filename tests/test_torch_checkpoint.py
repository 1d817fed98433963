"""Checkpoints and feature extraction of the port against the JAX package
on the CPU, at a tiny width (16).

A checkpoint that `cpc2_tpu` writes loads in `cpc2_torch.feature_loader.
load_model`, whose features (`build_feature_files`, the context network's
state carried across chunks) and ABX scores (`eval_ABX from_checkpoint`)
match the JAX package's, and several of them make one concatenated model;
a checkpoint the port's trainer writes loads in
`cpc2_tpu.feature_loader.load_model`; `python -m cpc2_torch.train
--pathCheckpoint` saves, resumes (bit for bit) and restarts, also from a
`cpc2_tpu` run directory, whose optax leaves become torch's optimizer
state; and `--profile_dir` writes one trace.

Tolerances: features rtol 1e-5, atol 1e-6 (fp32 reordering); ABX scores
atol 1e-5 (the same win counts over features that agree to 1e-6); one
optimizer step against optax's rtol 1e-5, atol 1e-6; a resumed run none.
"""

import argparse
import json

import numpy as np
import pytest
import torch

from cpc2_tpu import feature_loader as jax_fl
from cpc2_tpu.config import get_default_cpc_config as jax_default_config
from cpc2_tpu.data.audio_io import save_wav
from cpc2_tpu.eval import eval_ABX as jax_eval_abx
from cpc2_tpu.io.checkpoint import save_args as jax_save_args
from cpc2_tpu.io.torch_ckpt import params_to_torch_state_dict
from cpc2_tpu.io.torch_ckpt import save_checkpoint as jax_save_checkpoint
from cpc2_torch import feature_loader as fl
from cpc2_torch.config import parse_args
from cpc2_torch.eval import eval_ABX
from cpc2_torch.feature_loader import build_model
from cpc2_torch.io import save_logs
from cpc2_torch.io.from_jax import state_dict_from_jax
from cpc2_torch.models import ConcatenatedModel
from cpc2_torch.train import get_criterion, main

torch.set_num_threads(1)

FEATURES = dict(rtol=1e-5, atol=1e-6)
WIDTH = 16
SPEAKERS = ("s1", "s2", "s3")


@pytest.fixture(scope="module")
def phone_corpus(tmp_path_factory):
    """3 speakers x 2 wav files (9,600 and 8,000 samples: two length
    groups of 3 files) of two alternating tones, and an .item file of 4
    tokens per file."""
    root = tmp_path_factory.mktemp("ckpt_db")
    rs = np.random.RandomState(3)
    lines = ["#file onset offset #phone prev next speaker"]
    for s, spk in enumerate(SPEAKERS):
        (root / spk).mkdir()
        for i, n in enumerate((9600, 8000)):
            t = np.arange(n) / 16000.0
            f0 = np.where((t // 0.12) % 2 == 0, 220.0, 330.0) + 20 * s
            x = (0.3 * np.sin(2 * np.pi * f0 * t)
                 + 0.05 * rs.randn(n)).astype(np.float32)
            name = f"{spk}-{i}"
            save_wav(str(root / spk / f"{name}.wav"), x, 16000)
            for k in range(4):
                onset = 0.12 * k + 0.01
                lines.append(f"{name} {onset:.2f} {onset + 0.1:.2f} "
                             f"{('aa', 'bb')[k % 2]} p n {spk}")
    item = root.parent / "ckpt.item"
    item.write_text("\n".join(lines) + "\n")
    paths = sorted(str(p) for p in root.rglob("*.wav"))
    return root, item, paths


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX model's weights written as the JAX trainer writes them."""
    args = jax_default_config()
    args.hiddenEncoder = args.hiddenGar = WIDTH
    args.load = None
    bundle = jax_fl.init_model(args, seed=0)
    ck = tmp_path_factory.mktemp("jax_ck")
    jax_save_checkpoint(params_to_torch_state_dict(bundle.variables["params"],
                                                   norm_mode=args.normMode),
                        {}, {}, None, str(ck / "checkpoint_0.pt"))
    jax_save_args(args, str(ck / "checkpoint_args.json"))
    (ck / "checkpoint_logs.json").write_text("{}")
    return ck / "checkpoint_0.pt"


def _features(path, paths, jax_side, max_size_seq):
    """Features of the model of checkpoint `path` (or of a list of them,
    concatenated) by either package."""
    loads = [str(p) for p in path] if isinstance(path, list) else [str(path)]
    if jax_side:
        bundle = jax_fl.load_model(loads)[0]
        maker = jax_fl.FeatureModule(bundle, False, keep_hidden=True)
    else:
        model = fl.load_model(loads)[0]
        maker = fl.FeatureModule(model, False, keep_hidden=True)
    out = (jax_fl if jax_side else fl).build_feature_files(
        maker, paths, maxSizeSeq=max_size_seq)
    return {p: np.asarray(v) for p, v in out.items()}


def test_jax_checkpoint_features_match(jax_checkpoint, phone_corpus):
    """3 chunks of 3,200 samples (the last 1,600 or 3,200) per file, the
    LSTM state carried from chunk to chunk in batches of 3 files."""
    _root, _item, paths = phone_corpus
    got = _features(jax_checkpoint, paths, False, 3200)
    want = _features(jax_checkpoint, paths, True, 3200)
    assert set(got) == set(paths)
    for p in paths:
        assert got[p].shape == want[p].shape == (
            1, (9600 if p.endswith("-0.wav") else 8000) // 160, WIDTH)
        np.testing.assert_allclose(got[p], want[p], err_msg=p, **FEATURES)
    # one file on its own (state reset per file) matches the batched pass
    model = fl.load_model([str(jax_checkpoint)])[0]
    one = fl.build_feature(fl.FeatureModule(model, False, keep_hidden=True),
                           paths[0], maxSizeSeq=3200)
    np.testing.assert_allclose(one, got[paths[0]], **FEATURES)


def test_jax_checkpoint_abx_matches(jax_checkpoint, phone_corpus, tmp_path):
    root, item, _paths = phone_corpus
    argv = ["from_checkpoint", str(jax_checkpoint), str(item), str(root),
            "--file_extension", ".wav"]
    got = eval_ABX.main(argv + ["--device", "cpu", "--out",
                                str(tmp_path / "port")])
    want = jax_eval_abx.main(argv + ["--out", str(tmp_path / "jax")])
    for mode in ("within", "across"):
        assert 0.0 <= got[mode] <= 1.0
        np.testing.assert_allclose(got[mode], want[mode], rtol=0, atol=1e-5)
    saved = json.loads((tmp_path / "port" / "ABX_scores.json").read_text())
    assert saved == got


def _train_argv(corpus, ck, *extra):
    return ["--pathDB", str(corpus), "--file_extension", ".wav",
            "--device", "cpu", "--pathCheckpoint", str(ck),
            "--hiddenEncoder", str(WIDTH), "--hiddenGar", str(WIDTH),
            "--nPredicts", "3", "--negativeSamplingExt", "4",
            "--sizeWindow", "3840", "--batchSizeGPU", "4",
            "--random_seed", "5", "--logging_step", "100",
            "--n_process_loader", "1", "--save_step", "1", *extra]


@pytest.fixture(scope="module")
def port_run(mini_corpus, tmp_path_factory):
    """One epoch of the port's trainer with `--pathCheckpoint`: the run
    directory and its `checkpoint_0.pt` as loaded right after."""
    ck = tmp_path_factory.mktemp("port_ck") / "run"
    main(_train_argv(mini_corpus, ck, "--nEpoch", "1"))
    first = torch.load(ck / "checkpoint_0.pt", weights_only=False)
    return ck, first


def test_train_writes_checkpoints(port_run):
    ck, first = port_run
    for name in ("checkpoint_0.pt", "checkpoint_args.json",
                 "checkpoint_logs.json"):
        assert (ck / name).exists(), name
    assert set(first) == {"gEncoder", "cpcCriterion", "optimizer", "best"}
    assert first["best"] is not None
    assert "gAR.baseNet.weight_hh_l0" in first["gEncoder"]
    assert all(t.device.type == "cpu" for t in first["gEncoder"].values())
    args = json.loads((ck / "checkpoint_args.json").read_text())
    assert args["hiddenGar"] == WIDTH and args["load"] is None


def test_train_resumes_then_restarts(port_run, mini_corpus, capsys):
    ck, first = port_run
    capsys.readouterr()
    main(_train_argv(mini_corpus, ck, "--nEpoch", "2"))
    out = capsys.readouterr().out
    assert "Checkpoint detected" in out and "Restored optimizer state" in out
    assert "Starting epoch 1" in out and "Starting epoch 0" not in out
    logs = json.loads((ck / "checkpoint_logs.json").read_text())
    assert logs["epoch"] == [0, 1]
    second = torch.load(ck / "checkpoint_1.pt", weights_only=False)
    # the optimizer went on: Adam's step count spans both epochs
    assert second["optimizer"]["state"][0]["step"] == sum(logs["iter"])
    # the parameters went on from checkpoint 0: one epoch of Adam steps of
    # at most a few times the learning rate each
    bound = 4 * 2e-4 * logs["iter"][1]
    for key, value in first["gEncoder"].items():
        step = (second["gEncoder"][key] - value).abs().max().item()
        assert step <= bound, key

    main(_train_argv(mini_corpus, ck, "--nEpoch", "1", "--restart"))
    out = capsys.readouterr().out
    assert "Checkpoint detected" not in out and "Starting epoch 0" in out
    logs = json.loads((ck / "checkpoint_logs.json").read_text())
    assert logs["epoch"] == [0]


def test_port_checkpoint_loads_in_jax(port_run, mini_corpus):
    ck, _first = port_run
    path = ck / "checkpoint_0.pt"
    wav = sorted(str(p) for p in mini_corpus.rglob("*.wav"))[:2]
    got = _features(path, wav, False, 16000)
    want = _features(path, wav, True, 16000)
    for p in wav:
        np.testing.assert_allclose(got[p], want[p], err_msg=p, **FEATURES)


def test_load_initialises_model_and_criterion(port_run, mini_corpus,
                                              tmp_path, capsys):
    ck, first = port_run
    record = main(_train_argv(mini_corpus, tmp_path / "ck2", "--nEpoch", "1",
                              "--load", str(ck / "checkpoint_0.pt"),
                              "--loadCriterion"))
    assert "Loading the state dict" in capsys.readouterr().out
    assert np.isfinite(np.asarray(record["logs"]["locLoss_train"])).all()


# --- optimizer state from the JAX package's optax leaves -------------------

def _jax_train_state(args, optimizer):
    """A `cpc2_tpu` TrainState of the model and criterion `args` describe,
    after three optax updates on gradients drawn with numpy, and the
    gradients of a fourth."""
    import jax
    import optax

    from cpc2_tpu.train import get_criterion as jax_get_criterion
    from cpc2_tpu.train import init_criterion_vars
    from cpc2_tpu.training import create_train_state
    from cpc2_tpu.training import make_optimizer as jax_make_optimizer
    args = argparse.Namespace(**dict(vars(args), optimizer=optimizer))
    bundle = jax_fl.init_model(args, seed=0)
    criterion = jax_get_criterion(args, 160, 3, None)
    tx = jax_make_optimizer(args)
    state = create_train_state(bundle.variables, init_criterion_vars(
        criterion, args, bundle), tx)
    rs = np.random.RandomState(11)

    def grads():
        return jax.tree.map(lambda p: np.asarray(
            rs.randn(*np.shape(p)) * 1e-2, np.float32), state.params)

    params, opt_state = state.params, state.opt_state
    for _ in range(3):
        updates, opt_state = tx.update(grads(), opt_state, params)
        params = optax.apply_updates(params, updates)
    state = state.replace(params=params, opt_state=opt_state, step=3)
    return state, bundle, tx, grads()


def _jax_run_dir(tmp_path, args, state, bundle):
    """A run directory as `cpc2_tpu.train` writes it after epoch 0."""
    from cpc2_tpu.train import _save_training_checkpoint
    ck = tmp_path / "jax_run"
    ck.mkdir()
    _save_training_checkpoint(state, None, bundle, args,
                              str(ck / "checkpoint_0.pt"))
    jax_save_args(args, str(ck / "checkpoint_args.json"))
    save_logs({"epoch": [0], "iter": [3], "saveStep": 1},
              str(ck / "checkpoint_logs.json"))
    return ck


def _port_modules(args, ck):
    from cpc2_torch.training import make_optimizer
    model, criterion = build_model(args), get_criterion(args)
    saved = torch.load(ck / "checkpoint_0.pt", weights_only=True)
    fl.load_state(model, saved["gEncoder"], "gEncoder")
    fl.load_state(criterion, saved["cpcCriterion"], "cpcCriterion")
    optimizer = make_optimizer(args, list(model.parameters())
                               + list(criterion.parameters()))
    return model, criterion, optimizer, saved["optimizer"]


def _by_key(tree):
    """A JAX {'criterion', 'model'} tree as port state-dict keys."""
    import jax
    return {f"{name}.{k}": v for name in ("criterion", "model")
            for k, v in state_dict_from_jax(
                jax.tree.map(np.asarray, tree[name])).items()}


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_resume_from_optax_state(mini_corpus, tmp_path, optimizer):
    """The leaves `cpc2_tpu` writes become torch's optimizer state: the
    port derives the JAX leaf order itself, the moments are
    `state_dict_from_jax` of optax's exactly, and one more step on the same
    gradients matches optax's at rtol 1e-5, atol 1e-6 (fp32 reordering)."""
    import jax
    import optax

    from cpc2_torch.io.from_jax import jax_param_order
    from cpc2_torch.train import _load_optimizer
    args = parse_args(_train_argv(mini_corpus, tmp_path, "--optimizer",
                                  optimizer))
    state, bundle, tx, grads = _jax_train_state(args, optimizer)
    ck = _jax_run_dir(tmp_path, args, state, bundle)
    model, criterion, torch_opt, saved = _port_modules(args, ck)
    modules = {"criterion": criterion, "model": model}
    assert saved["format"] == "optax_leaves" and saved["step"] == 3

    # the leaf order, from a real TrainState
    want = [tuple(str(getattr(k, "key", k)) for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(state.params)[0]]
    assert [path for path, _ in jax_param_order(modules)] == want

    assert _load_optimizer(torch_opt, saved, modules, args.normMode) is None
    inner = state.opt_state.inner_state[0]
    moments = ({"exp_avg": inner.mu, "exp_avg_sq": inner.nu}
               if optimizer == "adam" else {"momentum_buffer": inner.trace})
    params = {f"{name}.{k}": p for name, m in modules.items()
              for k, p in m.named_parameters()}
    for slot, tree in moments.items():
        for key, value in _by_key(tree).items():
            assert torch.equal(torch_opt.state[params[key]][slot], value), key
    if optimizer == "adam":
        assert all(torch_opt.state[p]["step"].item() == 3
                   for p in params.values())

    updates, _ = tx.update(grads, state.opt_state, state.params)
    after = _by_key(optax.apply_updates(state.params, updates))
    for key, g in _by_key(grads).items():
        params[key].grad = g.reshape(params[key].shape)
    torch_opt.step()
    for key, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   after[key].reshape(p.shape).numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_trainer_resumes_a_jax_run(mini_corpus, tmp_path, capsys):
    """`python -m cpc2_torch.train --pathCheckpoint <a cpc2_tpu run>`
    restores the Adam moments, says that the generator starts from the
    seed, and trains the next epoch."""
    args = parse_args(_train_argv(mini_corpus, tmp_path / "jax_run"))
    state, bundle, _tx, _g = _jax_train_state(args, "adam")
    ck = _jax_run_dir(tmp_path, args, state, bundle)
    capsys.readouterr()
    record = main(_train_argv(mini_corpus, ck, "--nEpoch", "2"))
    out = capsys.readouterr().out
    assert "Restored optimizer state from optax leaves" in out
    assert "holds no generator state" in out
    assert "Starting epoch 1" in out and "Starting epoch 0" not in out
    steps = record["logs"]["iter"][-1]
    second = torch.load(ck / "checkpoint_1.pt", weights_only=True)
    assert second["optimizer"]["state"][0]["step"].item() == 3 + steps


def test_optax_state_that_does_not_fit_raises(mini_corpus, tmp_path):
    """A leaf count or shape that does not fit raises with both counts.
    bf16 moments (`--adam_mu_dtype bf16`'s mu; the JAX package cannot write
    them in torch format, so the test makes them, as torch tensors and as
    numpy's `ml_dtypes.bfloat16` arrays) load: into torch's Adam as their
    fp32 values, into `AdamBF16Moment` as the same bf16 values."""
    from cpc2_torch.train import _load_optimizer
    args = parse_args(_train_argv(mini_corpus, tmp_path))
    state, bundle, _tx, _g = _jax_train_state(args, "adam")
    ck = _jax_run_dir(tmp_path, args, state, bundle)
    model, criterion, torch_opt, saved = _port_modules(args, ck)
    modules = {"criterion": criterion, "model": model}
    leaves = saved["leaves"]
    for bad, match in ((leaves[:-1], f"{len(leaves) - 1} leaves.*takes "
                        f"{len(leaves)}"),
                       (leaves[:7] + [leaves[8]] + leaves[8:], "shape")):
        with pytest.raises(ValueError, match=match):
            _load_optimizer(torch_opt, dict(saved, leaves=bad), modules,
                            args.normMode)
    import ml_dtypes

    from cpc2_torch.optim import AdamBF16Moment
    n = (len(leaves) - 7) // 2
    mu = [t.bfloat16() for t in leaves[7:7 + n]]
    params = {f"{name}.{k}": p for name, m in modules.items()
              for k, p in m.named_parameters()}
    for opt in (torch_opt, AdamBF16Moment(list(model.parameters())
                                          + list(criterion.parameters()))):
        for as_numpy in (False, True):
            bf16 = leaves[:7] + [
                t.float().numpy().astype(ml_dtypes.bfloat16) if as_numpy
                else t for t in mu] + leaves[7 + n:]
            _load_optimizer(opt, dict(saved, leaves=bf16), modules,
                            args.normMode)
            want = {key: v.to(torch.bfloat16) for key, v in _by_key(
                state.opt_state.inner_state[0].mu).items()}
            for key, p in params.items():
                got = opt.state[p]["exp_avg"]
                assert got.dtype == (torch.bfloat16 if isinstance(
                    opt, AdamBF16Moment) else torch.float32), key
                assert torch.equal(got.to(torch.bfloat16),
                                   want[key].reshape(got.shape)), key


# --- several checkpoints as one model --------------------------------------

@pytest.fixture(scope="module")
def jax_checkpoint_wide(tmp_path_factory):
    """A second JAX model, 24 wide, in a run directory of its own."""
    args = jax_default_config()
    args.hiddenEncoder = args.hiddenGar = 24
    args.load = None
    bundle = jax_fl.init_model(args, seed=1)
    ck = tmp_path_factory.mktemp("jax_ck_wide")
    jax_save_checkpoint(params_to_torch_state_dict(bundle.variables["params"],
                                                   norm_mode=args.normMode),
                        {}, {}, None, str(ck / "checkpoint_0.pt"))
    jax_save_args(args, str(ck / "checkpoint_args.json"))
    (ck / "checkpoint_logs.json").write_text("{}")
    return ck / "checkpoint_0.pt"


def test_load_two_checkpoints_matches_jax(jax_checkpoint, jax_checkpoint_wide,
                                          phone_corpus):
    """Two JAX checkpoints (16 and 24 wide) as one concatenated model:
    features held against `cpc2_tpu.feature_loader.load_model` of the same
    two, and equal, channel by channel, to each model's own."""
    _root, _item, paths = phone_corpus
    both = [jax_checkpoint, jax_checkpoint_wide]
    model, hidden_gar, hidden_encoder = fl.load_model([str(p) for p in both])
    assert isinstance(model, ConcatenatedModel)
    assert (hidden_gar, hidden_encoder) == (40, 40)
    assert jax_fl.load_model([str(p) for p in both])[1:] == (40, 40)
    got = _features(both, paths, False, 3200)
    want = _features(both, paths, True, 3200)
    one = _features([jax_checkpoint], paths, False, 3200)
    wide = _features([jax_checkpoint_wide], paths, False, 3200)
    for p in paths:
        assert got[p].shape[-1] == 40
        np.testing.assert_allclose(got[p], want[p], err_msg=p, **FEATURES)
        np.testing.assert_array_equal(got[p][..., :WIDTH], one[p])
        np.testing.assert_array_equal(got[p][..., WIDTH:], wide[p])


def test_train_two_checkpoints_and_resume(port_run, jax_checkpoint,
                                          mini_corpus, tmp_path, capsys):
    """`--load a.pt b.pt` trains the concatenated model (32 wide); its run
    resumes twice with the same model."""
    ck = tmp_path / "concat"
    loads = [str(port_run[0] / "checkpoint_0.pt"), str(jax_checkpoint)]
    for n_epoch in (1, 2, 3):
        main(_train_argv(mini_corpus, ck, "--nEpoch", str(n_epoch),
                         "--load", *loads))
    out = capsys.readouterr().out
    assert out.count("Restored optimizer state") == 2
    logs = json.loads((ck / "checkpoint_logs.json").read_text())
    assert logs["epoch"] == [0, 1, 2]
    assert np.isfinite(np.asarray(logs["locLoss_train"])).all()
    saved = json.loads((ck / "checkpoint_args.json").read_text())
    assert saved["load"] == loads and saved["hiddenGar"] == 2 * WIDTH
    third = torch.load(ck / "checkpoint_2.pt", weights_only=True)
    assert "models.1.gAR.baseNet.weight_hh_l0" in third["gEncoder"]
    model = fl.load_model([str(ck / "checkpoint_2.pt")])[0]
    assert isinstance(model, ConcatenatedModel)


# --- resume bit for bit, and the profiled window --------------------------

@pytest.fixture(scope="module")
def resumed_runs(mini_corpus, tmp_path_factory):
    """Two epochs in one run (with `--profile_dir`), and one epoch, then a
    resume to two, in another; the second run's resume output."""
    import contextlib
    import io
    base = tmp_path_factory.mktemp("resume")
    whole, split, prof = base / "whole", base / "split", base / "prof"
    main(_train_argv(mini_corpus, whole, "--nEpoch", "2", "--profile_dir",
                     str(prof)))
    main(_train_argv(mini_corpus, split, "--nEpoch", "1"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(_train_argv(mini_corpus, split, "--nEpoch", "2"))
    return whole, split, prof, out.getvalue()


def _assert_equal_trees(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_trees(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_resume_is_bit_identical(resumed_runs):
    """Every tensor of the two runs' `checkpoint_1.pt` is equal: weights,
    criterion, Adam's state, the generator's state and the best weights."""
    whole, split, _prof, out = resumed_runs
    assert "Restored the generator state" in out
    a = torch.load(whole / "checkpoint_1.pt", weights_only=True)
    b = torch.load(split / "checkpoint_1.pt", weights_only=True)
    assert set(a) == {"gEncoder", "cpcCriterion", "optimizer", "best"}
    assert a["optimizer"]["generator_state"].dtype == torch.uint8
    _assert_equal_trees(a, b)
    logs = [json.loads((d / "checkpoint_logs.json").read_text())
            for d in (whole, split)]
    assert logs[0]["locLoss_train"] == logs[1]["locLoss_train"]


def test_profile_dir_writes_one_trace(resumed_runs):
    """`--profile_dir` traces steps 5-14 of the first epoch only: one
    Chrome trace holding ten optimizer steps, the encoder's first layer
    (one window product a step) and its other four convolutions, forward
    and backward."""
    _whole, _split, prof, _out = resumed_runs
    traces = list(prof.iterdir())
    assert [t.name for t in traces] == ["train_steps.pt.trace.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert names.count("Optimizer.step#Adam.step") == 10
    assert names.count("aten::unfold") == 10
    assert names.count("aten::conv1d") == 40
    assert names.count("ConvolutionBackward0") == 40


def test_trace_summary(resumed_runs, tmp_path):
    """`profile_step.trace_summary` of a synthetic trace (two overlapping
    kernels, one apart, a host op around them), and of the CPU run's
    trace, where no kernel ran."""
    from cpc2_torch.profile_step import trace_summary
    events = [{"ph": "X", "cat": "cpu_op", "name": "step", "ts": 0.0,
               "dur": 1000.0},
              {"ph": "X", "cat": "kernel", "name": "a", "ts": 100.0,
               "dur": 200.0},
              {"ph": "X", "cat": "kernel", "name": "b", "ts": 250.0,
               "dur": 100.0},
              {"ph": "X", "cat": "kernel", "name": "a", "ts": 600.0,
               "dur": 300.0},
              {"ph": "i", "name": "marker", "ts": 5000.0}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = trace_summary(str(path))
    assert got["window_ms"] == 1.0 and got["kernel_launches"] == 3
    assert abs(got["device_busy_ms"] - 0.55) < 1e-12
    assert abs(got["host_share"] - 0.45) < 1e-12
    assert got["top"] == [("a", 0.5, 2), ("b", 0.1, 1)]
    cpu = trace_summary(str(resumed_runs[2] / "train_steps.pt.trace.json"))
    assert cpu["kernel_launches"] == 0 and cpu["host_share"] == 1.0
    assert cpu["window_ms"] > 0
