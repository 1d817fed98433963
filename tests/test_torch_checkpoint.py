"""Checkpoints and feature extraction of the port against the JAX package
on the CPU, at a tiny width (16).

A checkpoint that `cpc2_tpu` writes loads in `cpc2_torch.feature_loader.
load_model`, whose features (`build_feature_files`, the context network's
state carried across chunks) and ABX scores (`eval_ABX from_checkpoint`)
match the JAX package's; a checkpoint the port's trainer writes loads in
`cpc2_tpu.feature_loader.load_model`; and `python -m cpc2_torch.train
--pathCheckpoint` saves, resumes and restarts.

Tolerances: features rtol 1e-5, atol 1e-6 (fp32 reordering); ABX scores
atol 1e-5 (the same win counts over features that agree to 1e-6).
"""

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
from cpc2_torch.io import save_args, save_checkpoint, save_logs
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
    if jax_side:
        bundle = jax_fl.load_model([str(path)])[0]
        maker = jax_fl.FeatureModule(bundle, False, keep_hidden=True)
    else:
        model = fl.load_model([str(path)])[0]
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


def test_resume_from_optax_state_raises(mini_corpus, tmp_path):
    """A run directory whose optimizer entry is the JAX package's optax
    leaves: resuming its optimizer is not ported."""
    ck = tmp_path / "jax_run"
    ck.mkdir()
    args = parse_args(_train_argv(mini_corpus, ck, "--nEpoch", "1"))
    save_checkpoint(build_model(args).state_dict(),
                    get_criterion(args).state_dict(),
                    {"format": "optax_leaves", "leaves": [], "step": 3},
                    None, str(ck / "checkpoint_0.pt"))
    save_args(args, str(ck / "checkpoint_args.json"))
    save_logs({"epoch": [0], "iter": [3], "saveStep": 1}, str(
        ck / "checkpoint_logs.json"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(_train_argv(mini_corpus, ck, "--nEpoch", "2"))


def test_load_two_checkpoints_raises(jax_checkpoint):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fl.load_model([str(jax_checkpoint)] * 2)
