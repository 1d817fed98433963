"""The port's package boundaries, flags and trainer on the CPU: importing it
pulls in nothing of JAX or the JAX package and builds nothing, unported
flags raise, `--device cuda` without a card raises, and
`python -m cpc2_torch.train` trains on a wav corpus with `--device cpu`.
"""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import cpc2_torch
from cpc2_torch.config import parse_args
from cpc2_torch.train import main

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(name for _, name, _ in pkgutil.walk_packages(
        cpc2_torch.__path__, "cpc2_torch."))


def test_import_pulls_in_no_jax_and_builds_nothing(tmp_path):
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'cpc2_tpu')]\n"
        "assert not bad, bad\n"
        "from cpc2_torch.ops import _build\n"
        "assert _build._lib is None\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert len(_modules()) >= 20


BASE = ["--pathDB", "db", "--file_extension", ".wav"]


@pytest.mark.parametrize("flags", [
    ["--profile_dir", "p"], ["--load", "a.pt", "b.pt"], ["--nGPU", "2"],
    ["--distributed"], ["--augment_past"], ["--cpc_mode", "reverse"],
    ["--rnnMode", "linear"], ["--multihead_rnn"], ["--precision", "bf16"],
    ["--global_negatives"], ["--neg_pool_group", "4"],
    ["--encoder_type", "mfcc"], ["--supervised"],
])
def test_unported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        parse_args(BASE + flags)


def test_flac_corpus_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        parse_args(["--pathDB", "db"])


@pytest.mark.parametrize("flags", [
    [], ["--prng", "threefry"], ["--remat"], ["--steps_per_dispatch", "1"],
    ["--host_prefetch", "0"], ["--head_remat"],
])
def test_xla_only_flags_are_accepted(flags):
    args = parse_args(BASE + flags)
    assert (args.hiddenEncoder, args.nPredicts, args.negativeSamplingExt,
            args.rnnMode, args.arMode) == (256, 12, 128, "transformer",
                                           "LSTM")


def test_cuda_without_a_card_raises(mini_corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--pathDB", str(mini_corpus), "--file_extension", ".wav"])


@pytest.mark.parametrize("ar_mode,sampling", [
    ("LSTM", "samespeaker"), ("GRU", "uniform"),
    # the LSTM's (h, c) carried from batch to batch
    ("LSTM", "sequential")])
def test_train_main_on_cpu(mini_corpus, capsys, ar_mode, sampling):
    record = main(["--pathDB", str(mini_corpus), "--file_extension", ".wav",
                   "--device", "cpu", "--nEpoch", "1", "--arMode", ar_mode,
                   "--samplingType", sampling,
                   "--hiddenEncoder", "16", "--hiddenGar", "16",
                   "--nPredicts", "3", "--negativeSamplingExt", "4",
                   "--sizeWindow", "3840", "--batchSizeGPU", "4",
                   "--random_seed", "5", "--logging_step", "4",
                   "--n_process_loader", "1"])
    out = capsys.readouterr().out
    assert "Training loss" in out and "Validation loss:" in out
    logs = record["logs"]
    for key in ("locLoss_train", "locAcc_train", "locLoss_val",
                "locAcc_val"):
        values = np.asarray(logs[key])
        assert values.shape == (1, 3) and np.isfinite(values).all(), key
    assert len(record["step_ms"]) == logs["iter"][0] > 4
    assert record["param_devices"] == ["cpu"]
