"""The port's package boundaries, flags and trainer on the CPU: importing it
(every module, the supervised criteria's `losses/seq_alignment.py`, the
probe's `eval/linear_separability.py`, the clustering, dim-reduction,
unit-ABX, ZeroSpeech-export and Common Voices modules, the hub entry and the
host DTW, the CCA fit, the clustering criteria and the host tools among
them) pulls in nothing of JAX, the JAX package, scikit-learn or pandas and
builds nothing, the discrete-unit, Common Voices and CCA CLIs take the JAX
package's flags plus `--device` and the host tools its flags alone,
unported flags raise and ported ones (augmentation,
`--supervised`) parse, `--device cuda` without a card raises, and
`python -m cpc2_torch.train` trains on a wav corpus with `--device cpu`,
and on a FLAC corpus at its own `--file_extension`.
"""

import argparse
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
        "('jax', 'jaxlib', 'flax', 'optax', 'cpc2_tpu', 'sklearn', "
        "'pandas')]\n"
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
    assert {"cpc2_torch.losses.seq_alignment",
            "cpc2_torch.eval.linear_separability",
            "cpc2_torch.clustering.clustering",
            "cpc2_torch.clustering.clustering_script",
            "cpc2_torch.clustering.clustering_quantization",
            "cpc2_torch.research.dim_reduction",
            "cpc2_torch.eval.eval_ABX_clustering",
            "cpc2_torch.eval.build_zeroSpeech_features",
            "cpc2_torch.eval.common_voices_eval", "cpc2_torch.hub",
            "cpc2_torch.ops.dtw_host", "cpc2_torch.research.cca",
            "cpc2_torch.research.train_cca",
            "cpc2_torch.research.clustering_criterion",
            "cpc2_torch.tools.adjust_sample_rate",
            "cpc2_torch.tools.best_val_epoch",
            "cpc2_torch.tools.build_power_two_training",
            "cpc2_torch.tools.extract_segments",
            "cpc2_torch.tools.filter", "cpc2_torch.parallel",
            "cpc2_torch.parallel.distributed",
            "cpc2_torch.parallel.data_parallel",
            "cpc2_torch.train_tails"} <= set(_modules())


class _Parsed(Exception):
    pass


def _parser(entry, argv):
    """The `ArgumentParser` that `entry(argv)` parses with, caught at its
    `parse_args`."""
    real = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        raise _Parsed(self)
    argparse.ArgumentParser.parse_args = spy
    try:
        entry(argv)
    except _Parsed as caught:
        return caught.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    raise AssertionError(f"{entry} parsed nothing")


def _flags(parser):
    """Each argument's names, default, choices, nargs, type, constant and
    whether it is required."""
    return {(tuple(a.option_strings) or (a.dest,)): (
        a.dest, a.default, a.choices, a.nargs, a.const, a.required,
        getattr(a.type, "__name__", a.type)) for a in parser._actions
        if not isinstance(a, argparse._HelpAction)}


def _cli_entries():
    from cpc2_torch.clustering import (clustering_quantization,
                                       clustering_script)
    from cpc2_torch.eval import (build_zeroSpeech_features,
                                 common_voices_eval, eval_ABX_clustering)
    from cpc2_torch.research import dim_reduction, train_cca
    from cpc2_torch.tools import (adjust_sample_rate, best_val_epoch,
                                  build_power_two_training, extract_segments)
    from cpc2_torch.tools import filter as port_filter
    from cpc2_tpu.clustering import clustering_quantization as jax_quant
    from cpc2_tpu.clustering import clustering_script as jax_script
    from cpc2_tpu.eval import build_zeroSpeech_features as jax_export
    from cpc2_tpu.eval import common_voices_eval as jax_cv
    from cpc2_tpu.eval import eval_ABX_clustering as jax_abx
    from cpc2_tpu.research import dim_reduction as jax_dr
    from cpc2_tpu.research import train_cca as jax_cca
    from cpc2_tpu.tools import adjust_sample_rate as jax_resample
    from cpc2_tpu.tools import best_val_epoch as jax_best
    from cpc2_tpu.tools import build_power_two_training as jax_b2
    from cpc2_tpu.tools import extract_segments as jax_segments
    from cpc2_tpu.tools import filter as jax_filter
    from cpc2_tpu import train as jax_train
    return {"common_voices_train": (common_voices_eval.parse_args,
                                    jax_cv.parse_args),
            "common_voices_per": (common_voices_eval.parse_args,
                                  jax_cv.parse_args),
            "clustering_script": (clustering_script.parseArgs,
                                  jax_script.parseArgs),
            "clustering_quantization": (clustering_quantization.parseArgs,
                                        jax_quant.parseArgs),
            "eval_ABX_clustering": (eval_ABX_clustering.parse_args,
                                    jax_abx.parse_args),
            "build_zeroSpeech_features": (
                build_zeroSpeech_features.parse_export_args,
                jax_export.parse_export_args),
            "dim_reduction": (dim_reduction.parse_args, jax_dr.main),
            "train_cca": (train_cca.main, jax_cca.main),
            "adjust_sample_rate": (adjust_sample_rate.parse_args,
                                   jax_resample.parse_args),
            "best_val_epoch": (best_val_epoch.main, jax_best.main),
            "build_power_two_training": (build_power_two_training.main,
                                         jax_b2.main),
            "extract_segments": (extract_segments.main, jax_segments.main),
            "filter": (port_filter.parse_args, jax_filter.parse_args),
            "train": (parse_args, jax_train.parse_args)}


# the host tools, which run no model, take no --device
HOST_TOOLS = ("adjust_sample_rate", "best_val_epoch",
              "build_power_two_training", "extract_segments", "filter")


def _subparser(parser, name):
    """The subcommand `name`'s parser of `parser`."""
    action = next(a for a in parser._actions
                  if isinstance(a, argparse._SubParsersAction))
    return action.choices[name]


@pytest.mark.parametrize("cli", ["clustering_script",
                                 "clustering_quantization",
                                 "eval_ABX_clustering",
                                 "build_zeroSpeech_features",
                                 "dim_reduction", "common_voices_train",
                                 "common_voices_per", "train_cca", "train"]
                         + list(HOST_TOOLS))
def test_cli_flags_match_jax(cli):
    """The trainer (the data-parallel flags and `--global_negatives`
    among its flags), the discrete-unit CLIs, the Common Voices
    subcommands, the CCA fit and the host tools take the JAX package's
    flags name for name, with its defaults, choices and nargs, and, where
    a model runs, `--device` besides (default cuda)."""
    if cli == "filter":
        pytest.importorskip("pandas")
    port, jax_entry = _cli_entries()[cli]
    got, want = _parser(port, []), _parser(jax_entry, [])
    if cli.startswith("common_voices_"):
        command = cli[len("common_voices_"):]
        got, want = _subparser(got, command), _subparser(want, command)
    got, want = _flags(got), _flags(want)
    if cli in HOST_TOOLS:
        assert got == want
        return
    device = got.pop(("--device",))
    assert device[1] == "cuda" and device[2] == ["cuda", "cpu"]
    assert got == want


BASE = ["--pathDB", "db", "--file_extension", ".wav"]


@pytest.mark.parametrize("flags", [
    ["--nGPU", "2"],
    ["--distributed"], ["--data_axis_size", "2"],
    ["--model_axis_size", "2"], ["--dcn_axis_size", "2"],
    ["--global_negatives"], ["--ckpt_format", "orbax"],
    ["--nGPU", "4"],
])
def test_unported_flags_raise(flags):
    """`--model_axis_size` and `--ckpt_format orbax` are not ported: they
    raise naming their ROADMAP item. The data-parallel flags and
    `--global_negatives` are: they parse as the JAX package's do."""
    if flags[0] in ("--model_axis_size", "--ckpt_format"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            parse_args(BASE + flags)
        return
    args = parse_args(BASE + flags)
    for name, value in zip(flags[::2], flags[1::2] + [True]):
        got = getattr(args, name[2:])
        assert got == type(got)(value), name


@pytest.mark.parametrize("flags", [
    ["--cpc_mode", "reverse"], ["--cpc_mode", "bert"], ["--cpc_mode", "none"],
    ["--rnnMode", "linear"], ["--rnnMode", "conv12"], ["--multihead_rnn"],
    ["--encoder_type", "mfcc"], ["--encoder_type", "lfb"],
    ["--mask_prob", "0.01", "--mask_length", "4"],
    ["--signal_quality_path", "q", "--signal_quality_step", "800",
     "--signal_quality_mode", "c50", "--growth_rate", "5",
     "--inflection_point_x", "0.2"],
    ["--precision", "bf16"], ["--adam_mu_dtype", "bf16"],
    ["--neg_pool_group", "4"],
])
def test_variant_flags_parse(flags):
    """The model and criterion modes, the bf16 precision and Adam moment
    and grouped negative pools are ported: they parse, and the port raises
    no `NotImplementedError` for them."""
    args = parse_args(BASE + flags)
    if flags == ["--multihead_rnn"]:
        assert args.multihead_rnn
    else:
        for name, value in zip(flags[::2], flags[1::2]):
            got = getattr(args, name[2:])
            assert got == type(got)(value), name


def test_orbax_checkpoint_args_still_load_weights(tmp_path):
    """`--ckpt_format orbax` is refused in training only: a checkpoint whose
    saved flags say `orbax` (the JAX package's writes its weights to the
    `.pt` beside the train state) still loads for features."""
    from cpc2_torch import feature_loader as fl
    from cpc2_torch.io.checkpoint import save_args, save_checkpoint
    args = parse_args(BASE + ["--hiddenEncoder", "16", "--hiddenGar", "16"])
    args.ckpt_format = "orbax"
    model = fl.build_model(args)
    save_checkpoint(model.state_dict(), {}, {}, None,
                    str(tmp_path / "checkpoint_0.pt"))
    save_args(args, str(tmp_path / "checkpoint_args.json"))
    (tmp_path / "checkpoint_logs.json").write_text("{}")
    loaded, hidden_gar, hidden_encoder = fl.load_model(
        [str(tmp_path / "checkpoint_0.pt")])
    assert (hidden_gar, hidden_encoder) == (16, 16)
    for key, value in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key
    with pytest.raises(NotImplementedError, match="Orbax train-state"):
        from cpc2_torch.train import _resume
        _resume(parse_args(["--pathCheckpoint", str(tmp_path)]))


@pytest.mark.parametrize("flags,phone,ctc,levels,on_encoder", [
    (["--supervised"], None, False, 1, False),
    (["--supervised", "--pathPhone", "phones.txt"], "phones.txt", False, 1,
     False),
    (["--supervised", "--pathPhone", "phones.txt", "--CTC"], "phones.txt",
     True, 1, False),
    (["--supervised", "--pathPhone", "phones.txt", "--nLevelsPhone", "3",
      "--onEncoder"], "phones.txt", False, 3, True),
])
def test_supervised_flags_parse(flags, phone, ctc, levels, on_encoder):
    """The supervised flags are ported: they parse as the JAX package's
    do."""
    args = parse_args(BASE + flags)
    assert args.supervised
    assert (args.pathPhone, args.CTC, args.nLevelsPhone, args.onEncoder) == (
        phone, ctc, levels, on_encoder)


@pytest.mark.parametrize("flags", [
    ["--augment_future", "--augment_type", "bandreject", "pitch",
     "artificial_reverb_dropout", "--pathDBNoise", "noise"],
    ["--augment_past", "--augment_type", "additive", "natural_reverb",
     "--augment_on_device", "--pathImpulseResponses", "irs",
     "--host_prefetch", "0"],
])
def test_augmentation_flags_parse(flags):
    """The augmentation flags are ported: they parse as the JAX package's
    do, with every `--augment_type` of the CLI's choices."""
    args = parse_args(BASE + flags)
    assert args.augment_past or args.augment_future
    assert len(args.augment_type) in (2, 3)


def test_flac_default_parses():
    """The trainer's own defaults parse: FLAC, and the flags of the ported
    checkpoint extras and augmentation; `--meta_aug` parses and needs
    `--meta_aug_type`."""
    args = parse_args(["--pathDB", "db"])
    assert args.file_extension == ".flac"
    args = parse_args(["--pathDB", "db", "--profile_dir", "p", "--load",
                       "a.pt", "b.pt"])
    assert args.profile_dir == "p" and len(args.load) == 2
    with pytest.raises(ValueError, match="meta_aug_type"):
        parse_args(["--pathDB", "db", "--meta_aug"])
    args = parse_args(["--pathDB", "db", "--meta_aug", "--meta_aug_type",
                       "natural_reverb"])
    assert args.meta_aug and args.meta_aug_type == ["natural_reverb"]


@pytest.fixture(scope="module")
def flac_corpus(tmp_path_factory):
    """4 speakers x 2 files of 16-bit FLAC in LibriSpeech layout."""
    from tests.test_flac import encode_flac
    root = tmp_path_factory.mktemp("flac_db")
    rs = np.random.RandomState(2)
    for s in range(4):
        folder = root / str(300 + s) / "5"
        folder.mkdir(parents=True)
        for i in range(2):
            n = 36000 + 4000 * i
            t = np.arange(n) / 16000
            x = 0.3 * np.sin(2 * np.pi * (80 + 35 * s) * t) \
                + 0.05 * rs.randn(n)
            encode_flac(str(folder / f"{300 + s}-5-{i}.flac"), [np.clip(
                np.round(x * 32767), -32768, 32767).astype(np.int16)])
    return root


def test_train_main_on_a_flac_corpus(flac_corpus, capsys):
    """No `--file_extension`: the trainer reads the FLAC corpus."""
    record = main(["--pathDB", str(flac_corpus), "--device", "cpu",
                   "--nEpoch", "1", "--hiddenEncoder", "16",
                   "--hiddenGar", "16", "--nPredicts", "3",
                   "--negativeSamplingExt", "4", "--sizeWindow", "3840",
                   "--batchSizeGPU", "4", "--random_seed", "5",
                   "--logging_step", "4", "--n_process_loader", "2"])
    out = capsys.readouterr().out
    assert "Found files: 8 seqs, 4 speakers" in out
    values = np.asarray(record["logs"]["locLoss_train"])
    assert values.shape == (1, 3) and np.isfinite(values).all()
    assert record["logs"]["iter"][0] > 4


@pytest.mark.parametrize("flags", [
    [], ["--prng", "threefry"], ["--remat"], ["--head_remat", "dots"],
    ["--host_prefetch", "0"], ["--head_remat"],
])
def test_xla_only_flags_are_accepted(flags):
    args = parse_args(BASE + flags)
    assert (args.hiddenEncoder, args.nPredicts, args.negativeSamplingExt,
            args.rnnMode, args.arMode) == (256, 12, 128, "transformer",
                                           "LSTM")


def test_two_processes_building_at_once_share_one_build(tmp_path):
    """Two processes that call `_build.build_host` on a fresh build
    directory at once (as ranks starting together do) both load a
    library, built once under the build lock."""
    code = (
        "import ctypes, pathlib, sys\n"
        "from cpc2_torch.ops import _build\n"
        "_build.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "path = _build.build_host('dtwhost')\n"
        "ctypes.CDLL(str(path)).dtw_host_batch\n"
        "print(path.stat().st_mtime_ns)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _o, e in outs]
    assert outs[0][0] == outs[1][0]           # one build, seen by both
    assert sorted(x.name for x in tmp_path.iterdir()) == [".build.lock",
                                                          "libdtwhost.so"]


def test_cuda_without_a_card_raises(mini_corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--pathDB", str(mini_corpus), "--file_extension", ".wav"])


@pytest.mark.parametrize("command", ["train", "per"])
def test_common_voices_cuda_without_a_card_raises(tmp_path, command):
    """`--device cuda` (the default) raises before reading anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from cpc2_torch.eval import common_voices_eval
    argv = {"train": ["train", "db", "phones.txt", "ck.pt"],
            "per": ["per", str(tmp_path)]}[command]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common_voices_eval.main(argv + ["-o", str(tmp_path / "out")]
                                if command == "train" else argv)
    assert not (tmp_path / "out").exists()


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
