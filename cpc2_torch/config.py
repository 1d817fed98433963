"""Flag registry of the port (counterpart of `cpc2_tpu/config.py` and the
flags of `cpc2_tpu/train.py:parse_args`).

The names, defaults and choices are the JAX package's, so a command line
written for `python -m cpc2_tpu.train` parses here unchanged. Flags whose
feature is not ported yet raise `NotImplementedError` naming the ROADMAP
item when they are set away from their default. A few flags only mean
something to XLA and are accepted and do nothing: `--prng`, `--remat`,
`--head_remat`, `--steps_per_dispatch 1`, `--host_prefetch` and
`--corpus_on_device` off. The port adds `--device`.
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Optional, Sequence


def set_default_cpc_config(parser: argparse.ArgumentParser
                           ) -> argparse.ArgumentParser:
    group = parser.add_argument_group('Architecture configuration')
    group.add_argument('--hiddenEncoder', type=int, default=256,
                       help='Channel width of the convolutional encoder.')
    group.add_argument('--hiddenGar', type=int, default=256,
                       help='State size of the context (AR) network.')
    group.add_argument('--nPredicts', type=int, default=12,
                       help='How many future frames the CPC loss predicts.')
    group.add_argument('--negativeSamplingExt', type=int, default=128,
                       help='InfoNCE negatives drawn per window position.')
    group.add_argument('--optimizer', type=str, default='adam',
                       choices=['adam', 'sgd'])
    group.add_argument('--learningRate', type=float, default=2e-4)
    group.add_argument('--schedulerStep', type=int, default=-1,
                       help='Halve the learning rate every this many '
                       'epochs; negative disables the schedule.')
    group.add_argument('--schedulerRamp', type=int, default=None,
                       help='Epochs of a linear learning-rate warm-up.')
    group.add_argument('--beta1', type=float, default=0.9)
    group.add_argument('--beta2', type=float, default=0.999)
    group.add_argument('--epsilon', type=float, default=1e-08)
    group.add_argument('--sizeWindow', type=int, default=20480,
                       help='Samples per training window (1.28 s at 16 kHz).')
    group.add_argument('--nEpoch', type=int, default=200)
    group.add_argument('--samplingType', type=str, default='samespeaker',
                       choices=['samespeaker', 'uniform', 'samesequence',
                                'sequential', 'temporalsamespeaker'])
    group.add_argument('--nLevelsPhone', type=int, default=1)
    group.add_argument('--cpc_mode', type=str, default=None,
                       choices=['reverse', 'bert', 'none'])
    group.add_argument('--encoder_type', type=str,
                       choices=['cpc', 'mfcc', 'lfb'], default='cpc')
    group.add_argument('--normMode', type=str, default='layerNorm',
                       choices=['instanceNorm', 'ID', 'layerNorm',
                                'batchNorm'])
    group.add_argument('--onEncoder', action='store_true')
    group.add_argument('--random_seed', type=int, default=None)
    group.add_argument('--arMode', default='LSTM',
                       choices=['GRU', 'LSTM', 'RNN', 'no_ar', 'transformer'])
    group.add_argument('--nLevelsGRU', type=int, default=1)
    group.add_argument('--rnnMode', type=str, default='transformer',
                       choices=['transformer', 'RNN', 'LSTM', 'linear',
                                'ffd', 'conv4', 'conv8', 'conv12',
                                'transformer_adaptive_span'])
    group.add_argument('--dropout', action='store_true',
                       help='Dropout 0.5 on the prediction-head outputs.')
    group.add_argument('--abspos', action='store_true')
    group.add_argument('--multihead_rnn', action='store_true')
    group.add_argument('--adapt_span_loss', type=float, default=2e-6)
    group.add_argument('--transformer_pruning', type=int, default=0)
    group.add_argument('--naming_convention', type=str, default=None,
                       choices=[None, 'full_seedlings', 'no_speaker',
                                'id_spkr_onset_offset', 'spkr-id',
                                'spkr-id-nb',
                                'id_spkr_onset_offset_spkr_onset_offset',
                                'spkr_id_nb'])
    group.add_argument('--no_artefacts', action='store_true')
    group.add_argument('--mask_prob', type=float, default=0.0)
    group.add_argument('--mask_length', type=int, default=10)
    group.add_argument('--signal_quality_path', type=str, default=None)
    group.add_argument('--signal_quality_step', type=int, default=1600)
    group.add_argument('--signal_quality_mode', type=str,
                       choices=['snr', 'c50', 'snr_c50'], default='snr')
    group.add_argument('--growth_rate', type=float, default=10)
    group.add_argument('--inflection_point_x', type=float, default=0.5)
    group.add_argument('--n_skipped', type=int, default=0)
    group.add_argument('--no_speaker', action='store_true')

    group_augment = parser.add_argument_group(
        'Data augmentation configuration')
    group_augment.add_argument('--noise_extension', type=str, default='.wav')
    group_augment.add_argument('--augment_future', action='store_true')
    group_augment.add_argument('--augment_past', action='store_true')
    group_augment.add_argument('--augment_type', type=str,
                               choices=['none', 'bandreject', 'pitch',
                                        'pitch_deropout', 'pitch_dropout',
                                        'pitch_quick', 'additive',
                                        'artificial_reverb', 'time_dropout',
                                        'artificial_reverb_dropout',
                                        'natural_reverb'], nargs='+')
    group_augment.add_argument('--bandreject_scaler', type=float, default=1.0)
    group_augment.add_argument('--t_ms', type=int, default=100)
    group_augment.add_argument('--pathDBNoise', type=str, default=None)
    group_augment.add_argument('--pathSeqNoise', type=str, default=None)
    group_augment.add_argument('--past_equal_future', action='store_true')
    group_augment.add_argument('--pathImpulseResponses', type=str,
                               default=None)
    group_augment.add_argument('--impulse_response_prob', type=float,
                               default=1.0)
    group_augment.add_argument('--shift_max', type=float, default=300)
    group_augment.add_argument('--min_snr_in_db', type=float, default=5.0)
    group_augment.add_argument('--max_snr_in_db', type=float, default=20.0)
    group_augment.add_argument('--ir_sample_rate', type=int, default=16000)
    group_augment.add_argument('--temporal_additive_noise',
                               action='store_true')
    group_augment.add_argument('--meta_aug', action='store_true')
    group_augment.add_argument('--meta_aug_type', type=str,
                               choices=['none', 'natural_reverb'], nargs='+')
    group_augment.add_argument('--ir_batch_wise', action='store_true')
    group_augment.add_argument('--meta_ir_batch_wise', action='store_true')
    return parser


def set_port_config(parser: argparse.ArgumentParser
                    ) -> argparse.ArgumentParser:
    """The JAX package's framework flags (`cpc2_tpu/config.py:
    set_tpu_config`) with their names and defaults, plus `--device`."""
    group = parser.add_argument_group('Device configuration')
    group.add_argument('--device', type=str, default='cuda',
                       choices=['cuda', 'cpu'],
                       help='Where to train. cuda raises when no card is '
                       'present; cpu runs the kernels\' plain versions.')
    group.add_argument('--precision', type=str, default='bf16mix',
                       choices=['fp32', 'bf16mix', 'bf16'],
                       help='fp32: library matmuls and convolutions in full '
                       'fp32. bf16mix (default): in TF32. The hand-written '
                       'kernels compute in fp32 either way.')
    group.add_argument('--data_axis_size', type=int, default=-1)
    group.add_argument('--model_axis_size', type=int, default=1)
    group.add_argument('--dcn_axis_size', type=int, default=0)
    group.add_argument('--ckpt_format', type=str, default='torch',
                       choices=['torch', 'orbax'])
    group.add_argument('--profile_dir', type=str, default=None)
    group.add_argument('--remat', action='store_true',
                       help='XLA-only: accepted and ignored.')
    group.add_argument('--prng', type=str, default='rbg',
                       choices=['rbg', 'threefry'],
                       help='XLA-only: accepted and ignored.')
    group.add_argument('--augment_on_device', action='store_true')
    group.add_argument('--pitch_algo', type=str, default='wsola',
                       choices=['vocoder', 'wsola'])
    group.add_argument('--adam_mu_dtype', type=str, default='fp32',
                       choices=['fp32', 'bf16'])
    group.add_argument('--head_remat', nargs='?', const='nothing',
                       default=False, choices=['nothing', 'dots'],
                       help='XLA-only: accepted and ignored.')
    group.add_argument('--steps_per_dispatch', type=int, default=1,
                       help='XLA-only: only 1 is accepted.')
    group.add_argument('--global_negatives', action='store_true')
    group.add_argument('--neg_pool_group', type=int, default=0)
    group.add_argument('--host_prefetch', type=int, default=2,
                       help='XLA-only: accepted and ignored.')
    group.add_argument('--corpus_on_device', action='store_true',
                       help='XLA-only: only off is accepted.')
    return parser


def set_train_config(parser: argparse.ArgumentParser
                     ) -> argparse.ArgumentParser:
    """The trainer's own flags (`cpc2_tpu/train.py:918-990`)."""
    group_db = parser.add_argument_group('Dataset')
    group_db.add_argument('--pathDB', type=str, default=None)
    group_db.add_argument('--file_extension', type=str, default=".flac")
    group_db.add_argument('--pathTrain', type=str, default=None)
    group_db.add_argument('--pathVal', type=str, default=None)
    group_db.add_argument('--n_process_loader', type=int, default=8)
    group_db.add_argument('--ignore_cache', action='store_true')
    group_db.add_argument('--path_cache', type=str, default=None)
    group_db.add_argument('--max_size_loaded', type=int, default=4000000000)

    group_supervised = parser.add_argument_group('Supervised mode')
    group_supervised.add_argument('--supervised', action='store_true')
    group_supervised.add_argument('--pathPhone', type=str, default=None)
    group_supervised.add_argument('--CTC', action='store_true')

    group_save = parser.add_argument_group('Save')
    group_save.add_argument('--pathCheckpoint', type=str, default=None)
    group_save.add_argument('--logging_step', type=int, default=1000)
    group_save.add_argument('--save_step', type=int, default=5)

    group_load = parser.add_argument_group('Load')
    group_load.add_argument('--load', type=str, default=None, nargs='*')
    group_load.add_argument('--loadCriterion', action='store_true')
    group_load.add_argument('--restart', action='store_true')

    group_gpu = parser.add_argument_group('GPUs')
    group_gpu.add_argument('--nGPU', type=int, default=-1,
                           help='Devices to use; the port trains on one.')
    group_gpu.add_argument('--batchSizeGPU', type=int, default=8)
    parser.add_argument('--debug', action='store_true')

    group_dist = parser.add_argument_group('Distributed training')
    group_dist.add_argument('--distributed', action='store_true')
    group_dist.add_argument("--local_rank", type=int, default=-1)
    group_dist.add_argument("--master_port", type=int, default=-1)
    return parser


# Features not ported yet: flag -> (is it set away from its default?,
# the ROADMAP.md item that ports it).
CONCATENATION = "Multi-checkpoint concatenation"
_PROFILE = "Step profiling (--profile_dir)"
_DDP = "Data-parallel training (DDP)"
_NEG_POOLS = "Negative pools across or within devices"
_BF16 = "bf16 precision"
_COMPRESSED = "FLAC and compressed audio"
_AUGMENT = "Augmentation"
_VARIANTS = "Other model and criterion modes"
_UNPORTED = (
    ('load', lambda v: v is not None and len(v) > 1, CONCATENATION),
    ('profile_dir', lambda v: v is not None, _PROFILE),
    ('distributed', bool, _DDP),
    ('nGPU', lambda v: v > 1, _DDP),
    ('data_axis_size', lambda v: v > 1, _DDP),
    ('model_axis_size', lambda v: v != 1, _DDP),
    ('dcn_axis_size', lambda v: v > 1, _DDP),
    ('global_negatives', bool, _NEG_POOLS),
    ('neg_pool_group', bool, _NEG_POOLS),
    ('precision', lambda v: v == 'bf16', _BF16),
    ('adam_mu_dtype', lambda v: v != 'fp32', _BF16),
    ('augment_past', bool, _AUGMENT),
    ('augment_future', bool, _AUGMENT),
    ('meta_aug', bool, _AUGMENT),
    ('augment_on_device', bool, _AUGMENT),
    ('supervised', bool, _VARIANTS),
    ('cpc_mode', lambda v: v is not None, _VARIANTS),
    ('encoder_type', lambda v: v != 'cpc', _VARIANTS),
    ('rnnMode', lambda v: v != 'transformer', _VARIANTS),
    ('multihead_rnn', bool, _VARIANTS),
    ('mask_prob', lambda v: v > 0, _VARIANTS),
    ('signal_quality_path', lambda v: v is not None, _VARIANTS),
)


def _raise_unported(args: argparse.Namespace, entries) -> None:
    for name, is_set, item in entries:
        if is_set(getattr(args, name)):
            raise NotImplementedError(
                f"--{name} {getattr(args, name)!r}: not ported to cpc2_torch "
                f"(ROADMAP.md item: {item})")


_MODEL_FLAGS = ('cpc_mode', 'encoder_type')


def check_model_ported(args: argparse.Namespace) -> None:
    """Raise `NotImplementedError` when the architecture flags (a
    checkpoint's saved ones, say) name a model that is not ported."""
    _raise_unported(args, [u for u in _UNPORTED if u[0] in _MODEL_FLAGS])
    if args.arMode not in ('GRU', 'LSTM', 'RNN', 'no_ar', 'transformer'):
        raise ValueError(f"unknown arMode {args.arMode!r}")


def check_ported(args: argparse.Namespace) -> None:
    """Raise `NotImplementedError` for a flag whose feature is not ported."""
    _raise_unported(args, _UNPORTED)
    if args.steps_per_dispatch != 1 or args.corpus_on_device:
        raise ValueError("--steps_per_dispatch > 1 and --corpus_on_device "
                         "mean something to XLA only; the port takes one "
                         "step per dispatch from host batches")
    if args.file_extension.lower() != '.wav':
        raise NotImplementedError(
            f"--file_extension {args.file_extension}: cpc2_torch reads WAV "
            f"only (ROADMAP.md item: {_COMPRESSED})")


def get_default_cpc_config() -> argparse.Namespace:
    """The architecture flags at their defaults (what a checkpoint's
    `checkpoint_args.json` is merged into)."""
    return set_default_cpc_config(argparse.ArgumentParser()).parse_args([])


def parse_args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    """The trainer's command line, checked as `cpc2_tpu.train.parse_args`
    checks it, plus `check_ported`. Without `--pathDB`, a run resumes from
    `--pathCheckpoint` with the corpus and flags saved there; `train.main`
    checks those once it has read them."""
    parser = argparse.ArgumentParser(description='CPC trainer (PyTorch)')
    set_default_cpc_config(parser)
    set_port_config(parser)
    set_train_config(parser)
    args = parser.parse_args(argv)
    if args.pathDB is None and (args.pathCheckpoint is None or args.restart):
        parser.error("--pathDB is required unless --pathCheckpoint names a "
                     "run to resume")
    if args.pathDB is not None:
        check_ported(args)
    if args.pathCheckpoint is not None:
        args.pathCheckpoint = os.path.abspath(args.pathCheckpoint)
    if args.load is not None:
        args.load = [os.path.abspath(x) for x in args.load]
    if args.samplingType == "temporalsamespeaker":
        if args.pathTrain is not None or args.pathVal is not None:
            raise ValueError("Can not apply temporal sampling (with same "
                             "speaker) if pathTrain or pathVal is specified.")
        if args.naming_convention not in [
                'id_spkr_onset_offset',
                'id_spkr_onset_offset_spkr_onset_offset', 'spkr-id',
                'spkr_id_nb', 'spkr-id-nb', 'no_speaker', 'full_seedlings']:
            raise ValueError("If you want to use temporalsamespeaker "
                             "sampling type, you must set naming_convention "
                             "accordingly.")
    if args.random_seed is None:
        args.random_seed = random.randint(0, 2 ** 31)
    if args.arMode == 'no_ar':
        args.hiddenGar = args.hiddenEncoder
    return args
