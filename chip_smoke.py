"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run with a nonzero exit:

1. print the card's name and power limit (`nvidia-smi`);
2. build the CUDA kernels from `cpc2_torch/csrc` (`cpc2_torch/ops/_build.py`)
   and check with `cuobjdump --dump-sass` that the FFN's GEMM kernels and
   the encoder's conv products are `wgmma` products fed by TMA (HGMMA and
   UTMALDG in their SASS; the fp32 route's HGMMA in TF32), that the
   attention kernels' products are HMMA in TF32, and that the fp32 FFN's,
   the encoder's, the attention's and the DTW kernels spill nothing;
3. hold each kernel against its plain PyTorch version at the recipe's
   shapes (B = 8, T = 128, H = 256, K = 12, W = 116, N = 128, D = 256,
   P = 1,024, FFN 256 -> 2048 -> 256 on 928 rows, attention 64 units of
   116 x 32, encoder 16 x 20,480 samples at C = 256), forward and
   backward, the FFN (both routes, and two ragged shapes, each route's
   backward bit-identical across two calls at the recipe; the fp32 route
   also at widths that are not multiples of 4 and at one row, and an
   empty batch launching nothing) and the attention at dropout 0 and 0.1
   with the same seed
   (also at four ragged shapes and at four widths taken in chunks of dk,
   its backward bit-identical across two calls and an empty batch
   launching nothing),
   the FFN's bf16 route and the encoder in their bf16 working type (the
   encoder also at N = 3, T = 1,120 with C = 32 and 128, held against a
   float64 reference that takes its own bf16 and ReLU decisions, and its
   backward bit-identical across two calls; its device time split into
   layers 2-5's products, norms, sums and layer 1), and the
   DTW kernel's two routes at one ABX flush (18,432 pairs of 32 x 32
   frames), a ragged 16 x 64, a multi-strip 64 x 64, its 2,048 x 2,048
   limit and `DTW_SHAPES` (a real flush's layout, each route's widths and
   kernels, S1 != S2 both ways, tie-heavy draws, 4-byte copies), where they
   must be bit-identical, each shape's plan held to the kernels' own
   layout and its launch counted under its route, and P = 0 launching
   nothing; the LSTM's two routes, the resident cluster
   kernels at the recipe, at ABX batches (4 and 16 files of 400 frames)
   and a ragged one, the grid kernels at H = 512 (the training batch, a
   short one and ABX batches of 1 and 16 files), at H = 510, at the recipe
   and at H = 1,400 (W_hh read from L2), each with its plan held to the
   kernels' own layout, every backward bit-identical across two calls;
   then time the kernel, the plain version
   and, where one PyTorch call computes the same function, that call (for
   the FFN's two routes, InfoNCE, the attention and the encoder, which no
   one call computes, the same work through library calls as a yardstick;
   the FFN, InfoNCE, the attention, the encoder, the LSTM and DTW by device
   time, the LSTM's backward split by kernel, several of its cluster and
   batch tiles side by side, and the grid route's ms per time step at H =
   256, 512 and 1,024);
   InfoNCE also at a ragged shape, a 4,096-row pool, N = 10 and 384, K = 40
   with a ragged D above a stage, a large D, one (b, w) and an empty
   shape, its backward bit-identical across two calls;
4. hold one whole training step on the card (kernels) against the same step
   on the CPU (plain versions) at a small width, same weights, same
   negatives, dropout off: under `--precision fp32` (the FFN's fp32
   kernels), under `bf16mix` (its bf16 kernels), under `bf16mix` with
   CPC2_FUSED_ATTENTION=1 and CPC2_FUSED_ENCODER=1, and under `bf16mix` at
   a 512-wide encoder and LSTM (the LSTM's grid route); then run the
   recipe's default step three times on the same weights, batch and draws
   and report which losses or gradients differ between the passes
   (`[determinism]`: a report, which fails nothing), and the same for a
   `--supervised --pathPhone --CTC` step at the CLI defaults (torch's CUDA
   `ctc_loss` backward adds with atomics: a report too);
5. write a synthetic 16 kHz corpus in LibriSpeech layout as 16-bit FLAC
   (with an encoder of its own, `encode_flac`), and the same samples as
   WAV; every FLAC file must decode through `cpc2_torch.data.audio_io` bit
   for bit to the samples it was written from; time the loading of each
   corpus (`AudioBatchData`, the host's decoding); then run
   `cpc2_torch.train.main` at the CLI defaults on the FLAC corpus for one
   epoch (batch 8 x 20,480 samples, 256-d, LSTM, 12 transformer heads, 128
   negatives, `bf16mix`, `--file_extension .flac`) with `--pathCheckpoint`,
   with every kernel's launch count set to 0 just before and read just
   after: the resident LSTM, InfoNCE and bf16 FFN kernels must have
   launched and the fp32 FFN, attention, encoder and grid LSTM kernels must
   not, the losses must be finite, the parameters must live on the card
   and the checkpoint files must exist;
   then one more epoch with both variables set (and restored after),
   which must launch all ten training kernels, one with `--precision
   fp32`, which must launch the FFN's fp32 kernels and not its bf16 ones,
   one with `--hiddenEncoder 512 --hiddenGar 512` (`wide`), which must
   launch the grid LSTM, bf16 FFN and InfoNCE kernels and not the resident
   LSTM ones, and one more default epoch with `--profile_dir`
   (`profiled`), held as the default one, whose trace must exist and name
   the LSTM's, InfoNCE's and the bf16 FFN's kernels (its ten largest
   device entries and the host's share of the window are printed);
   resume: two epochs from scratch in one directory, and the default
   epoch's directory resumed to two in another; every tensor of the two
   `checkpoint_1.pt` must agree within the bf16mix step tolerance
   (FUSED_GRAD_NORM_TOL in the 2-norm, lin1's FFN_LIN1_GRAD_NORM_TOL; the
   generator's state equal), and whether they are bit for bit equal is
   printed;
   augmentation (run after the corpus is written, before the epochs): a
   noise corpus and impulse responses synthesised from a seed
   (`write_sounds`); `[augment]` holds each device augmentation
   (`cpc2_torch/data/augment_device.py`, 11 rows: every `--augment_type`
   and both pitch algorithms) at 8 x 20,480 on the card against the same
   draws on the CPU (AUGMENT_RTOL of the peak, the WSOLA segment positions
   equal) and against the host pipeline (`host_reference`), and times the
   augmented epochs' chain for one step; `[determinism]` runs again with
   that chain on the device; the epochs above are followed by three on
   `train_db_part` (a FLAC file a speaker) with AUGMENT_TYPES on both
   views, `augmented_host` (`--host_prefetch 2`),
   `augmented_host_noprefetch` (`--host_prefetch 0`) and
   `augmented_device` (`--augment_on_device`), each held as the default
   epoch (its kernels launched, the others not, finite losses),
   their median ms/step, wait for a batch, host ms a batch and audio-hours
   per hour printed on `[augmented epochs]`;
   the graph route (`[dispatch]`, `cpc2_torch/training.py:MultiStep`):
   the capturable Adam against optax's formula in float64 (1e-4 of the
   largest update); at the recipe in DISPATCH_SETUPS (default, both
   opt-in kernels, `fp32`, 512 wide: the grid LSTM, the device
   augmentation chain, and `--supervised` on speakers), from one seeded
   state, 3 groups of DISPATCH_N steps gathered from a resident pack as
   graph replays (the third at half the learning rate, captured again)
   against the same steps eagerly: the losses, every parameter, Adam's
   moments and counts and both generators' states bit for bit (else the
   differing tensors named and held to DISPATCH_*_ATOL), each kernel's
   launches a replay N times an eager step's, the setup's kernels
   launched inside the graph, and each route's group time and peak memory
   printed; then CLI epochs with
   DISPATCH_FLAGS (`dispatch`; `dispatch_augmented` with the
   `augmented_device` epoch's flags on `train_db`, beside
   `device_augmented`, the same at N = 1; `dispatch_schedule`, two epochs
   across an `--schedulerStep 1` halving) held against the same epochs at
   N = 1 from host batches (`[dispatch epochs]`: the route, its captures,
   the epoch means bit for bit, since every training run on the card
   updates with the capturable Adam); `[resume N=4]` as `[resume]`
   on the graph route; and `[dispatch timings]`: the default training on
   a 36-step corpus in a fresh process each for N = 1 from host batches,
   N = 1 from the resident pack, N = 4 and N = 8, two epochs in turn, and
   then N = 4 for one epoch under a device-only profiler (median ms/step,
   the second epoch's mean, ms to dispatch, peak memory, the graph
   route's busy share);
6. write a phone corpus with its `.item` file (4 speakers x 8 files x 24
   tokens) and run `cpc2_torch.eval.eval_ABX.main from_checkpoint` on the
   checkpoint of phase 5 at its defaults, the counts again set to 0 just
   before and read just after: the DTW kernel (on its lane route) and the
   resident LSTM forward kernel must have launched, the grid LSTM ones
   not, and both scores must lie in [0, 1]; then score the same
   features on the card with the kernel and with the plain DTW (identical
   scores), and hold two files' features card against CPU;
   then load the default and the wide epochs' checkpoints as one
   concatenated model (256 + 512 wide): its features on the card must
   match the CPU's within rtol 1e-3 and equal, channel by channel, each
   model's own, and the resident and grid LSTM forward kernels must both
   have launched; the phone corpus's per-frame labels (`phone_labels_path`)
   are written beside it;
7. the supervised path: each supervised criterion (speaker, adversarial
   speaker with and without labels, phone at 1 and 3 levels, CTC) forward
   and backward on the card against the CPU at B = 8, T = 128, H = 256
   (`[supervised criteria]`, CTC at CTC_RTOL); `fused_lstm` at the
   recipe without gradients, which must launch the forward only and keep
   no more than its outputs (`[supervised lstm]`); one `--supervised` step
   (speaker, phone, CTC) card against CPU at width 64 under `fp32`
   (`[supervised step ...]`); one epoch of `cpc2_torch.train.main
   --supervised` at the CLI defaults for speakers (the FLAC corpus), phones
   and CTC (the phone corpus with `--pathPhone`), each with the launch
   counts set to 0 just before and read just after: the resident LSTM
   kernels must launch and no InfoNCE, FFN, attention, encoder or grid
   LSTM kernel, the losses must be finite, the accuracies in [0, 1], the
   checkpoint must hold the head (`[supervised]`); then
   `cpc2_torch.eval.linear_separability.main` for one epoch on the default
   epoch's checkpoint, speaker frozen, phone frozen, phone `--unfrozen` and
   `--CTC`: a frozen probe must launch `lstm_fwd` and no `lstm_bwd`, an
   unfrozen one both, the accuracy must lie in [0, 1] and the logs exist
   (`[probe]`); the phase's wall seconds on `[phase 7]`;
8. the discrete-unit path on the default epoch's checkpoint (`run_units`),
   each card run with the launch counts set to 0 just before and read just
   after, none of which may launch `lstm_bwd`, InfoNCE, the encoder's or
   (but `CPCModule`'s fp32 route) the FFN's kernels:
   `cpc2_torch.clustering.clustering_script.main` at its defaults (-k 50,
   --batchSizeGPU 50, --sizeWindow 10240) on the FLAC corpus, its 50 start
   rows drawn from the features (`-n 0`), then KMEANS_ITERS iterations from
   them twice on the card (`lstm_fwd` launched; the two bit for bit) and
   once with `--device cpu`, seconds an iteration from each run's log
   (`[units k-means]`); `--getDistanceEstimation`, which must end in a
   clean `sys.exit()`, and `--DPMean` at the distances' median on the card
   and the CPU, the same number of clusters (`[units dp-means]`). Both fits
   record their features, and `audit_fit` holds the CPU to the card at
   every iteration: from the card's centroids the CPU makes the card's
   decisions but at near ties, and with them gives the card's next
   centroids within 1e-4 of the largest; the last centroids of the two
   fits agree within 1e-4 where the fits made the same decisions
   throughout (a near tie parts their paths for good); `clustering_quantization.main` of the phone
   corpus, batched and `--nobatch`, card against CPU: the same ids but at
   near ties (two centroids within UNIT_GAP of the nearest squared
   distance), counted (`[units quantization]`);
   `eval.eval_ABX_clustering.main` with `--clustering` and `--quantized`,
   which must launch the DTW kernel on its lane route (and `lstm_fwd`),
   scores in [0, 1] and equal with the plain DTW (`[units abx]`);
   `eval.build_zeroSpeech_features.main` with `--clusters` and with
   `--dimReduction` (a PCA of `research.dim_reduction.main`), and
   `CPCModule` on the checkpoint's model and criterion, which must launch
   `ffn_fwd_fp32` and not `ffn_fwd`, card against CPU within UNIT_RTOL
   (`[units export]`); the phase's wall seconds on `[phase 8]`;
9. Common Voices CTC phone recognition and PER, the hub entry and the
   host DTW on the default epoch's checkpoint (`run_common_voices`): the
   host DTW (`ops/dtw_host.py`) bit for bit the DTW kernel on one ABX
   flush (`[dtw host]`); `fused_lstm`'s resident route at (8, 1,000, 256),
   a batch of 10 s utterances, against `lstm_plain` (`[cv lstm]`); a
   synthetic Common Voice-like corpus (`write_cv_corpus`: 40 training WAV
   utterances of 2-10 s, 4 validation ones of 2-6 s, 12 phones a second
   from 40); one `CVSteps` step card against CPU, frozen with `--LSTM
   --seqNorm` and unfrozen, the loss and gradients at CTC_RTOL (unfrozen:
   the encoder's ReLU inputs at RTOL, then against a float64 CPU step
   with the card's ReLU decisions) and the parameters after the step at
   CV_PARAM_NORM_TOL (`[cv step ...]`);
   `common_voices_eval.main train` for one epoch frozen with `--LSTM
   --seqNorm` and unfrozen with `--LSTM`, every training and validation
   step launching exactly its LSTM kernels (`CV_STEP_LAUNCHES`), and `per`
   on the frozen run's checkpoint on the card and the CPU, the posteriors
   within CV_POSTERIOR_ATOL and each utterance's PER equal but at counted
   near ties (`[cv epochs]`, `[cv per]`, `[cv launches]`);
   `hub.CPC_audio` on a payload of the checkpoint bit for bit
   `load_model`'s features, and at its defaults a 256-d model on the card
   whose forward launches `lstm_fwd` (`[hub]`); the phase's wall seconds
   on `[phase 9]`;
10. the model and criterion modes (`run_variants`): the FFN kernels at
   the multi-head trunk's 928 x 256 -> 2048 -> 3,072 (both routes, dropout
   0 and 0.1, each backward bit for bit across two calls) and the resident
   LSTM at an LSTM head's (8, 116, 256) against their plain versions,
   timed beside the library route and the bound, in a fresh process where
   the profiler keeps every launch (`[variant kernels]`);
   one training step per flag value (VARIANT_STEPS: every `--rnnMode`,
   `--multihead_rnn` and `--encoder_type mfcc` also under `bf16mix`,
   `--cpc_mode reverse|bert|none`, `--encoder_type mfcc|lfb`,
   `--mask_prob`, signal quality) card against CPU at the recipe's widths
   (the MFCC step under `fp32` against a float64 CPU step with the card's
   ReLU decisions, `relu_matched_reference`), its launches held exactly to
   `variant_launches` (`[variant step ...]`); one CLI epoch per group
   (VARIANT_EPOCHS; `mask_quality` on the WAV corpus with `write_quality`'s
   `.pt` files), the counts set to 0 just before and read just after and
   held exactly to the steps' (`[variant epoch ...]`); `--steps_per_dispatch
   4` replays with masks (and quality) bit for bit against eager steps
   (`[variant dispatch ...]`); `eval_ABX from_checkpoint` on the reverse
   and MFCC epochs' checkpoints, features card against CPU within 1e-3
   (`[variant abx ...]`); the LFB step's `[determinism]`; the phase's wall
   seconds on `[phase 10]`;
11. `--precision bf16` and `--adam_mu_dtype bf16` (`run_bf16`): the
   bf16-io FFN and attention kernels, the wide attention kernels beside
   their torch route, the bf16-moment Adam, steps, a replay, epochs and a
   resume; the phase's wall seconds on `[phase 11]`;
12. grouped negative pools (`run_neg_pool`): the InfoNCE kernels on a
   grouped plan at NEG_POOL_SHAPES against their plain version, dz bit
   for bit across two calls, and at batch 64 in groups of 8 the whole
   pool's plan held against the grouped one, each timed beside the plain
   version, the library route, the bound and batch 8's kernels, in a
   fresh process (`[neg pool kernels]`); one step at batch 16 in groups of
   8 card against CPU (`[neg pool step]`); one epoch of NEG_POOL_FLAGS on
   a 24-minute WAV corpus, every launch held exactly to its batches
   (`[neg pool epoch]`); an N = 4 replay at batch 64 bit for bit against
   eager steps (`[neg pool dispatch]`); the phase's wall seconds on
   `[phase 12]`;
13. what feature extraction lacked, and the clustering criteria
   (`run_feature_extras`): `FeatureModule(train_mode=True)` on a
   transformer-context model at the recipe's widths (8 x 20,480 samples,
   width 256, dropout 0.1) with the plain attention and with
   CPC2_FUSED_ATTENTION=1, two calls differing, a second instance of the
   seed replaying them bit for bit, every FFN and fused attention forward
   held against `ffn_plain` / `attention_plain` with its dropout seed, the
   kernels' launches in those calls, rate 0 bit for bit evaluation's, the
   model unchanged (`[train_mode]`); `research/train_cca.py` between the
   default epoch's checkpoint and a seed-1 one of its flags, fitted on the
   card and in float64 on the CPU within CCA_TOL, the CLI on the card and
   `FeatureModule(cca_projection=...)` on its pickle (`[cca]`, the fit's
   seconds); `build_feature_files` over ragged files without and with
   `bucket_frames`, card against CPU, one `lstm_fwd` a batch
   (`[buckets]`); one DEC centroid update and one DeepClustering loss card
   against CPU (`[clustering criteria]`); the phase's wall seconds on
   `[phase 13]`;
14. data-parallel training (`run_data_parallel`): the default epoch and
   the N = 4 epoch again with `--distributed` as the one rank of a NCCL
   group (WORLD_SIZE=1), each step's losses, the checkpoint and every
   kernel's launches bit for bit the runs without it, both ms/step
   (`[dp nccl default]`, `[dp nccl dispatch]`); two ranks sharing cuda:0
   over `gloo` (`CPC2_DIST_BACKEND=gloo`), each a fresh process: its
   `all_reduce` and `broadcast` of CUDA tensors (`[dp gloo
   collectives]`), DP_STEPS steps at the recipe from the same weights and
   negatives against the single process at batch 16 with
   `--neg_pool_group 8`, and with `--global_negatives` against batch 16
   over the whole pool, `fp32` at 1e-3 and `bf16mix` at the step rules,
   the ranks bit for bit (`[dp steps ...]`), then one epoch of the CLI
   with `--distributed --global_negatives` on DP_DB, each rank its share
   of the files and its short batches in weighted rounds, the gathered
   InfoNCE kernels launched on each (`[dp epoch]`); the gathered-pool
   kernels at GATHERED_SHAPE against their plain version, timed beside
   the library route and the bound, on rank 0 after its epoch (`[dp
   kernels]`); the ranks start while the NCCL epochs run; the phase's
   wall seconds on `[phase 14]`;
15. print one `kernels` JSON line (the `lstm_fwd`, `dtw` and
   `ffn_fwd_fp32` rows with their launches on the unit path,
   `launches_discrete_units`, the LSTM rows' on the Common Voices
   path, `launches_common_voices`, each training kernel's over phase
   10's epochs, `launches_variants`, the grouped InfoNCE rows' on
   phase 12's epoch, the rows of the kernels phase 13's paths ran,
   `launches_feature_extras`, and the gathered InfoNCE rows' on rank 0
   of phase 14's two-rank epoch) and, last, the `ok` line.

It exits nonzero, printing no result, when no CUDA card is available or
when the `cpc2_torch` package is not beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import glob
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 (non-tensor-core) peak and
# dense bf16 and TF32 tensor-core peaks. Most hand-written kernels compute
# in fp32 on the FMA units; the products of the encoder and of the FFN's
# bf16 route take bf16 operands, so their bounds are reckoned at the bf16
# rate; InfoNCE's products and the FFN's fp32 route's run in 3xTF32 (three
# TF32 products for one at fp32 accuracy), a third of the TF32 rate. A
# product of a bf16 operand and an fp32 one needs two TF32 products (the
# bf16 side has no low part), half the TF32 rate.
MEMORY_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32X3_FLOP_PER_S = 495e12 / 3
TF32X2_FLOP_PER_S = 495e12 / 2

# Tolerances of kernel against plain version: fp32 sums in another order.
# An error passes when it is at most ATOL + RTOL * max|plain|.
RTOL, ATOL = 1e-4, 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of `fn` on the card, by CUDA events over `iters`
    calls after `warmup` calls (`cpc2_torch.time_kernels.event_ms`)."""
    from cpc2_torch.time_kernels import event_ms
    return event_ms(fn, iters, warmup)


# The key of a `device_split` timed by CUDA events because every profile
# lost the kernels
EVENTS_KEY = "events (the profiler lost the kernels)"


def device_split(fn, iters: int = 20, warmup: int = 3,
                 expect: str = "") -> dict:
    """Device ms per call of `fn` by kernel name, by `torch.profiler`, over
    `iters` calls after `warmup` calls, a lossy profile (or, with `expect`,
    one that holds no kernel of that name) taken again
    (`cpc2_torch.time_kernels.device_split`). Where every profile lost
    more than half the kernels (an InfoNCE forward did so 6 times running
    on an H100 80GB HBM3 under torch 2.11), the calls are timed by CUDA
    events instead, the host's path included, under EVENTS_KEY, and a
    `[profiler]` line says so."""
    from cpc2_torch.time_kernels import ProfilerLostKernels
    from cpc2_torch.time_kernels import device_split as split
    try:
        return split(fn, iters, warmup, expect=expect)
    except ProfilerLostKernels as lost:
        ms = cuda_ms(fn, iters, 0)
        log(f"[profiler] {lost}: timed by CUDA events instead, {ms:.4f} ms "
            f"a call (the host's path included)")
        return {EVENTS_KEY: ms}


def device_ms(fn, iters: int = 20, warmup: int = 3,
              expect: str = "") -> float:
    """Device time per call of `fn`: the sum of the device times of the
    kernels it launches (`device_split`). Where a call's device work is
    shorter than its host path (autograd, allocations, several launches),
    CUDA events around back-to-back calls (`cuda_ms`) time the host
    instead."""
    return sum(device_split(fn, iters, warmup, expect).values())


def bound_ms(n_bytes: float, flops, peak: float = FP32_FLOP_PER_S):
    """Least time for the work: bytes over the memory rate or operations
    over the peak for their type, whichever is larger, and which one it
    is. `flops` is a count at `peak`, or a list of (count, peak) pairs for
    products of several operand types."""
    t_bytes = n_bytes / MEMORY_BYTES_PER_S * 1e3
    work = flops if isinstance(flops, list) else [(flops, peak)]
    t_ops = sum(f / p for f, p in work) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name: str, got, want, rtol: float = RTOL) -> float:
    """Max abs error of `got` against `want` (sequences of tensors); raise
    when any pair is outside the tolerance."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape:
            raise AssertionError(f"{name}[{i}]: shape {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}")
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}[{i}]: non-finite values")
        err = (g.double() - w.double()).abs().max().item()
        scale = w.double().abs().max().item()
        if err > ATOL + rtol * scale:
            raise AssertionError(f"{name}[{i}]: max abs err {err:.3e} vs "
                                 f"max |plain| {scale:.3e}")
        worst = max(worst, err)
    return worst


def norm_rel(got, want) -> float:
    """|got - want| / |want| in the 2-norm."""
    return ((got.double() - want.double()).norm()
            / want.double().norm().clamp_min(1e-30)).item()


def grads_of(fn, inputs, cotangents):
    """(outputs, gradients of sum(out * cot) w.r.t. inputs, a function
    that recomputes those gradients on the retained graph)."""
    leaves = [x.detach().requires_grad_(True) for x in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)

    def backward():
        return torch.autograd.grad(outs, leaves, cotangents,
                                   retain_graph=True)
    return [o.detach() for o in outs], backward(), backward


def kernel_entry(name, source, replaces, err, ms, plain_ms, library_ms,
                 n_bytes, flops, peak=FP32_FLOP_PER_S):
    bound, by = bound_ms(n_bytes, flops, peak)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms}


def check_sass(build) -> str:
    """The GEMM kernels must be `wgmma` products fed by TMA: the bf16 FFN
    route's, the bf16-io FFN route's blocks' (`ffn_io_hidden`,
    `ffn_io_split`) and the encoder's conv products' SASS holds HGMMA and
    UTMALDG, the fp32 FFN route's HGMMA in TF32 (an HGMMA line naming
    TF32) and UTMALDG; the attention kernels' `mma.sync` products are HMMA
    in TF32 (an HMMA line naming TF32) on TMA boxes (UTMALDG: the bf16-io
    instantiations' too); the fp32 FFN's, the bf16-io FFN's, the
    encoder's, the attention's and the DTW routes' kernels (the lane
    route's ten) spill nothing. Returns a summary with each one's registers
    and spills from the build log."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(build.LIBRARY)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    found = {"ffn_wgmma_gemm": [], "ffn_tf32x3_gemm": [],
             "ffn_io_hidden": [], "ffn_io_split": [],
             "conv_wgmma_gemm": [], "attention_fwd_mma": [],
             "attention_bwd_mma": [], "attention_fwd_wide": [],
             "attention_bwd_wide": []}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split(None, 1)[0]
        kind = next((k for k in found if k in name), None)
        if kind is None:
            continue
        if kind.startswith("attention"):
            missing = ([] if any("HMMA" in line and "TF32" in line
                                 for line in fn.splitlines()) else [
                                     "HMMA ... TF32"]) + (
                [] if "UTMALDG" in fn else ["UTMALDG"])
        else:
            missing = [op for op in ("HGMMA", "UTMALDG") if op not in fn]
        if kind == "ffn_tf32x3_gemm" and not any(
                "HGMMA" in line and "TF32" in line
                for line in fn.splitlines()):
            missing.append("HGMMA ... TF32")
        if missing:
            raise AssertionError(f"{name}: no {missing} in its SASS")
        found[kind].append(name)
    for kind, least in (("ffn_wgmma_gemm", 5), ("ffn_tf32x3_gemm", 3),
                        ("ffn_io_hidden", 1), ("ffn_io_split", 3),
                        ("conv_wgmma_gemm", 2), ("attention_fwd_mma", 3),
                        ("attention_bwd_mma", 3), ("attention_fwd_wide", 1),
                        ("attention_bwd_wide", 1)):
        if len(found[kind]) < least:
            raise AssertionError(f"only {len(found[kind])} {kind} kernels "
                                 f"in the SASS: {found[kind]}")
    usage = {kind: ptxas_usage(build, kind)
             for kind in [*found, "dtw_lanes", "dtw_wave"]}
    if len(usage["dtw_lanes"]) != 10 or len(usage["dtw_wave"]) != 1:
        raise AssertionError(f"the DTW kernels in the build log: "
                             f"{usage['dtw_lanes'] + usage['dtw_wave']}")
    attention = [k for k in found if k.startswith("attention")]
    spilled = [u for kind in ["ffn_tf32x3_gemm", "ffn_io_hidden",
                              "ffn_io_split", "conv_wgmma_gemm",
                              "dtw_lanes", "dtw_wave"] + attention
               for u in usage[kind] if not u.endswith(" 0 spill bytes")]
    if spilled:
        raise AssertionError(f"kernels spill: {spilled}")
    return (f"{len(found['ffn_wgmma_gemm'])} bf16 FFN GEMM kernels, each "
            f"with HGMMA and UTMALDG; {len(found['ffn_tf32x3_gemm'])} fp32 "
            f"(3xTF32) ones, each with HGMMA in TF32 and UTMALDG; "
            f"{len(found['ffn_io_hidden']) + len(found['ffn_io_split'])} "
            f"bf16-io FFN blocks, each with HGMMA and UTMALDG; "
            f"{len(found['conv_wgmma_gemm'])} encoder conv products, each "
            f"with HGMMA and UTMALDG; "
            f"{sum(len(found[k]) for k in attention)} attention kernels "
            f"(bf16-io included), each with HMMA in TF32 and UTMALDG; "
            f"ptxas: "
            + " | ".join(u for lines in usage.values() for u in lines))


# The LSTM's routes against `lstm_plain`, forward and all five gradients:
# the resident cluster kernels at the recipe, at ABX feature batches (4 and
# 16 files of 400 frames) and at a ragged batch; the grid kernels at the
# recipe forced onto the grid route, a short 512-wide batch, a 512-wide
# model's training batch and its ABX batches (1 and 16 files of 400 frames,
# with a carried state), a width off 4 with a ragged last CTA, and a width
# whose W_hh slice is read from L2 (H = 1,400: 11 units a CTA). The first
# two grid shapes draw from the run's generator, where the per-step route's
# two shapes drew before, so that every later check draws what it drew
# before; the others from a generator of their own.
LSTM_RESIDENT_SHAPES = ((8, 128, 256), (4, 400, 256), (16, 400, 256),
                        (5, 37, 256))
LSTM_GRID_SHAPES = ((8, 128, 256), (8, 32, 512), (8, 128, 512),
                    (1, 400, 512), (16, 400, 512), (3, 50, 510),
                    (4, 16, 1400))
# (cluster size, batch tile) pairs of the resident route timed side by side
LSTM_TILES = {(8, 128, 256): ((16, 1), (16, 2), (8, 1), (8, 8)),
              (4, 400, 256): ((16, 1), (16, 4), (8, 1), (8, 4))}
# widths at which the grid route's device ms per time step is printed
LSTM_GRID_WIDTHS = (256, 512, 1024)


def ptxas_usage(build, fragment: str) -> list:
    """'name: N registers, S spill bytes' of each kernel in the build log
    whose mangled name holds `fragment`, template arguments shown."""
    import re
    lines = (build.BUILD_DIR / "build.log").read_text().splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Function properties" not in line or fragment not in line:
            continue
        targs = re.search(r"I((?:L[ib]\d+E)+)E", line)
        name = fragment + (
            f"<{','.join(re.findall(r'L[ib](\d+)E', targs[1]))}>"
            if targs else "")
        spill = re.findall(r"(\d+) bytes spill stores", lines[i + 1])
        regs = re.findall(r"Used (\d+) registers", lines[i + 2])
        out.append(f"{name}: {regs[0] if regs else '?'} registers, "
                   f"{spill[0] if spill else '?'} spill bytes")
    return sorted(out)


def check_grid_layout(lib, plan, b, h, sms) -> list:
    """The grid plan's layout against `cpc2_lstm_grid_layout`, the kernels'
    own, both directions; returns how many CTAs an SM holds of each."""
    import ctypes
    per_sm = []
    for backward, layout in ((0, plan.fwd), (1, plan.bwd)):
        out = (ctypes.c_int * 8)()
        rc = lib.cpc2_lstm_grid_layout(b, h, sms, backward, out)
        want = [plan.ctas, plan.units, *layout]
        if rc != 0 or list(out)[:7] != want:
            raise AssertionError(f"grid_plan({b}, {h}, {sms}) "
                                 f"{'bwd' if backward else 'fwd'} {want}, the "
                                 f"kernels' {list(out)[:7]} (rc {rc})")
        if out[7] < 1:
            raise AssertionError(f"no CTA of the grid kernel at ({b}, {h}) "
                                 f"fits an SM")
        per_sm.append(out[7])
    return per_sm


def check_lstm(dev, gen):
    """Both LSTM routes against `lstm_plain` (LSTM_RESIDENT_SHAPES,
    LSTM_GRID_SHAPES), each backward bit-identical across two calls, the
    grid plan against the kernels' own layout, then the resident kernels at
    the recipe (8, 128, 256) and the grid kernels at (8, 128, 512), each
    beside the plain version and cuDNN at its shape, timed by device time
    (events beside), the backward's dW_hh product alone, the LSTM_TILES
    choices and the grid route's ms per time step at LSTM_GRID_WIDTHS.
    Prints the kernels' `-Xptxas -v` registers and spills and how many
    clusters (CTAs) the card holds at once on an `[lstm]` line."""
    from cpc2_torch.ops import _build
    from cpc2_torch.ops.lstm import (_LSTMGrid, _LSTMResident, grid_plan,
                                     lstm_plain, lstm_plan)
    from cpc2_torch.time_kernels import cudnn_lstm, lstm_inputs
    lib = _build.library()
    sms = _build.sm_count(dev)
    own = torch.Generator(device=dev)
    own.manual_seed(3)
    errs = {"resident": [0.0, 0.0], "grid": [0.0, 0.0]}
    held, per_sm = {}, {}
    for route, shapes in (("resident", LSTM_RESIDENT_SHAPES),
                          ("grid", LSTM_GRID_SHAPES)):
        for i, (b, t, h) in enumerate(shapes):
            plan = lstm_plan(b, h, sms)
            if route == "resident":
                if plan.route != "resident":
                    raise AssertionError(f"lstm_plan({b}, {h}) = {plan}")
                c_smem = max(lib.cpc2_lstm_smem(h, plan.cluster, plan.bc, 0),
                             lib.cpc2_lstm_smem(h, plan.cluster, plan.bc, 1))
                if c_smem != plan.smem:
                    raise AssertionError(f"lstm_plan({b}, {h}) shared memory "
                                         f"{plan.smem}, the kernels' {c_smem}")

                def fn(*a, plan=plan):
                    return _LSTMResident.apply(*a, plan.cluster, plan.bc)
            else:
                if h != 256 and plan.route != "grid":
                    raise AssertionError(f"lstm_plan({b}, {h}) = {plan}")
                plan = grid_plan(b, h, sms)
                per_sm[(b, h)] = check_grid_layout(lib, plan, b, h, sms)

                def fn(*a, plan=plan):
                    return _LSTMGrid.apply(*a, plan)
            draw = gen if route == "resident" or i < 2 else own
            inputs, cot = lstm_inputs(dev, draw, b, t, h)
            _build.reset_launches()
            out_k, grad_k, bwd_k = grads_of(fn, inputs, cot)
            launches = {k: n for k, n in _build.LAUNCHES.items() if n}
            kernels = {"resident": {"lstm_fwd": 1, "lstm_bwd": 1},
                       "grid": {"lstm_fwd_grid": 1, "lstm_bwd_grid": 1}}
            if launches != kernels[route]:
                raise AssertionError(f"lstm {route} ({b}, {t}, {h}) launched "
                                     f"{launches}")
            out_p, grad_p, bwd_p = grads_of(lstm_plain, inputs, cot)
            what = f"lstm {route} ({b}, {t}, {h})"
            errs[route][0] = max(errs[route][0],
                                 compare(what + " forward", out_k, out_p))
            errs[route][1] = max(errs[route][1],
                                 compare(what + " backward", grad_k, grad_p))
            again = bwd_k()
            if not all(torch.equal(a, g) for a, g in zip(again, grad_k)):
                raise AssertionError(f"{what} backward: two calls differ")
            if (route, b, t, h) in (("resident", 8, 128, 256),
                                    ("grid", 8, 128, 512)):
                held[route] = (inputs, cot, fn, out_k, grad_k, bwd_k, bwd_p)

    ms, events, split, timed = {}, {}, {}, {}
    for route, suffix in (("resident", ""), ("grid", "_grid")):
        inputs, cot, fn, out_k, grad_k, bwd_k, bwd_p = held[route]
        lib_fwd, lib_bwd = cudnn_lstm(inputs, cot)
        with torch.no_grad():
            ms["lstm_fwd" + suffix] = device_ms(lambda: fn(*inputs),
                                                expect="lstm_fwd")
            events["lstm_fwd" + suffix] = cuda_ms(lambda: fn(*inputs))
            plain_fwd = device_ms(lambda: lstm_plain(*inputs), iters=3)
            lib_f = device_ms(lib_fwd)
        split[route] = device_split(bwd_k, expect="lstm_bwd")
        ms["lstm_bwd" + suffix] = sum(split[route].values())
        events["lstm_bwd" + suffix] = cuda_ms(bwd_k)
        timed[route] = (plain_fwd, device_ms(bwd_p, iters=3), lib_f,
                        device_ms(lib_bwd))

    tiles = {}
    for (tb, tt, th), choices in LSTM_TILES.items():
        t_inputs, t_cot = lstm_inputs(dev, gen, tb, tt, th)
        for c, bc in choices:
            def fn(*a, c=c, bc=bc):
                return _LSTMResident.apply(*a, c, bc)
            _o, _g, bwd = grads_of(fn, t_inputs, t_cot)
            with torch.no_grad():
                f_ms = device_ms(lambda: fn(*t_inputs), expect="lstm_fwd")
            tiles[f"({tb},{tt},{th}) C{c} Bc{bc}"] = (
                f_ms, device_ms(bwd, expect="lstm_bwd"))
    per_step = {}
    for h in LSTM_GRID_WIDTHS:
        plan = grid_plan(8, h, sms)
        t_inputs, t_cot = lstm_inputs(dev, own, 8, 128, h)
        _o, _g, bwd = grads_of(lambda *a, plan=plan: _LSTMGrid.apply(
            *a, plan), t_inputs, t_cot)
        with torch.no_grad():
            f_ms = device_ms(lambda: _LSTMGrid.apply(*t_inputs, plan),
                             expect="lstm_fwd_grid")
        b_split = device_split(bwd, expect="lstm_bwd_grid")
        walk = sum(v for k, v in b_split.items() if "lstm_bwd_grid" in k)
        per_step[h] = (1e3 * f_ms / 128, 1e3 * walk / 128)
    b, h = 8, 256
    plan = lstm_plan(b, h, sms)
    clusters = {f"C{c} Bc{bc} {'bwd' if d else 'fwd'}":
                lib.cpc2_lstm_max_clusters(h, c, bc, d)
                for c, bc in ((plan.cluster, plan.bc), (8, 8)) for d in (0, 1)}
    wide = lstm_plan(8, 512, sms)
    log(f"[lstm] plan at the recipe {tuple(plan)[:4]}; max active clusters "
        f"{clusters}; grid plan at (8, 512) {wide.ctas} CTAs x {wide.units} "
        f"units, fwd {tuple(wide.fwd)}, bwd {tuple(wide.bwd)}, CTAs an SM "
        f"(fwd, bwd) {per_sm[(8, 512)]}; ptxas: "
        + " | ".join(ptxas_usage(_build, "lstm_fwd_resident")
                     + ptxas_usage(_build, "lstm_bwd_resident")
                     + ptxas_usage(_build, "lstm_fwd_grid")
                     + ptxas_usage(_build, "lstm_bwd_grid")))
    for route, where in (("resident", "(8, 128, 256)"),
                         ("grid", "(8, 128, 512)")):
        suffix = "" if route == "resident" else "_grid"
        plain_f, plain_b, lib_f, lib_b = timed[route]
        log(f"[lstm] {route} at {where}, device ms a call: fwd "
            f"{ms['lstm_fwd' + suffix]:.4f} bwd {ms['lstm_bwd' + suffix]:.4f} "
            "(by kernel "
            + ", ".join(f"{k[:40]} {v:.4f}" for k, v in split[route].items())
            + f"), plain {plain_f:.4f} / {plain_b:.4f}, cuDNN {lib_f:.4f} / "
            f"{lib_b:.4f}")
    log("[lstm] grid route at (8, 128, H), device us a time step fwd/walk: "
        + ", ".join(f"H = {h} {f:.3f}/{w:.3f}"
                    for h, (f, w) in per_step.items())
        + f"; events {events}")
    log("[lstm tiles] device ms fwd/bwd: " + ", ".join(
        f"{k} {f:.4f}/{bw:.4f}" for k, (f, bw) in tiles.items()))

    src, rep = "cpc2_torch/csrc/lstm.cu", "cpc2_tpu/ops/lstm_pallas.py"
    entries = []
    for route, suffix in (("resident", ""), ("grid", "_grid")):
        inputs, cot, _fn, out_k, grad_k, _b, _p = held[route]
        gi, h0, c0, w_hh, b_hh = inputs
        b, t, g4 = gi.shape
        mm = 2 * b * t * g4 * (g4 // 4)
        # outputs: ys, h_last, c_last, and the cell states and gates saved
        fwd_bytes = nbytes(*inputs) + nbytes(*out_k) + nbytes(out_k[0], gi)
        bwd_bytes = (nbytes(w_hh, h0, c0) + nbytes(*cot)
                     + nbytes(out_k[0]) * 2 + nbytes(gi) + nbytes(*grad_k))
        plain_f, plain_b, lib_f, lib_b = timed[route]
        err_f, err_b = errs[route]
        entries += [
            kernel_entry("lstm_fwd" + suffix, src, rep + ":166", err_f,
                         ms["lstm_fwd" + suffix], plain_f, lib_f, fwd_bytes,
                         mm),
            kernel_entry("lstm_bwd" + suffix, src, rep + ":206", err_b,
                         ms["lstm_bwd" + suffix], plain_b, lib_b, bwd_bytes,
                         2 * mm)]
    dw = {route: sum(v for k, v in split[route].items() if "gemm_kernel" in k)
          for route in split}
    extra = {"lstm_dw_hh_ms": dw, "lstm_bwd_by_kernel_ms": split,
             "lstm_tiles_ms": tiles, "lstm_max_clusters": clusters,
             "lstm_grid_us_per_time_step": per_step,
             "lstm_grid_ctas_per_sm": {str(k): v for k, v in per_sm.items()}}
    return entries, {}, events, extra


# The bf16 kernels (FFN, encoder) against their plain versions. Both round to
# bf16 at the same points, but their fp32 sums run in other orders, so a
# value within reordering noise of a bf16 rounding boundary rounds one way on
# one side and the other way on the other, and a ReLU whose input lies that
# close to 0 flips: at the recipe this moves single gradient elements by
# several percent of a tensor's largest value. So each tensor is held, in the
# 2-norm of the difference over the norm of the plain version, to BAND times
# the same measure between the plain version in fp32 and in fp64 (the chatter
# of the bf16 rounding points themselves, on the same inputs), or RTOL when
# that is larger.
FFN_BAND = 3.0
ENCODER_BAND = 3.0


def band(name, names, got, plain, wide):
    """Each tensor of `got` against `plain` as above (`wide`: the plain
    version in fp64): its max abs error, its error over its band, its band
    and its relative 2-norm error."""
    errs, ratios, bands, rels = [], [], [], []
    for n, k, p, d in zip(names, got, plain, wide):
        if not torch.isfinite(k).all():
            raise AssertionError(f"{name} {n}: non-finite values")
        err, spread = norm_rel(k, p), norm_rel(p, d)
        errs.append((k.double() - p.double()).abs().max().item())
        ratios.append(err / max(spread, RTOL))
        bands.append(spread)
        rels.append(err)
    return errs, ratios, bands, rels


def hold_to_band(name, names, got, plain, wide, band_factor, floor=RTOL):
    """Hold each tensor of `got` to `plain` as above (`wide`: the plain
    version in fp64), or to `floor` where that is larger; returns each
    tensor's max abs error, its error over its band, and its band."""
    errs, ratios, bands, rels = band(name, names, got, plain, wide)
    for n, err, spread in zip(names, rels, bands):
        if err > max(band_factor * spread, floor):
            raise AssertionError(f"{name} {n}: kernel vs plain {err:.3e} "
                                 f"(2-norm, relative), plain fp32 vs fp64 "
                                 f"{spread:.3e}")
    return errs, ratios, bands


def ffn_route(x, w1, b1, w2, b2, keep, scale, dtype=torch.bfloat16):
    """The FFN forward as `torch.matmul` on tensors of `dtype` (bf16: the
    yardstick of the bf16 kernels; float32, with TF32 off as `main` sets
    it: of the fp32 ones) with the epilogues as torch ops, never called by
    the port. Returns y and what its backward needs."""
    xb, w1b, w2b = (t.to(dtype) for t in (x, w1, w2))
    pre = (xb @ w1b.t()).float() + b1
    hb = (torch.relu(pre) * keep * scale).to(dtype)
    return (hb @ w2b.t()).float() + b2, (xb, w1b, w2b, hb)


def ffn_route_bwd(g, keep, scale, saved):
    """The FFN backward through the same route: dx, dW1, db1, dW2, db2."""
    xb, w1b, w2b, hb = saved
    gb = g.to(xb.dtype)
    dh = (gb @ w2b).float() * ((hb > 0) * keep * scale)
    dhb = dh.to(xb.dtype)
    return (dhb @ w1b, dhb.t() @ xb, dh.sum(0), gb.t() @ hb, g.sum(0))


# Ragged shapes beside the recipe's: the small step's (84 rows, 64 -> 2048 ->
# 64) and one where no width is a multiple of the bf16 kernels' 64 or 128.
# The fp32 route takes any width, so it is also held where none is a
# multiple of 4 (the planes' row padding) and at one row.
FFN_EDGE_SHAPES = ((84, 64, 2048, 64), (200, 72, 136, 24))
FFN_FP32_SHAPES = ((37, 30, 75, 13), (1, 256, 2048, 256))
# The fp32 route against `ffn_plain` in fp32: a ReLU input this close to 0,
# relative to sum_k |x_k w_k| + |b|, lies within the two sides' rounding
# of it and may fall on either side of 0; its gradient jumps there (at the
# recipe, one such flip moves a row of dx by 1% of its largest value). The
# entries downstream of such a tie (that row of dx, that row of dW1 and
# that entry of db1) are held, at the same tolerance, to the plain backward
# in float64 with the ReLU's decision at each tie taken from the kernel.
FFN_TIE = 2.0 ** -20


def ffn_inputs(dev, gen, m, din, dff, dout):
    return ([torch.randn(m, din, device=dev, generator=gen),
             torch.randn(dff, din, device=dev, generator=gen) / 16,
             torch.randn(dff, device=dev, generator=gen) / 16,
             torch.randn(dout, dff, device=dev, generator=gen) / 45,
             torch.randn(dout, device=dev, generator=gen) / 45],
            [torch.randn(m, dout, device=dev, generator=gen)])


def ffn_ties(inputs):
    """The ReLU inputs that tie (FFN_TIE), as a (M, Dff) mask."""
    x, w1, b1 = (t.double() for t in inputs[:3])
    pre = x @ w1.T + b1
    return pre.abs() <= FFN_TIE * (x.abs() @ w1.abs().T + b1.abs())


def ffn_hidden(x, w1, b1, seed, rate=0.0):
    """The fp32 FFN's own hidden (after its ReLU and dropout) for `x`: on
    the card the kernel's forward with W2 = I and b2 = 0, whose y is the
    hidden (the hidden's product is the same whatever W2); on the CPU
    `ffn_plain`'s."""
    from cpc2_torch.ops.ffn import fused_ffn
    dff = w1.shape[0]
    with torch.no_grad():
        return fused_ffn(x, w1, b1, torch.eye(dff, device=x.device),
                         torch.zeros(dff, device=x.device), seed, rate,
                         False)


def hold_ffn_fp32_at_ties(what, inputs, cot, seed, rate, ties, grad_k):
    """The fp32 kernels' dx, dW1 and db1 downstream of the ReLU ties
    against the plain backward in float64 with the kernel's decisions
    there: the kernel's own hidden > 0 (`ffn_hidden`). Returns the max abs
    error over those entries."""
    from cpc2_torch.ops.ffn import keep_mask
    x, w1, b1, w2, _b2 = (t.double() for t in inputs)
    dff = w1.shape[0]
    hidden = ffn_hidden(*inputs[:3], seed, rate)
    keep = keep_mask(seed, x.shape[0], dff, rate)
    pos = torch.where(ties, hidden > 0, x @ w1.T + b1 > 0) & keep
    dh = (cot[0].double() @ w2) * pos / (1.0 - rate)
    rows, cols = ties.any(1), ties.any(0)
    return compare(what + " backward at ReLU ties",
                   [grad_k[0][rows], grad_k[1][cols], grad_k[2][cols]],
                   [(dh @ w1)[rows], (dh.T @ x)[cols], dh.sum(0)[cols]])


def hold_ffn(inputs, cot, seed, rate, bf16, floor=RTOL):
    """One FFN route's kernels against its plain version (see check_ffn):
    (forward max abs error, backward max abs error, each tensor's error
    over its band, the bands) and the timing closures; for the fp32 route
    the number of ReLU ties (FFN_TIE) in place of the last two. The bf16
    route's tensors are held to FFN_BAND, or to `floor` where that is
    larger (FFN_WIDE_FLOOR at the multi-head trunk's shape)."""
    from cpc2_torch.ops.ffn import ffn_plain, fused_ffn

    def kern(*a):
        return fused_ffn(*a, seed, rate, bf16)

    def plain(*a):
        return ffn_plain(*a, seed, rate, bf16)
    out_k, grad_k, bwd_k = grads_of(kern, inputs, cot)
    out_p, grad_p, bwd_p = grads_of(plain, inputs, cot)
    what = f"ffn {'bf16' if bf16 else 'fp32'} {tuple(inputs[0].shape)} x " \
           f"{tuple(inputs[1].shape)} rate {rate}"
    if not bf16:
        ties = ffn_ties(inputs)
        err_t = (hold_ffn_fp32_at_ties(what, inputs, cot, seed, rate, ties,
                                       grad_k) if ties.any() else 0.0)
        rows, cols = ~ties.any(1), ~ties.any(0)
        held = [grad_k[0][rows], grad_k[1][cols], grad_k[2][cols],
                *grad_k[3:]]
        want = [grad_p[0][rows], grad_p[1][cols], grad_p[2][cols],
                *grad_p[3:]]
        return (compare(what + " forward", out_k, out_p),
                max(compare(what + " backward", held, want), err_t),
                int(ties.sum()), None,
                (kern, plain, bwd_k, bwd_p, out_k, grad_k))
    out_d, grad_d, _ = grads_of(plain, [t.double() for t in inputs],
                                [cot[0].double()])
    e, r, b = hold_to_band(what, ["y", "dx", "dw1", "db1", "dw2", "db2"],
                           out_k + list(grad_k), out_p + list(grad_p),
                           out_d + list(grad_d), FFN_BAND, floor)
    return e[0], max(e[1:]), r, b, (kern, plain, bwd_k, bwd_p, out_k, grad_k)


def check_ffn_fp32_extra(dev, seed, inputs, cot):
    """The fp32 route beyond the shared shapes: FFN_FP32_SHAPES at both
    rates, the recipe's backward bit for bit across two calls, and an
    empty batch, which launches nothing and gives zero weight gradients.
    Returns the most ReLU ties in one call. Its inputs come from a
    generator of its own, so that the later checks draw what they drew
    before it existed."""
    from cpc2_torch.ops import _build
    from cpc2_torch.ops.ffn import fused_ffn
    own = torch.Generator(device=dev)
    own.manual_seed(1)
    ties = 0
    for shape in FFN_FP32_SHAPES:
        edge_inputs, edge_cot = ffn_inputs(dev, own, *shape)
        for rate in (0.0, 0.1):
            ties = max(ties, hold_ffn(edge_inputs, edge_cot, seed, rate,
                                      False)[2])
    _out, grads, bwd = grads_of(
        lambda *a: fused_ffn(*a, seed, 0.1, False), inputs, cot)
    again = bwd()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError("ffn fp32 backward differs between two calls")
    empty = [torch.zeros(0, inputs[0].shape[1], device=dev)] + inputs[1:]
    _build.reset_launches()
    out, grads, _ = grads_of(lambda *a: fused_ffn(*a, seed, 0.1, False),
                             empty, [torch.zeros(0, inputs[3].shape[0],
                                                 device=dev)])
    torch.cuda.synchronize()
    launched = {k: n for k, n in _build.LAUNCHES.items() if n}
    if launched or out[0].shape != (0, inputs[3].shape[0]) or any(
            g.abs().max().item() != 0 for g in grads[1:]):
        raise AssertionError(f"ffn fp32 on an empty batch: launched "
                             f"{launched}, y {tuple(out[0].shape)}")
    return ties


def check_ffn(dev, gen):
    """Both FFN routes at the recipe's shapes (M = 928 rows, 256 -> 2048 ->
    256) and at FFN_EDGE_SHAPES, at dropout 0 and 0.1 with one seed: the
    fp32 kernels within RTOL/ATOL of `ffn_plain` (entries downstream of a
    ReLU tie as FFN_TIE says), also at FFN_FP32_SHAPES, bit for bit across
    two calls and on an empty batch (`check_ffn_fp32_extra`); the bf16
    kernels within FFN_BAND of `ffn_plain(bf16=True)`, their backward bit
    for bit across two calls at the recipe. Timed at 0.1 by
    device time (`device_ms`: a call's device work is shorter than its
    host path) beside their plain versions and the same products as
    `torch.matmul` on bf16 tensors, or on fp32 ones with TF32 off
    (`ffn_route`); the events' times go to the third value returned. The
    bf16 rows' bound is reckoned at the bf16 rate, the fp32 rows' at the
    3xTF32 rate."""
    from cpc2_torch.ops.ffn import keep_mask
    m, din, dff, dout = 8 * 116, 256, 2048, 256
    seed = torch.tensor([12345], device=dev, dtype=torch.int32)
    ties = 0
    for shape in FFN_EDGE_SHAPES:
        edge_inputs, edge_cot = ffn_inputs(dev, gen, *shape)
        for bf16 in (True, False):
            for rate in (0.0, 0.1):
                held = hold_ffn(edge_inputs, edge_cot, seed, rate, bf16)
                ties = ties if bf16 else max(ties, held[2])
    inputs, cot = ffn_inputs(dev, gen, m, din, dff, dout)
    ties = max(ties, check_ffn_fp32_extra(dev, seed, inputs, cot))
    gemm = 2 * m * din * dff
    src, rep = "cpc2_torch/csrc/ffn.cu", "cpc2_tpu/ops/ffn_pallas.py"
    entries, yard, events = [], {}, {}
    for bf16 in (True, False):
        errs, ratios, bands = [], [], []
        for rate in (0.0, 0.1):
            err_f, err_b, r, b, timed = hold_ffn(inputs, cot, seed, rate,
                                                 bf16)
            errs.append((err_f, err_b))
            if bf16:
                ratios += r
                bands += b
            else:
                ties = max(ties, r)
        kern, plain, bwd_k, bwd_p, out_k, grad_k = timed
        if bf16:
            again = bwd_k()
            if not all(torch.equal(a, b) for a, b in zip(grad_k, again)):
                raise AssertionError("ffn bf16 backward differs between two "
                                     "calls")
            log("  ffn bf16 backward bit for bit across two calls at the "
                "recipe (rate 0.1)")
            log(f"  ffn bf16 kernels vs plain at the recipe, relative "
                f"2-norm: at most {max(ratios):.2f} x the plain version's own "
                f"fp32-vs-fp64 spread (or {RTOL}), which is {min(bands):.2e} "
                f"to {max(bands):.2e}")
        else:
            log(f"  ffn fp32 kernels vs plain: every shape within "
                f"{ATOL} + {RTOL} x max|plain|, at most {ties} ReLU ties in a "
                f"call held against the kernel's own decisions; backward "
                f"bit for bit across two calls; an empty batch launched "
                f"nothing")
        # timed at rate 0.1, the recipe's
        suffix, peak = ("", BF16_FLOP_PER_S) if bf16 else ("_fp32",
                                                          TF32X3_FLOP_PER_S)
        with torch.no_grad():
            fwd_ms = device_ms(lambda: kern(*inputs))
            plain_fwd_ms = device_ms(lambda: plain(*inputs))
            events["ffn_fwd" + suffix] = cuda_ms(lambda: kern(*inputs))
        bwd_ms = device_ms(bwd_k)
        plain_bwd_ms = device_ms(bwd_p)
        events["ffn_bwd" + suffix] = cuda_ms(bwd_k)
        entries += [
            kernel_entry("ffn_fwd" + suffix, src, rep + ":193",
                         max(e[0] for e in errs), fwd_ms, plain_fwd_ms, None,
                         nbytes(*inputs) + nbytes(*out_k), 2 * gemm, peak),
            kernel_entry("ffn_bwd" + suffix, src, rep + ":217",
                         max(e[1] for e in errs), bwd_ms, plain_bwd_ms, None,
                         nbytes(*inputs[:4], *cot) + nbytes(*grad_k),
                         5 * gemm, peak)]
    # the mask kept the expected share of the hidden
    keep = keep_mask(seed, m, dff, 0.1)
    kept = keep.float().mean().item()
    if abs(kept - 0.9) > 0.005:
        raise AssertionError(f"ffn dropout kept {kept:.4f} of the hidden")
    with torch.no_grad():
        for suffix, dtype in (("", torch.bfloat16), ("_fp32", torch.float32)):
            _y, saved = ffn_route(*inputs, keep, 1 / 0.9, dtype)
            yard["ffn_fwd" + suffix] = device_ms(
                lambda: ffn_route(*inputs, keep, 1 / 0.9, dtype))
            yard["ffn_bwd" + suffix] = device_ms(
                lambda: ffn_route_bwd(cot[0], keep, 1 / 0.9, saved))
    return entries, yard, events


# InfoNCE shapes (B, K, W, N, D, P) held against the plain version: the
# recipe (with repeated rows: half the draws from 16 pool rows), a ragged
# small one (K, N and D not multiples of the kernels' tiles), the recipe's
# widths over a 4,096-row pool, N = 10 (padded to 12 for the backward) and
# N = 384 (two chunks of sampled rows), K = 40 (two groups of predictions)
# with D = 1030 (padded to 1032; forward chunks of D, three dz slices), a
# D of 2,048 (two dz slices), and one (b, w) (one split, whose partial is
# the whole of dz).
INFONCE_SHAPES = ((8, 12, 116, 128, 256, 1024), (3, 5, 9, 20, 36, 1100),
                  (8, 12, 116, 128, 256, 4096), (2, 12, 7, 10, 256, 1024),
                  (2, 12, 9, 384, 256, 1024), (2, 40, 5, 30, 1030, 300),
                  (2, 12, 3, 64, 2048, 500), (1, 3, 1, 8, 16, 40))


def infonce_route(preds, z, idx):
    """The forward as library calls, never called by the port: a row gather
    (`index_select`) and one batched product (`torch.bmm`)."""
    b, k, w, d = preds.shape
    n = idx.shape[2]
    zg = z.index_select(0, idx.reshape(-1).long()).reshape(b * w, n, d)
    pw = preds.permute(0, 2, 1, 3).reshape(b * w, k, d)
    return torch.bmm(pw, zg.transpose(1, 2)).reshape(b, w, k, n) \
        .permute(0, 2, 1, 3)


def infonce_route_bwd(g, preds, z, idx):
    """The backward as library calls: `torch.bmm` for dpreds and for the
    sampled rows' cotangents, `index_add_` to scatter those into dz."""
    b, k, w, d = preds.shape
    n = idx.shape[2]
    flat = idx.reshape(-1).long()
    zg = z.index_select(0, flat).reshape(b * w, n, d)
    gw = g.permute(0, 2, 1, 3).reshape(b * w, k, n)
    dpreds = torch.bmm(gw, zg).reshape(b, w, k, d).permute(0, 2, 1, 3)
    pw = preds.permute(0, 2, 1, 3).reshape(b * w, k, d)
    dzg = torch.bmm(gw.transpose(1, 2), pw).reshape(-1, d)
    return dpreds, torch.zeros_like(z).index_add_(0, flat, dzg)


def check_infonce(dev, gen):
    """The InfoNCE kernels against `negative_scores_plain` at
    INFONCE_SHAPES, forward and both gradients, the backward bit-identical
    across two calls at each, and an empty shape launching nothing; then
    at the recipe, on the trainer's own draws, the kernels, the plain
    version and the library route (`infonce_route`, full fp32) held to the
    same tolerance and timed by device time, events beside. Prints each
    shape's plan, the backward's device time by kernel and the kernels'
    registers and spills on `[infonce]` lines."""
    from cpc2_torch.ops import _build
    from cpc2_torch.ops.infonce import (infonce_plan, negative_scores,
                                        negative_scores_plain)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err_f = err_b = 0.0
    for b, k, w, n, d, p in INFONCE_SHAPES:
        plan = infonce_plan(b, k, w, n, d + (-d) % 4, p, sms)
        log(f"[infonce] plan at {(b, k, w, n, d, p)}: {tuple(plan)}")
        inputs = [torch.randn(b, k, w, d, device=dev, generator=gen),
                  torch.randn(p, d, device=dev, generator=gen)]
        idx = torch.randint(0, p, (b, w, n), device=dev, generator=gen,
                            dtype=torch.int32)
        if (b, k, w, n, d, p) == INFONCE_SHAPES[0]:
            idx[..., ::2] = idx[..., ::2] % 16
        cot = [torch.randn(b, k, w, n, device=dev, generator=gen)]

        def kern(preds, z, idx=idx):
            return negative_scores(preds, z, idx)

        def plain(preds, z, idx=idx):
            return negative_scores_plain(preds, z, idx)
        out_k, grad_k, bwd_k = grads_of(kern, inputs, cot)
        out_p, grad_p, bwd_p = grads_of(plain, inputs, cot)
        what = f"infonce {(b, k, w, n, d, p)}"
        err_f = max(err_f, compare(what + " forward", out_k, out_p))
        err_b = max(err_b, compare(what + " backward", grad_k, grad_p))
        again = bwd_k()
        if not all(torch.equal(a, g) for a, g in zip(again, grad_k)):
            raise AssertionError(what + " backward: two calls differ")
    # an empty shape (W = 0): zeros of the right shapes, no launch
    before = dict(_build.LAUNCHES)
    inputs = [torch.randn(2, 12, 0, 256, device=dev),
              torch.randn(1024, 256, device=dev)]
    idx = torch.zeros(2, 0, 128, device=dev, dtype=torch.int32)
    out_k, grad_k, _ = grads_of(lambda a, z: negative_scores(a, z, idx),
                                inputs, [torch.ones(2, 12, 0, 128,
                                                    device=dev)])
    if out_k[0].shape != (2, 12, 0, 128) or grad_k[0].shape != (
            2, 12, 0, 256) or not torch.equal(
                grad_k[1], torch.zeros_like(inputs[1])) \
            or dict(_build.LAUNCHES) != before:
        raise AssertionError("infonce at W = 0: wrong shapes, a nonzero dz "
                             "or a launch")
    # timed at the recipe on the trainer's own draws (`sample_negative_indices`:
    # uniform over the pool but a position's own frame)
    from cpc2_torch.losses import sample_negative_indices
    b, k, w, n, d, p = INFONCE_SHAPES[0]
    inputs = [torch.randn(b, k, w, d, device=dev, generator=gen),
              torch.randn(p, d, device=dev, generator=gen)]
    idx = sample_negative_indices(gen, b, p // b, n, w, dev).transpose(
        1, 2).contiguous()
    cot = [torch.randn(b, k, w, n, device=dev, generator=gen)]

    def kern(preds, z):
        return negative_scores(preds, z, idx)

    def plain(preds, z):
        return negative_scores_plain(preds, z, idx)
    out_k, grad_k, bwd_k = grads_of(kern, inputs, cot)
    out_p, grad_p, bwd_p = grads_of(plain, inputs, cot)
    err_f = max(err_f, compare("infonce drawn forward", out_k, out_p))
    err_b = max(err_b, compare("infonce drawn backward", grad_k, grad_p))
    with torch.no_grad():
        fwd_ms = device_ms(lambda: kern(*inputs))
        plain_fwd_ms = device_ms(lambda: plain(*inputs))
        route_fwd_ms = device_ms(lambda: infonce_route(*inputs, idx))
        events = {"infonce_fwd": cuda_ms(lambda: kern(*inputs))}
        route_out = infonce_route(*inputs, idx)

        def route_bwd():
            return infonce_route_bwd(cot[0], *inputs, idx)
        route_bwd_ms = device_ms(route_bwd)
        route_grad = route_bwd()
    compare("infonce route forward", [route_out], out_k)
    compare("infonce route backward", route_grad, grad_k)
    bwd_split = device_split(bwd_k)
    bwd_ms = sum(bwd_split.values())
    plain_bwd_ms = device_ms(bwd_p)
    events["infonce_bwd"] = cuda_ms(bwd_k)
    log("[infonce] at the recipe, backward device ms by kernel "
        + ", ".join(f"{k[:40]} {v:.4f}" for k, v in bwd_split.items())
        + "; ptxas: " + " | ".join(ptxas_usage(_build, "gathered_fwd")
                                    + ptxas_usage(_build, "gathered_bwd")
                                    + ptxas_usage(_build, "dz_sum")))
    b, k, w, d = inputs[0].shape
    dots = 2 * b * k * w * idx.shape[2] * d
    src, rep = "cpc2_torch/csrc/infonce.cu", "cpc2_tpu/ops/infonce_pallas.py"
    # The forward's products run in 3xTF32 on the tensor cores. The
    # backward's dpreds products (3xTF32) and dz's sparse FMAs (fp32, as
    # many) run on separate units; its bound is the larger, the FMAs' at
    # the fp32 rate.
    entries = [
        kernel_entry("infonce_fwd", src, rep + ":107", err_f, fwd_ms,
                     plain_fwd_ms, None,
                     nbytes(*inputs, idx) + nbytes(*out_k), dots,
                     TF32X3_FLOP_PER_S),
        kernel_entry("infonce_bwd", src, rep + ":170", err_b, bwd_ms,
                     plain_bwd_ms, None,
                     nbytes(*cot, *inputs, idx) + nbytes(*grad_k), dots)]
    yard = {"infonce_fwd": route_fwd_ms, "infonce_bwd": route_bwd_ms}
    return entries, yard, events


# DTW shapes beside the four drawn from the run's generator (one ABX flush
# of 18,432 pairs of 32 x 32, a ragged 16 x 64, a multi-strip 64 x 64 and
# the limit 2,048 x 2,048), each (P, S1, S2, draw), drawn from a generator
# of their own so that the later checks draw what they drew before: a real
# flush's layout (`time_kernels.flush_layout`: 32 groups x 24 x 24 pairs of
# 32 x 16, a quarter of the rows dummies of length 1); the lane route's
# widths 8, 16 and 64, each lane route kernel (every G lanes a pair at its
# widths: P sets G) and the wave route's widths 65 and 128; S1 != S2 both
# ways; dist from {0, 0.25, 0.5} on both routes ("ties": equal costs meet
# at most cells, so the tie-break decides the path length); S2 off 4 on
# both routes and a `dist` that is not 16-byte aligned ("unaligned"),
# which take 4-byte copies. Most P are not multiples of a CTA's pairs.
DTW_SHAPES = ((18432, 32, 16, "flush"), (1000, 8, 8, "rand"),
              (777, 16, 16, "rand"), (34000, 20, 16, "rand"),
              (34000, 32, 32, "ties"), (34000, 40, 64, "rand"),
              (20000, 24, 48, "rand"), (10000, 12, 60, "rand"),
              (333, 64, 64, "rand"), (100, 40, 65, "rand"),
              (64, 128, 128, "rand"), (2000, 32, 16, "rand"),
              (2000, 16, 32, "rand"), (300, 200, 64, "rand"),
              (4095, 32, 32, "ties"), (37, 96, 130, "ties"),
              (999, 30, 30, "rand"), (33, 70, 67, "rand"),
              (513, 24, 24, "unaligned"))


def dtw_draw(dev, gen, p, s1, s2, draw="rand"):
    """(dist, n1, n2): dist uniform in [0, 1) (`ties`: from {0, 0.25,
    0.5}; `unaligned`: a contiguous view one float past an allocation),
    lengths uniform in [1, S] with pair 0 at (1, 1) and pair 1 at (S1, S2);
    `flush` draws `time_kernels.dtw_inputs`' shape (b)."""
    from cpc2_torch.time_kernels import dtw_inputs
    if draw == "flush":
        return dtw_inputs(dev, gen, "b", p, s1, s2)
    if draw == "ties":
        dist = torch.randint(0, 3, (p, s1, s2), device=dev, generator=gen,
                             dtype=torch.int32).float() / 4
    elif draw == "unaligned":
        dist = torch.rand(p * s1 * s2 + 1, device=dev,
                          generator=gen)[1:].view(p, s1, s2)
    else:
        dist = torch.rand(p, s1, s2, device=dev, generator=gen)
    n1 = torch.randint(1, s1 + 1, (p,), device=dev, generator=gen,
                       dtype=torch.int32)
    n2 = torch.randint(1, s2 + 1, (p,), device=dev, generator=gen,
                       dtype=torch.int32)
    n1[0] = n2[0] = 1
    n1[1], n2[1] = s1, s2
    return dist, n1, n2


def check_dtw(dev, gen):
    """The DTW kernel's two routes against the plain version, bit-identical
    (max abs error 0), at one ABX flush, a ragged shape, a multi-strip
    shape and the kernel's limit, drawn from `gen`, and at DTW_SHAPES; each
    shape's plan held to `cpc2_dtw_layout` and its launch counted under
    `dtw` and the plan's route only; P = 0 launches nothing. The flush is
    timed by device time, beside the plain version. Its bound counts the
    cells this run's lengths need: 4 bytes read and about 20 operations
    each."""
    import ctypes

    from cpc2_torch.ops import _build
    from cpc2_torch.ops.dtw import (MAX_LEN, ROUTES, dtw_normalized,
                                    dtw_normalized_plain, dtw_plan)

    flush = dtw_draw(dev, gen, 32 * 24 * 24, 32, 32)
    drawn = [flush] + [dtw_draw(dev, gen, *shape) for shape in (
        (4096, 16, 64), (1024, 64, 64), (4, MAX_LEN, MAX_LEN))]
    own = torch.Generator(device=dev)
    own.manual_seed(12)
    drawn += [dtw_draw(dev, own, *shape) for shape in DTW_SHAPES]
    err, routes = 0.0, {}
    for args in drawn:
        p, s1, s2 = args[0].shape
        plan = dtw_plan(s1, s2, p, _build.sm_count(dev))
        layout = (ctypes.c_int * 7)()
        rc = _build.library().cpc2_dtw_layout(s1, s2, p,
                                              _build.sm_count(dev), layout)
        if rc != 0 or list(layout) != [ROUTES.index(plan.route), *plan[1:]]:
            raise AssertionError(f"dtw_plan({s1}, {s2}) {plan}, the "
                                 f"kernels' {list(layout)} (rc {rc})")
        _build.reset_launches()
        got = dtw_normalized(*args)
        ran = {k: n for k, n in _build.LAUNCHES.items() if n}
        if ran != {"dtw": 1, f"dtw_{plan.route}": 1}:
            raise AssertionError(f"dtw {(p, s1, s2)} on the {plan.route} "
                                 f"route launched {ran}")
        want = dtw_normalized_plain(*args)
        if not torch.isfinite(got).all():
            raise AssertionError(f"dtw {(p, s1, s2)}: non-finite")
        shape_err = (got.double() - want.double()).abs().max().item()
        if shape_err != 0.0:
            raise AssertionError(f"dtw {(p, s1, s2)}: kernel differs from "
                                 f"plain, max abs err {shape_err:.3e}")
        routes.setdefault(f"{plan.route} G = {plan.lanes}", []).append(
            (p, s1, s2))
        err = max(err, shape_err)
    _build.reset_launches()
    empty = dtw_normalized(torch.rand(0, 32, 32, device=dev),
                           *[torch.ones(0, device=dev, dtype=torch.int32)] * 2)
    if empty.shape != (0,) or any(_build.LAUNCHES.values()):
        raise AssertionError("dtw at P = 0: a launch or a wrong shape")
    split = device_split(lambda: dtw_normalized(*flush))
    ms = sum(split.values())
    plain_ms = cuda_ms(lambda: dtw_normalized_plain(*flush), iters=3,
                       warmup=1)
    events = {"dtw": cuda_ms(lambda: dtw_normalized(*flush))}
    log(f"[dtw] bit for bit at {len(drawn)} shapes, by route {routes}; the "
        f"flush {ms:.4f} ms device "
        + ", ".join(f"{k[:40]} {v:.4f}" for k, v in split.items())
        + "; ptxas: " + " | ".join(ptxas_usage(_build, "dtw_lanes")
                                    + ptxas_usage(_build, "dtw_wave")))
    dist, n1, n2 = flush
    cells = (n1.double() * n2.double()).sum().item()
    return [kernel_entry("dtw", "cpc2_torch/csrc/dtw.cu",
                         "cpc2_tpu/ops/dtw_pallas.py:163", err, ms, plain_ms,
                         None, 4 * cells + nbytes(n1, n2) + 4 * n1.numel(),
                         20 * cells)], {}, events


# The attention's shapes beside the recipe's (N, S, dk) = (64, 116, 32): a
# ragged S at dk = 8, the gate's limit at dk = 32 (a 3-CTA cluster), one
# step, and dk = 4 (padded to the tensor cores' k = 8 in the kernels); then
# widths that a block does not hold whole, which the wide kernels take in
# chunks of dk: 2 chunks at 1 and 3 row tiles, 9 at one step with a ragged
# dk, and 2 at the gate's widest 4-tile unit with a ragged dk.
ATTENTION_SHAPES = ((64, 116, 32), (5, 37, 8), (3, 134, 32), (2, 1, 32),
                    (4, 64, 4), (3, 8, 256), (2, 43, 248), (1, 1, 1999),
                    (2, 58, 177))


def check_attention(dev, gen):
    """The attention kernels against their plain version at ATTENTION_SHAPES
    (the recipe first: one head call, 64 units of 116 x 32, drawn from
    `gen`; the others from a generator of their own, so that the later
    checks draw what they drew before these shapes came), forward and
    all four gradients, at dropout 0 and 0.1 with one seed, the backward
    bit-identical across two calls at each, and N = 0 launching nothing;
    the hash mask keeps about 0.9 of the causal probabilities. At the
    recipe and 0.1 they are timed by device time (events beside), with the
    module's shift-trick path (the port's default route for the same work)
    as the yardstick. The bound counts the causal pairs: q.k, the relative
    term and p.v forward (6 dk FLOPs a pair), 16 dk backward, at the 3xTF32
    rate, or the bytes, the larger. Prints each shape's plan and the
    kernels' registers on `[attention]` lines."""
    from cpc2_torch.models.transformer import ScaledDotProductAttention
    from cpc2_torch.ops import _build
    from cpc2_torch.ops.attention import (attention_plain, attention_plan,
                                          fused_relpos_attention)
    from cpc2_torch.ops.ffn import keep_mask
    seed = torch.tensor([12345], device=dev, dtype=torch.int32)
    own = torch.Generator(device=dev)
    own.manual_seed(2)
    err_f = err_b = 0.0
    for i, (n, s, dk) in enumerate(ATTENTION_SHAPES):
        plan = attention_plan(n, s, dk)
        log(f"[attention] plan at {(n, s, dk)}: {plan.tiles} row tiles, "
            f"dk in {plan.chunks} chunk(s) of {plan.dc}, "
            f"forward {plan.fwd_ctas} CTAs x {plan.fwd_warps} warps a unit, "
            f"{plan.fwd_smem} B; backward clusters of {plan.bwd_ctas} x "
            f"{plan.bwd_warps} warps, {plan.bwd_smem} B")
        draw = own if i else gen
        inputs = [torch.randn(n, s, dk, device=dev, generator=draw)
                  for _ in range(3)]
        inputs.append(0.2 * torch.randn(dk, s, device=dev, generator=draw))
        cot = [torch.randn(n, s, dk, device=dev, generator=draw)]
        if i == 0:
            recipe = inputs, cot
        for rate in (0.0, 0.1):
            def kern(*a, rate=rate):
                return fused_relpos_attention(*a, seed, rate)

            def plain(*a, rate=rate):
                return attention_plain(*a, seed, rate)
            out_k, grad_k, bwd_k = grads_of(kern, inputs, cot)
            out_p, grad_p, bwd_p = grads_of(plain, inputs, cot)
            what = f"attention {(n, s, dk)} rate {rate}"
            err_f = max(err_f, compare(what + " forward", out_k, out_p))
            err_b = max(err_b, compare(what + " backward", grad_k, grad_p))
            again = bwd_k()
            if not all(torch.equal(a, g) for a, g in zip(again, grad_k)):
                raise AssertionError(what + " backward: two calls differ")
    n, s, dk = ATTENTION_SHAPES[0]
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    keep = keep_mask(seed, n * s, s, 0.1).reshape(n, s, s)
    kept = keep[:, causal].float().mean().item()
    if abs(kept - 0.9) > 0.005:
        raise AssertionError(f"attention dropout kept {kept:.4f} of the "
                             f"probabilities")
    # an empty batch: the right shapes, zero dKrelpos, no launch
    before = dict(_build.LAUNCHES)
    empty = [torch.randn(0, s, dk, device=dev) for _ in range(3)] + [
        torch.randn(dk, s, device=dev)]
    out_e, grad_e, _ = grads_of(lambda *a: fused_relpos_attention(*a, seed),
                                empty, [torch.ones(0, s, dk, device=dev)])
    if out_e[0].shape != (0, s, dk) or not torch.equal(
            grad_e[3], torch.zeros_like(empty[3])) \
            or dict(_build.LAUNCHES) != before:
        raise AssertionError("attention at N = 0: wrong shapes, a nonzero "
                             "dKrelpos or a launch")

    # timed at the recipe, rate 0.1
    inputs, cot = recipe

    def kern(*a):
        return fused_relpos_attention(*a, seed, 0.1)

    def plain(*a):
        return attention_plain(*a, seed, 0.1)
    out_k, grad_k, bwd_k = grads_of(kern, inputs, cot)
    _, _, bwd_p = grads_of(plain, inputs, cot)
    with torch.no_grad():
        fwd_ms = device_ms(lambda: kern(*inputs))
        plain_fwd_ms = device_ms(lambda: plain(*inputs))
        events = {"attention_fwd": cuda_ms(lambda: kern(*inputs))}
    bwd_split = device_split(bwd_k)
    bwd_ms = sum(bwd_split.values())
    plain_bwd_ms = device_ms(bwd_p)
    events["attention_bwd"] = cuda_ms(bwd_k)

    module = ScaledDotProductAttention(s, dk, 0.1, relpos=True).to(dev)
    with torch.no_grad():
        module.Krelpos.copy_(inputs[3])
    qkv = [t.detach().requires_grad_(True) for t in inputs[:3]]
    out_m = module(*qkv, gen)
    with torch.no_grad():
        shift_fwd_ms = device_ms(lambda: module(*inputs[:3], gen))
    shift_bwd_ms = device_ms(lambda: torch.autograd.grad(
        out_m, qkv + [module.Krelpos], cot, retain_graph=True))
    log("[attention] at the recipe, backward device ms by kernel "
        + ", ".join(f"{k[:40]} {v:.4f}" for k, v in bwd_split.items())
        + "; ptxas: " + " | ".join(
            u for kind in ("attention_fwd_mma", "attention_bwd_mma",
                           "attention_fwd_wide", "attention_bwd_wide",
                           "relpos_grad_sum")
            for u in ptxas_usage(_build, kind)))

    pairs = n * s * (s + 1) // 2
    src = "cpc2_torch/csrc/attention.cuh"
    rep = "cpc2_tpu/ops/attention_pallas.py"
    yard = {"attention_fwd": shift_fwd_ms, "attention_bwd": shift_bwd_ms}
    return [
        kernel_entry("attention_fwd", src, rep + ":159", err_f, fwd_ms,
                     plain_fwd_ms, None,
                     nbytes(*inputs, seed) + nbytes(*out_k), 6 * dk * pairs,
                     TF32X3_FLOP_PER_S),
        kernel_entry("attention_bwd", src, rep + ":179", err_b, bwd_ms,
                     plain_bwd_ms, None,
                     nbytes(*inputs, seed, *cot) + nbytes(*grad_k),
                     16 * dk * pairs, TF32X3_FLOP_PER_S)], yard, events


# Ragged encoder shapes beside the recipe's (N, T, C): layer 5 at 7 frames,
# off every tile, at a width below one box (C = 32) and at one of half a
# column tile (C = 128).
ENCODER_EDGE_SHAPES = ((3, 160 * 7, 32), (3, 160 * 7, 128))


# The ragged shapes' backward against `encoder_reference`, which takes the
# kernels' own forward decisions: its only rounding points left are dy's,
# to bf16, where a value within the fp32 error of the kernels' sums of a
# rounding boundary rounds either way and, through the ChannelNorm
# projections below, moves whole gradients by up to 1e-3 at these small
# shapes. So each gradient's band is its largest spread over
# ENCODER_JITTER_DRAWS runs of the reference with every dy multiplied by
# 1 + ENCODER_JITTER * N(0, 1) before its rounding (about the relative
# error of the kernels' fp32 sums: their products alone read up to 4e-6
# against float64 on an H100), or RTOL when that is larger.
ENCODER_JITTER = 2.0 ** -20
ENCODER_JITTER_DRAWS = 8

ENCODER_NAMES = ["output", "dx"] + [f"{g}[{i}]" for g in (
    "dconv_w", "dconv_b", "dnorm_w", "dnorm_b") for i in range(5)]


def hold_encoder(params, x, cot, own_decisions=False):
    """The encoder kernels, forward and every gradient, and their backward
    bit for bit across two calls. Held within ENCODER_BAND of
    `encoder_plain`'s own fp32-vs-fp64 spread; or, with `own_decisions`,
    against `encoder_reference` (float64 with the kernels' own bf16
    activations and ReLU masks): every layer's stored pre-norm output
    within RTOL/ATOL of the float64 conv of the kernels' own stored input,
    every stored activation within one bf16 ulp of the float64 norm + ReLU
    of the kernels' own pre-norm output (the output within RTOL/ATOL), and
    every gradient within ENCODER_BAND of its ENCODER_JITTER spread.
    Returns (each tensor's max abs error, each one's error over its band
    (with `own_decisions`, each gradient's), the bands, the timing
    closures, and each one's error over `encoder_plain`'s band)."""
    from cpc2_torch.ops.encoder import encoder_plain, fused_encoder

    def regroup(fn):
        return lambda x, *p: fn(x, p[0:5], p[5:10], p[10:15], p[15:20])
    kern, plain = regroup(fused_encoder), regroup(encoder_plain)
    what = f"encoder {tuple(x.shape)} C {params[0].shape[0]}"
    leaves = [t.detach().requires_grad_(True) for t in [x] + params]
    out = kern(*leaves)

    def bwd_k():
        return torch.autograd.grad(out, leaves, cot, retain_graph=True)
    out_k, grad_k = [out.detach()], bwd_k()
    out_p, grad_p, bwd_p = grads_of(plain, [x] + params, cot)
    out_d, grad_d, _ = grads_of(plain, [t.double() for t in [x] + params],
                                [cot[0].double()])
    got, plain_all = out_k + list(grad_k), out_p + list(grad_p)
    if not own_decisions:
        errs, ratios, bands = hold_to_band(what, ENCODER_NAMES, got,
                                           plain_all, out_d + list(grad_d),
                                           ENCODER_BAND)
        plain_ratios = ratios
    else:
        plain_ratios = band(what, ENCODER_NAMES, got, plain_all,
                            out_d + list(grad_d))[1]
        saved = (*out.grad_fn.saved_tensors[4:6], out_k[0])
        fwd, ref = encoder_reference(x, params, saved, cot[0])
        for layer, (y, h, own_y, stored) in enumerate(fwd, start=1):
            compare(f"{what} layer {layer} pre-norm output", [own_y], [y])
            if layer == 5:
                errs = [compare(f"{what} output", [stored], [h])]
            elif ((stored.double() - h).abs()
                  > 2.0 ** -7 * h.abs() + ATOL).any():
                raise AssertionError(f"{what} layer {layer}: a stored "
                                     f"activation off its own norm by over "
                                     f"a bf16 ulp")
        jitter = torch.Generator(device=x.device)
        jitter.manual_seed(0)
        bands = [0.0] * len(ref)
        for _ in range(ENCODER_JITTER_DRAWS):
            noisy = encoder_reference(x, params, saved, cot[0],
                                      jitter=ENCODER_JITTER, gen=jitter)[1]
            bands = [max(b, norm_rel(n, r))
                     for b, n, r in zip(bands, noisy, ref)]
        ratios = []
        for name, k, r, spread in zip(ENCODER_NAMES[1:], grad_k, ref, bands):
            err = norm_rel(k, r)
            if err > max(ENCODER_BAND * spread, RTOL):
                raise AssertionError(
                    f"{what} {name}: kernel vs the reference with its own "
                    f"decisions {err:.3e} (2-norm, relative), its jitter "
                    f"spread {spread:.3e}")
            errs.append((k.double() - r).abs().max().item())
            ratios.append(err / max(spread, RTOL))
    again = bwd_k()
    if not all(torch.equal(a, b) for a, b in zip(grad_k, again)):
        raise AssertionError(f"{what} backward differs between two calls")
    return (errs, ratios, bands, (kern, plain, bwd_k, bwd_p, out_k, grad_k),
            plain_ratios)


def encoder_reference(x, params, saved, cot, jitter: float = 0.0, gen=None):
    """The encoder in float64 with the kernels' own decisions: each layer's
    input is the kernels' stored bf16 activation of the layer below (x
    rounded to bf16 for layer 1), its norm is taken of the kernels' own
    stored pre-norm output, its ReLU mask is where the kernels' activation
    is positive, and the backward's dy is rounded to bf16 as the kernels
    round it. `saved` is what the kernels' forward kept: (acts, pre, out).
    Returns, per layer, (y from the stored input below, the post-ReLU value
    from the stored y, the stored y, the stored activation or output), and
    the gradients in `fused_encoder`'s order. With `jitter`, each dy is
    multiplied by 1 + jitter * N(0, 1) (from `gen`) before its rounding."""
    import torch.nn.functional as F
    from cpc2_torch.models.encoder import CONV_STACK
    acts, pre, out = saved
    f64 = torch.float64
    n, length = x.shape
    c = params[0].shape[0]
    conv_w = [p.detach().to(torch.bfloat16).to(f64) for p in params[0:5]]
    conv_b, norm_w, norm_b = ([p.detach().reshape(c).to(f64) for p in
                               params[i:i + 5]] for i in (5, 10, 15))
    inputs = [x.detach().to(torch.bfloat16).to(f64)[:, None, :]]
    forward, norms, a_off, p_off = [], [], 0, 0
    for layer, (_k, s, p) in enumerate(CONV_STACK):
        length //= s
        size = n * length * c
        own = pre[p_off:p_off + size].reshape(n, length, c)
        p_off += size
        if layer < 4:
            stored = acts[a_off:a_off + size].reshape(n, length, c)
            a_off += size
            inputs.append(stored.to(f64).transpose(1, 2))
        else:
            stored = out
        y = own.to(f64)
        rstd = torch.rsqrt(y.var(-1, keepdim=True) + 1e-5)
        xh = (y - y.mean(-1, keepdim=True)) * rstd
        norms.append((rstd, xh, stored > 0))
        ref = F.conv1d(inputs[layer], conv_w[layer], stride=s, padding=p)
        forward.append((ref.transpose(1, 2) + conv_b[layer],
                        torch.relu(xh * norm_w[layer] + norm_b[layer]),
                        own, stored))
    g = cot.detach().to(f64)
    dw, db, dnw, dnb = ([None] * 5 for _ in range(4))
    for layer in range(4, -1, -1):
        _k, s, p = CONV_STACK[layer]
        rstd, xh, mask = norms[layer]
        da = g * mask
        dnw[layer], dnb[layer] = (da * xh).sum((0, 1)), da.sum((0, 1))
        dxh = da * norm_w[layer]
        dy = rstd * (dxh - dxh.mean(-1, keepdim=True)
                     - xh * (dxh * xh).sum(-1, keepdim=True) / (c - 1))
        db[layer] = dy.sum((0, 1))
        if jitter:
            dy = dy * (1 + jitter * torch.randn(
                dy.shape, generator=gen, device=dy.device, dtype=f64))
        dyb = dy.to(torch.bfloat16).to(f64).transpose(1, 2)
        dw[layer] = torch.nn.grad.conv1d_weight(
            inputs[layer], conv_w[layer].shape, dyb, stride=s, padding=p)
        g = torch.nn.grad.conv1d_input(inputs[layer].shape, conv_w[layer],
                                       dyb, stride=s, padding=p)
        g = g[:, 0] if layer == 0 else g.transpose(1, 2)
    return forward, [g] + [t.reshape(p.shape) for t, p in
                           zip(dw + db + dnw + dnb, params)]


def check_encoder(dev, gen):
    """The encoder kernels against their plain version at the recipe (16 x
    20,480 samples, C = 256) and at ENCODER_EDGE_SHAPES in their bf16
    working type, forward and backward, the backward bit for bit across two
    calls; timed by device time (split by part: layers 2-5's products, the
    norms, the sums of partials, layer 1) with `nn.Conv1d` + ChannelNorm
    under TF32 (the port's default route) as the yardstick. The products
    take bf16 operands, so the bound is reckoned at the bf16 tensor-core
    rate."""
    from cpc2_torch.models.encoder import CONV_STACK
    from cpc2_torch.profile_step import encoder_parts
    from cpc2_torch.time_kernels import encoder_inputs
    own = torch.Generator(device=dev)
    own.manual_seed(1)
    for shape in ENCODER_EDGE_SHAPES:
        _m, edge_params, edge_x, edge_cot = encoder_inputs(dev, own, *shape)
        _e, r, _b, _t, plain_r = hold_encoder(edge_params, edge_x,
                                              [edge_cot], own_decisions=True)
        log(f"  encoder at {shape}: every layer's pre-norm output and "
            f"activation as its own stored input gives them; every gradient "
            f"within {max(r):.2f} x its jitter spread about the reference "
            f"with the kernels' own decisions; backward bit for bit across "
            f"two calls "
            f"(against encoder_plain: {max(plain_r):.2f} x its band, "
            f"{ENCODER_NAMES[plain_r.index(max(plain_r))]})")
    n, t, c = 16, 20480, 256
    module, params, x, cot = encoder_inputs(dev, gen, n, t, c)
    cot = [cot]
    errs, ratios, bands, timed, _r = hold_encoder(params, x, cot)
    kern, plain, bwd_k, bwd_p, out_k, grad_k = timed
    log(f"  encoder kernel vs plain at the recipe, relative 2-norm: output "
        f"{errs[0]:.2e} max abs ({ratios[0]:.2f} x its band {bands[0]:.2e}); "
        f"each gradient at most {max(ratios[1:]):.2f} x the plain version's "
        f"own fp32-vs-fp64 spread, which is {min(bands[1:]):.2e} to "
        f"{max(bands[1:]):.2e}; backward bit for bit across two calls")
    err_f, err_b = errs[0], max(errs[1:])
    with torch.no_grad():
        fwd_split = device_split(lambda: kern(x, *params))
        plain_fwd_ms = device_ms(lambda: plain(x, *params))
        events = {"encoder_fwd": cuda_ms(lambda: kern(x, *params))}
    bwd_split = device_split(bwd_k)
    plain_bwd_ms = device_ms(bwd_p)
    events["encoder_bwd"] = cuda_ms(bwd_k)
    fwd_ms, bwd_ms = sum(fwd_split.values()), sum(bwd_split.values())
    log("[encoder] at the recipe, device ms per call by part: forward "
        + json.dumps(encoder_parts(fwd_split)) + ", backward "
        + json.dumps(encoder_parts(bwd_split)))

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        x_m = x.detach().requires_grad_(True)
        out_m = module(x_m)
        with torch.no_grad():
            cudnn_fwd_ms = device_ms(lambda: module(x))
        cudnn_bwd_ms = device_ms(lambda: torch.autograd.grad(
            out_m, [x_m] + params, cot, retain_graph=True))
    finally:
        torch.backends.cudnn.allow_tf32 = saved

    flops, length, cin = 0, t, 1
    for k, s, _p in CONV_STACK:
        length //= s
        flops += 2 * n * length * k * cin * c
        cin = c
    src = "cpc2_torch/csrc/encoder.cu"
    rep = "cpc2_tpu/ops/encoder_pallas.py"
    yard = {"encoder_fwd": cudnn_fwd_ms, "encoder_bwd": cudnn_bwd_ms}
    return [
        kernel_entry("encoder_fwd", src, rep + ":340", err_f, fwd_ms,
                     plain_fwd_ms, None, nbytes(x, *params, *out_k), flops,
                     BF16_FLOP_PER_S),
        kernel_entry("encoder_bwd", src, rep + ":362", err_b, bwd_ms,
                     plain_bwd_ms, None,
                     nbytes(x, *params, *cot) + nbytes(*grad_k), 2 * flops,
                     BF16_FLOP_PER_S)], yard, events


FUSED = ("CPC2_FUSED_ATTENTION", "CPC2_FUSED_ENCODER")


@contextlib.contextmanager
def fused_switches(on: bool):
    """Both opt-in kernels' variables set to 1 (on) or unset (off) inside
    the block, restored after."""
    saved_env = {k: os.environ.get(k) for k in FUSED}
    for k in FUSED:
        if on:
            os.environ[k] = "1"
        else:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# Step card against CPU under `bf16mix`: the FFN (and, with both opt-in
# kernels, the encoder) rounds to bf16 on both devices at the same points,
# but a value within fp32 reordering noise of a rounding boundary rounds
# differently on the two, and a ReLU whose input lies that close to 0 flips
# (see FFN_BAND); every later layer and gradient carries that chatter. So
# the losses are held to FUSED_LOSS_RTOL of their largest value and each
# gradient, in the 2-norm of the difference over the CPU's, to
# FUSED_GRAD_NORM_TOL.
FUSED_LOSS_RTOL = 1e-3
FUSED_GRAD_NORM_TOL = 5e-2
# The gradients of each head's lin1 under `bf16mix`: the card's library
# matmuls run in TF32 and the CPU's in fp32, so the FFN's inputs already
# differ by TF32 noise when both sides round them to bf16, and a
# pre-activation within that of 0 switches its ReLU and a whole element of
# the hidden's gradient, which lin1's gradients take directly: one head's
# lin1 bias moves by 5.5e-2 in the 2-norm on an H100 (the same in every
# run: the step is deterministic). Every other tensor stays at
# FUSED_GRAD_NORM_TOL.
FFN_LIN1_GRAD_NORM_TOL = 1e-1
# (precision, both opt-in kernels, encoder and LSTM width): the last at a
# 512-wide model's width, whose LSTM takes the grid route
STEP_RUNS = (("fp32", False, 64), ("bf16mix", False, 64),
             ("bf16mix", True, 64), ("bf16mix", False, 512))


def check_step(dev, precision: str, fused: bool, width: int) -> tuple:
    """One training step on the card against the same step on the CPU at
    `width` (64: the LSTM's resident route; 512: its grid route, which the
    step must launch), same weights and negatives, dropout off: the
    per-head losses and every gradient. Under `fp32` the tolerance is 1e-3
    of each tensor's largest value: the whole network's sums run in other
    orders on the two devices (cuDNN's convolutions among them); under
    `bf16mix`, with or without `fused` (both opt-in kernels), see
    FUSED_GRAD_NORM_TOL. Parameters after the Adam step are not compared:
    where a gradient is near zero its first step is +-lr times the sign of
    a rounding error. Returns the max abs error and the card step's kernel
    launches."""
    from cpc2_torch.ops import _build
    from cpc2_torch.training import precision as library_precision
    with fused_switches(fused), library_precision(precision):
        _build.reset_launches()
        err = _check_step(dev, precision, fused, width)
        launches = dict(_build.LAUNCHES)
    ffn = FP32_FFN if precision == "fp32" else BF16_FFN
    lstm = LSTM_GRID if width == 512 else LSTM_RESIDENT
    check_launched(f"{precision} step at width {width}", launches,
                   ffn + lstm)
    others = [k for k in FFN_KERNELS + LSTM_RESIDENT + LSTM_GRID
              if k not in ffn + lstm and launches[k]]
    if others:
        raise AssertionError(f"the {precision} step at width {width} "
                             f"launched {others}")
    return err, launches


def _check_step(dev, precision: str, fused: bool, width: int) -> float:
    from cpc2_torch.config import parse_args
    from cpc2_torch.feature_loader import build_model
    from cpc2_torch.train import get_criterion
    from cpc2_torch.training import Trainer, make_optimizer
    args = parse_args(["--pathDB", ".", "--file_extension", ".wav",
                       "--hiddenEncoder", str(width), "--hiddenGar",
                       str(width), "--nPredicts", "3",
                       "--negativeSamplingExt", "16", "--sizeWindow", "3840",
                       "--random_seed", "0"])
    torch.manual_seed(0)
    rs = np.random.RandomState(0)
    batch = torch.from_numpy(rs.randn(4, 2, 1, 3840).astype(np.float32))
    w = 24 - 3
    neg = torch.from_numpy(rs.randint(0, 4 * 24, (4, 16, w)).astype(np.int32))
    results = []
    model_cpu = build_model(args)
    crit_cpu = get_criterion(args)
    for device in (torch.device("cpu"), dev):
        model = build_model(args).to(device)
        crit = get_criterion(args).to(device)
        model.load_state_dict(model_cpu.state_dict())
        crit.load_state_dict(crit_cpu.state_dict())
        for mod in crit.modules():
            if hasattr(mod, "rate"):
                mod.rate = 0.0
            if hasattr(mod, "dropout") and isinstance(mod.dropout, float):
                mod.dropout = 0.0
        named = (list(model.named_parameters(prefix="model"))
                 + list(crit.named_parameters(prefix="criterion")))
        params = [p for _name, p in named]
        trainer = Trainer(model, crit, make_optimizer(args, params))
        losses, _accs = trainer.train_step(batch.to(device), neg.to(device))
        results.append([losses.cpu()] + [p.grad.cpu() for p in params])
    if precision == "fp32":
        return compare("training step (card vs cpu)", results[1],
                       results[0], rtol=1e-3)
    what = f"{precision}{' fused' if fused else ''} step at width {width}"
    err = loss_err = compare(f"{what} losses (card vs cpu)",
                             results[1][:1], results[0][:1],
                             rtol=FUSED_LOSS_RTOL)
    rels = {}
    for (name, _p), card, cpu in zip(named, results[1][1:], results[0][1:]):
        if not torch.isfinite(card).all():
            raise AssertionError(f"{what} gradient {name}: non-finite")
        rels[name] = norm_rel(card, cpu)
        err = max(err, (card.double() - cpu.double()).abs().max().item())
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    log(f"  {what} card vs cpu: losses max abs err {loss_err:.2e}; worst "
        f"gradients (2-norm, relative; tolerance {FUSED_GRAD_NORM_TOL}, "
        f"lin1 {FFN_LIN1_GRAD_NORM_TOL}): "
        + ", ".join(f"{n} {r:.2e}" for n, r in worst))
    for name, rel in rels.items():
        tol = (FFN_LIN1_GRAD_NORM_TOL if ".ffnetwork.lin1." in name
               else FUSED_GRAD_NORM_TOL)
        if rel > tol:
            raise AssertionError(f"{what} gradient {name}: card vs cpu "
                                 f"{rel:.3e} (2-norm, relative)")
    return err


def step_determinism(dev, passes: int = 3, device_augment=None,
                     ctc: bool = False, flags=()) -> dict:
    """The recipe's training step at the CLI defaults (`bf16mix`, dropout
    on, one batch drawn with numpy, the generator reseeded before each
    pass) run forward and backward `passes` times on the same weights:
    whether the losses agree bit for bit, and each gradient that differs
    from the first pass's, by its largest difference. With
    `device_augment` (the trainer's argument) the views go through the
    device chain first, its generator reseeded before each pass too. With
    `ctc`, the `--supervised --pathPhone --CTC` step on phone labels drawn
    with numpy (torch's CUDA `ctc_loss` backward adds with atomics). A
    report of which ops a resumed run cannot replay; nothing here fails
    the run. `flags` go over the defaults (phase 10: `--encoder_type
    lfb`)."""
    from cpc2_torch.config import parse_args
    from cpc2_torch.feature_loader import build_model
    from cpc2_torch.train import get_criterion
    from cpc2_torch.training import Trainer, make_optimizer, precision
    args = parse_args(["--pathDB", ".", "--random_seed", "0"]
                      + (supervised_argv("ctc") if ctc else [])
                      + list(flags))
    torch.manual_seed(0)
    model = build_model(args).to(dev)
    criterion = get_criterion(args, SUP_SPEAKERS, SUP_PHONES).to(dev)
    named = (list(model.named_parameters(prefix="model"))
             + list(criterion.named_parameters(prefix="criterion")))
    gen = torch.Generator(device=dev)
    aug_gen = torch.Generator(device=dev)
    trainer = Trainer(model, criterion, make_optimizer(
        args, [p for _n, p in named]), gen, device_augment=device_augment,
        augment_generator=aug_gen)
    rs = np.random.RandomState(0)
    batch = torch.from_numpy(rs.randn(args.batchSizeGPU, 2, 1,
                                      args.sizeWindow).astype(
        np.float32)).to(dev)
    label = (torch.from_numpy(phone_runs(
        rs, args.batchSizeGPU, args.sizeWindow // 160, SUP_PHONES)).to(dev)
        if ctc else None)

    def one_pass():
        gen.manual_seed(0)
        aug_gen.manual_seed(0)
        model.train()
        criterion.train()
        for _n, p in named:
            p.grad = None
        losses, _accs = trainer._forward(batch, None, False,
                                         device_augment is not None,
                                         label=label)
        losses.sum().backward()
        torch.cuda.synchronize()
        return losses.detach(), {n: p.grad.detach().clone()
                                 for n, p in named}

    with precision(args.precision):
        runs = [one_pass() for _ in range(passes)]
    differing = {}
    for losses, grads in runs[1:]:
        if not torch.equal(losses, runs[0][0]):
            differing["losses"] = max(differing.get("losses", 0.0), (
                losses - runs[0][0]).abs().max().item())
        for n, g in grads.items():
            if not torch.equal(g, runs[0][1][n]):
                differing[n] = max(differing.get(n, 0.0), (
                    g - runs[0][1][n]).abs().max().item())
    return {"passes": passes, "gradients": len(named),
            "differing": differing}


# FLAC writing, in the format of the JAX package's test encoder
# (`tests/test_flac.py:encode_flac`, which this script cannot import): a
# STREAMINFO block, then frames of a fixed block size with a 16-bit block
# size code, 16 kHz, 16 bits a sample, each channel a fixed order-1
# subframe with one Rice partition (a block of one sample verbatim). That
# encoder writes bit by bit and takes minutes for this corpus; this one
# builds each frame's bits with numpy, and picks each subframe's Rice
# parameter from its residuals.

def _crc_table(poly: int, width: int) -> list:
    top, mask = 1 << (width - 1), (1 << width) - 1
    table = []
    for byte in range(256):
        crc = byte << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & mask if crc & top else (
                crc << 1) & mask
        table.append(crc)
    return table


_CRC8, _CRC16 = _crc_table(0x07, 8), _crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = _CRC8[crc ^ b]
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC16[(crc >> 8) ^ b]
    return crc


def _bits(values, n: int) -> np.ndarray:
    """Each value's low `n` bits, most significant first, as 0/1 bytes."""
    values = np.asarray(values, np.int64).reshape(-1, 1)
    return ((values >> np.arange(n - 1, -1, -1)) & 1).astype(
        np.uint8).ravel()


def _utf8(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    if n < 0x800:
        return bytes([0xC0 | (n >> 6), 0x80 | (n & 0x3F)])
    return bytes([0xE0 | (n >> 12), 0x80 | ((n >> 6) & 0x3F),
                  0x80 | (n & 0x3F)])


def _subframe(seg: np.ndarray) -> np.ndarray:
    """One channel of a block: fixed order 1, zigzag residuals Rice-coded
    with one parameter k (a unary quotient, then k bits)."""
    seg = seg.astype(np.int64)
    if len(seg) < 2:
        return np.concatenate([_bits(0b00000010, 8), _bits(seg & 0xFFFF, 16)])
    res = np.diff(seg)
    u = (res << 1) ^ (res >> 63)
    k = int(np.clip(np.floor(np.log2(u.mean() + 1)), 0, 14))
    q = u >> k
    lengths = q + 1 + k
    start = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    rice = np.zeros(int(lengths.sum()), np.uint8)
    rice[start + q] = 1
    if k:
        rice[(start + q + 1)[:, None] + np.arange(k)] = (
            (u & ((1 << k) - 1))[:, None] >> np.arange(k - 1, -1, -1)) & 1
    return np.concatenate([_bits(0b00010010, 8), _bits(seg[0] & 0xFFFF, 16),
                           _bits(0, 2), _bits(0, 4), _bits(k, 4), rice])


def encode_flac(path: str, channels, sr: int = 16000,
                block: int = 4096) -> None:
    """Write int16 `channels` (one array each) as a FLAC file."""
    n_ch, n = len(channels), len(channels[0])
    info = np.concatenate([_bits(block, 16), _bits(block, 16), _bits(0, 24),
                           _bits(0, 24), _bits(sr, 20), _bits(n_ch - 1, 3),
                           _bits(15, 5), _bits(n, 36), _bits(0, 128)])
    body = np.packbits(info).tobytes()
    out = bytearray(b"fLaC" + bytes([0x80]) + len(body).to_bytes(3, "big")
                    + body)
    for index, begin in enumerate(range(0, n, block)):
        size = min(block, n - begin)
        header = np.packbits(np.concatenate([
            _bits(0x3FFE, 14), _bits(0, 2), _bits(7, 4), _bits(5, 4),
            _bits(n_ch - 1, 4), _bits(4, 3), _bits(0, 1)])).tobytes()
        header += _utf8(index) + (size - 1).to_bytes(2, "big")
        header += bytes([_crc8(header)])
        frame = header + np.packbits(np.concatenate(
            [_subframe(c[begin:begin + size]) for c in channels])).tobytes()
        out += frame + _crc16(frame).to_bytes(2, "big")
    with open(path, "wb") as fh:
        fh.write(out)


def write_corpus(root: str, ext: str = ".flac", n_speakers: int = 4,
                 n_files: int = 3, seconds: float = 24.0,
                 seed: int = 0) -> dict:
    """LibriSpeech layout: <speaker>/<chapter>/<speaker>-<chapter>-<n><ext>,
    16 kHz, 16-bit FLAC (or WAV), each file a speaker-specific tone mix
    plus noise. Returns {path: int16 samples}."""
    from cpc2_torch.data.audio_io import save_wav
    rs = np.random.RandomState(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    written = {}
    for s in range(n_speakers):
        spk, chap = str(1000 + s), str(100 + s)
        folder = os.path.join(root, spk, chap)
        os.makedirs(folder)
        f0 = 90.0 + 37.0 * s
        for i in range(n_files):
            x = (0.2 * np.sin(2 * np.pi * f0 * t * (1 + 0.01 * i))
                 + 0.1 * np.sin(2 * np.pi * 3.1 * f0 * t)
                 + 0.05 * rs.randn(n)).astype(np.float32)
            path = os.path.join(folder, f"{spk}-{chap}-{i:04d}{ext}")
            # the samples `save_wav` writes
            pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype(
                np.int16)
            if ext == ".flac":
                encode_flac(path, [pcm])
            else:
                save_wav(path, x, 16000)
            written[path] = pcm
    return written


def check_corpus(work: str) -> dict:
    """The training corpus as FLAC (`train_db`) and as WAV (`train_db_wav`,
    the same samples). Every FLAC file must decode bit for bit to its
    samples; then each corpus is loaded as the trainer loads it
    (`AudioBatchData`, two loader threads) and timed on the host clock,
    and the two must hold the same samples."""
    from cpc2_torch.data import AudioBatchData, find_all_seqs
    from cpc2_torch.data.audio_io import load_audio
    from cpc2_torch.ops import _build
    start = time.perf_counter()
    flac = write_corpus(os.path.join(work, "train_db"))
    write_corpus(os.path.join(work, "train_db_wav"), ".wav")
    write_s = time.perf_counter() - start
    _build.host_library("flacdec")
    for path, pcm in flac.items():
        x, sr = load_audio(path)
        if sr != 16000 or not np.array_equal(
                x, pcm.astype(np.float32) / 32768.0):
            raise AssertionError(f"{path} does not decode to its samples")
    load_s, data = {}, {}
    for ext, name in ((".flac", "train_db"), (".wav", "train_db_wav")):
        root = os.path.join(work, name)
        seqs, speakers = find_all_seqs(root, extension=ext)
        start = time.perf_counter()
        dataset = AudioBatchData(root, 20480, seqs, None, len(speakers),
                                 nProcessLoader=2)
        load_s[ext] = time.perf_counter() - start
        data[ext] = np.asarray(dataset.data).copy()
        dataset.close()
    if not np.array_equal(data[".flac"], data[".wav"]):
        raise AssertionError("the FLAC and WAV corpora loaded differently")
    n_bytes = {ext: sum(os.path.getsize(p) for p in glob.glob(os.path.join(
        work, name, "*", "*", "*" + ext))) for ext, name in (
        (".flac", "train_db"), (".wav", "train_db_wav"))}
    return {"files": len(flac), "seconds_of_audio": sum(
        len(p) for p in flac.values()) / 16000, "write_s": write_s,
        "load_s_flac": load_s[".flac"], "load_s_wav": load_s[".wav"],
        "bytes_flac": n_bytes[".flac"], "bytes_wav": n_bytes[".wav"],
        "decoded_bit_for_bit": True}


# The augmented epochs' chain: every host stage kind (the band-stop, the
# WSOLA pitch shift, the reverb's filter chain and dropout, the noise
# corpus's windows, the impulse responses).
AUGMENT_TYPES = ("bandreject", "pitch", "artificial_reverb_dropout",
                 "additive", "natural_reverb")
# [augment]: (label, --augment_type, --pitch_algo), one row a device
# function; the two WSOLA rows also hold their segment positions equal
AUGMENT_CHECKS = (
    ("bandreject", "bandreject", "wsola"),
    ("pitch_wsola", "pitch", "wsola"),
    ("pitch_vocoder", "pitch", "vocoder"),
    ("pitch_quick", "pitch_quick", "vocoder"),
    ("pitch_dropout", "pitch_dropout", "wsola"),
    ("time_dropout", "time_dropout", "wsola"),
    ("gaussian_noise", "random_noise", "wsola"),
    ("artificial_reverb", "artificial_reverb", "wsola"),
    ("artificial_reverb_dropout", "artificial_reverb_dropout", "wsola"),
    ("natural_reverb", "natural_reverb", "wsola"),
    ("additive", "additive", "wsola"),
)
# card against CPU at the same draws, relative to the CPU result's peak
AUGMENT_RTOL = 1e-4


def write_sounds(work: str, seed: int = 1) -> dict:
    """What the augmented phases read, synthesised from `seed`: a noise
    corpus (`noise/`, 4 WAV files of 12 s of white and coloured noise), a
    directory of 6 impulse responses (`irs/`, a direct path then 0.05 to
    0.4 s of decaying noise) and `train_db_part`, the first FLAC file of
    each speaker of `train_db`, the part of the corpus the augmented epochs
    train on (the host chain takes seconds a batch)."""
    import shutil

    from scipy import signal

    from cpc2_torch.data.audio_io import save_wav
    rs = np.random.RandomState(seed)
    for i, pole in enumerate((0.0, 0.6, 0.95, -0.7)):
        folder = os.path.join(work, "noise", f"n{i % 2}")
        os.makedirs(folder, exist_ok=True)
        x = signal.lfilter([1.0], [1.0, -pole], rs.randn(12 * 16000))
        save_wav(os.path.join(folder, f"noise-{i}.wav"),
                 (0.5 * x / np.abs(x).max()).astype(np.float32), 16000)
    os.makedirs(os.path.join(work, "irs"))
    for k in range(6):
        n = int(16000 * (0.05 + 0.07 * k))
        ir = 0.3 * rs.randn(n) * np.exp(-6.9 * np.arange(n) / n)
        ir[0] = 1.0
        save_wav(os.path.join(work, "irs", f"ir{k}.wav"),
                 (ir / np.abs(ir).max()).astype(np.float32), 16000)
    part = os.path.join(work, "train_db_part")
    for first in sorted(glob.glob(os.path.join(work, "train_db", "*", "*",
                                               "*-0000.flac"))):
        folder = os.path.join(part, *first.split(os.sep)[-3:-1])
        os.makedirs(folder)
        shutil.copy(first, folder)
    return {"noise": os.path.join(work, "noise"),
            "irs": os.path.join(work, "irs"), "part": part}


def augment_windows(b: int = 8, w: int = 20480, seed: int = 2) -> np.ndarray:
    """(b, w) float32 windows like the corpus's: two tones and noise."""
    rs = np.random.RandomState(seed)
    t = np.arange(w) / 16000.0
    return np.stack([0.3 * np.sin(2 * np.pi * (110 + 23 * i) * t)
                     + 0.1 * np.sin(2 * np.pi * (370 + 41 * i) * t)
                     + 0.05 * rs.randn(w) for i in range(b)]
                    ).astype(np.float32)


def host_reference(label: str, x: np.ndarray, params, stage) -> tuple:
    """The host pipeline's result (`cpc2_torch.data.augmentation`, numpy
    and scipy in float64) for the windows `rows` of `x` at the drawn
    `params`, and its tolerance: the JAX package's tests' (the band-stop's
    2e-4; the WSOLA and quick pitch shifts' 2e-3 and the vocoder's 2e-2 of
    the peak; the reverbs' 2e-3 of the peak, on two windows, the host's
    filter chain taking 0.3 s a window; the impulse responses' and the
    noise mix's 2e-3), exact for time dropout, and 1e-5 of the peak for
    the Gaussian noise, whose noise is given."""
    from scipy import signal

    from cpc2_torch.data import augmentation as host
    p = [q.numpy() for q in params]
    w = x.shape[1]
    peak = float(np.abs(x).max())
    rows = list(range(x.shape[0]))

    def dropout(y, start, span):
        y = np.array(y, np.float64)
        y[start:start + span] = 0.0
        return y

    def shift(i, **kw):
        return host.pitch_shift(x[i:i + 1].astype(np.float64), p[0][i],
                                **kw)[0]

    if label == "bandreject":
        lo, hi = p
        ref = [x[i] if hi[i] - lo[i] < 2.0 else signal.fftconvolve(
            x[i].astype(np.float64), signal.firwin(
                1021, [lo[i], hi[i]], fs=16000, window=('kaiser', 12.0),
                pass_zero='bandstop'), mode='same') for i in rows]
        return rows, ref, 2e-4
    if label == "pitch_wsola":
        return rows, [shift(i) for i in rows], 2e-3 * peak
    if label == "pitch_vocoder":
        return rows, [shift(i, algo='vocoder') for i in rows], 2e-2 * peak
    if label == "pitch_quick":
        return rows, [shift(i, quick=True, algo='vocoder')
                      for i in rows], 2e-3 * peak
    if label == "pitch_dropout":
        return rows, [dropout(shift(i), p[1][i], p[2][i])
                      for i in rows], 2e-3 * peak
    if label == "time_dropout":
        return rows, [dropout(x[i], p[0][i], p[1][i]) for i in rows], 0.0
    if label == "gaussian_noise":
        alpha = [10.0 ** 1.5 / (x[i].astype(np.float64).std() + 1e-12)
                 for i in rows]
        return rows, [x[i] + p[0][i] / alpha[i] for i in rows], 1e-5 * peak
    if label in ("artificial_reverb", "artificial_reverb_dropout"):
        level = 100.0 if label == "artificial_reverb" else 50.0
        ref = [host._freeverb(x[i].astype(np.float64), level, level,
                              float(p[0][i])) for i in rows[:2]]
        if label == "artificial_reverb_dropout":
            ref = [dropout(y, p[1][i], p[2][i]) for i, y in enumerate(ref)]
        return rows[:2], ref, 2e-3 * max(np.abs(y).max() for y in ref)
    if label == "natural_reverb":
        idx, u = p
        ref = []
        for i in rows:
            ir = stage.bank[idx[i] if len(idx) > 1 else idx[0]]
            wet = signal.fftconvolve(x[i].astype(np.float64), ir)[:w]
            ref.append(host.peak_normalization(wet if u[i] < 1.0 else x[i]))
        return rows, ref, 2e-3
    if label == "additive":
        idx, snr = p
        return rows, [host.peak_normalization(
            host.energy_normalization(x[i].astype(np.float64))
            + host.energy_normalization(stage.bank[idx[i], :w].astype(
                np.float64)) * 10.0 ** (-snr[i] / 20.0)) for i in rows], 2e-3
    raise ValueError(label)


def noise_dataset(sounds: dict, w: int = 20480):
    """The noise corpus as the trainer loads it (peak-normalised windows
    of `w` samples)."""
    from cpc2_torch.data import AudioBatchData, PeakNorm, find_all_seqs
    seqs, _ = find_all_seqs(sounds["noise"], extension=".wav",
                            speaker_level=0)
    return AudioBatchData(sounds["noise"], w, seqs, None, 1, nProcessLoader=2,
                          transform=PeakNorm())


def check_augment(dev, sounds: dict, noise) -> dict:
    """[augment]: each device augmentation (`cpc2_torch/data/
    augment_device.py`) at the recipe's batch, 8 windows of 20,480
    samples: its draws made on the card, applied there and, the same
    draws, on the CPU; the two held to AUGMENT_RTOL of the peak, the WSOLA
    stages' segment positions equal, and the card's result held to the
    host pipeline's (`host_reference`). Times each apply on the card, and
    the augmented epochs' chain for one step (both views, draws
    included). Fails on any mismatch."""
    from cpc2_torch.data import augment_device as ad
    b, w = 8, 20480
    x = augment_windows(b, w)
    x_cpu = torch.from_numpy(x)
    x_dev = x_cpu.to(dev)
    out = {}
    for label, name, algo in AUGMENT_CHECKS:
        stage = ad.make_device_augment(
            [name], noise_dataset=noise, batch_size=b,
            ir_paths=sounds["irs"], pitch_algo=algo).stages[0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = stage.draw(b, w, gen)
        cpu_params = tuple(q.cpu() for q in params)
        y_dev = stage.apply(x_dev, *params).cpu()
        y_cpu = stage.apply(x_cpu, *cpu_params)
        peak = y_cpu.abs().max().item()
        err = (y_dev - y_cpu).abs().max().item()
        if not err <= AUGMENT_RTOL * peak:
            raise AssertionError(f"[augment] {label}: card vs cpu "
                                 f"{err:.3e} (peak {peak:.3e})")
        steps = None
        if label in ("pitch_wsola", "pitch_dropout"):
            on_dev = ad.wsola_positions(x_dev, params[0]).cpu()
            on_cpu = ad.wsola_positions(x_cpu, cpu_params[0])
            if not torch.equal(on_dev, on_cpu):
                raise AssertionError(
                    f"[augment] {label}: WSOLA positions differ at "
                    f"{(on_dev != on_cpu).nonzero().tolist()[:8]}")
            steps = on_dev.shape[1]
        rows, ref, tol = host_reference(label, x, cpu_params, stage)
        host_err = max(float(np.abs(y_dev[i].double().numpy() - r).max())
                       for i, r in zip(rows, ref))
        if not host_err <= tol:
            raise AssertionError(f"[augment] {label}: card vs host "
                                 f"{host_err:.3e} > {tol:.3e}")
        ms = cuda_ms(lambda: stage.apply(x_dev, *params), iters=10)
        out[label] = {"card_vs_cpu": err, "peak": peak,
                      "card_vs_host": host_err, "host_tol": tol,
                      "host_windows": len(rows), "ms": ms,
                      "wsola_steps": steps}
        log(f"[augment] {label} (--augment_type {name}, --pitch_algo "
            f"{algo}): card vs cpu {err:.2e} (<= {AUGMENT_RTOL:g} of "
            f"the peak {peak:.3f}), card vs host {host_err:.2e} on "
            f"{len(rows)} windows (<= {tol:.2e})"
            + (f", WSOLA positions equal ({steps} steps x {b})"
               if steps else "") + f", apply {ms:.3f} ms on the card")
    chain = ad.make_device_augment(AUGMENT_TYPES, noise_dataset=noise,
                                   batch_size=b, ir_paths=sounds["irs"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    step_ms = cuda_ms(lambda: (chain(x_dev, gen), chain(x_dev, gen)),
                      iters=10)
    return {"checks": out, "chain": list(AUGMENT_TYPES),
            "chain_ms_per_step": step_ms}


TRAINING_KERNELS = ("lstm_fwd", "lstm_bwd", "ffn_fwd", "ffn_bwd",
                    "infonce_fwd", "infonce_bwd")
FUSED_KERNELS = ("attention_fwd", "attention_bwd", "encoder_fwd",
                 "encoder_bwd")
BF16_FFN = ("ffn_fwd", "ffn_bwd")
FP32_FFN = ("ffn_fwd_fp32", "ffn_bwd_fp32")
FFN_KERNELS = BF16_FFN + FP32_FFN
# the training kernels under `--precision fp32`: the FFN's fp32 route
FP32_KERNELS = ("lstm_fwd", "lstm_bwd", "infonce_fwd", "infonce_bwd",
                *FP32_FFN)
# the ABX corpus's tokens sit in DTW buckets 16 and 32: the lane route
ABX_KERNELS = ("dtw", "dtw_lanes", "lstm_fwd")
# the LSTM's routes: the resident one at H = 256, the grid one at H = 512
LSTM_RESIDENT = ("lstm_fwd", "lstm_bwd")
LSTM_GRID = ("lstm_fwd_grid", "lstm_bwd_grid")
# the wide epoch's kernels: the LSTM's grid route, the bf16 FFN and InfoNCE
WIDE_KERNELS = LSTM_GRID + ("ffn_fwd", "ffn_bwd", "infonce_fwd",
                            "infonce_bwd")
# the flags of a 512-wide model (the width of the larger published CPC
# models), every other one at the CLI default
WIDE = ["--hiddenEncoder", "512", "--hiddenGar", "512"]


def check_launched(path: str, launches: dict, kernels) -> None:
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: "
                             f"{missing}")


EPOCHS = {  # kernels each epoch must launch, and kernels it must not
    "default": (TRAINING_KERNELS, FUSED_KERNELS + FP32_FFN + LSTM_GRID),
    "fused": (TRAINING_KERNELS + FUSED_KERNELS, FP32_FFN + LSTM_GRID),
    "fp32": (FP32_KERNELS, FUSED_KERNELS + BF16_FFN + LSTM_GRID),
    "wide": (WIDE_KERNELS, FUSED_KERNELS + FP32_FFN + LSTM_RESIDENT),
    "profiled": (TRAINING_KERNELS, FUSED_KERNELS + FP32_FFN + LSTM_GRID),
    # the default epoch's kernels, on `train_db_part` with AUGMENT_TYPES
    "augmented_host": (TRAINING_KERNELS,
                       FUSED_KERNELS + FP32_FFN + LSTM_GRID),
    "augmented_host_noprefetch": (TRAINING_KERNELS,
                                  FUSED_KERNELS + FP32_FFN + LSTM_GRID),
    "augmented_device": (TRAINING_KERNELS,
                         FUSED_KERNELS + FP32_FFN + LSTM_GRID),
    # [dispatch]: the graph route (DISPATCH_FLAGS) at the defaults, with the
    # augmented_device epoch's flags on `train_db` beside the same epoch at
    # N = 1 (`device_augmented`), and across a learning-rate halving
    # (SCHEDULE_FLAGS) beside the same two epochs at N = 1
    "dispatch": (TRAINING_KERNELS, FUSED_KERNELS + FP32_FFN + LSTM_GRID),
    "device_augmented": (TRAINING_KERNELS,
                         FUSED_KERNELS + FP32_FFN + LSTM_GRID),
    "dispatch_augmented": (TRAINING_KERNELS,
                           FUSED_KERNELS + FP32_FFN + LSTM_GRID),
    "schedule": (TRAINING_KERNELS, FUSED_KERNELS + FP32_FFN + LSTM_GRID),
    "dispatch_schedule": (TRAINING_KERNELS,
                          FUSED_KERNELS + FP32_FFN + LSTM_GRID),
}


def train_argv(work: str, ck: str, *extra, db: str = "train_db") -> list:
    """The trainer's command line at its CLI defaults on the FLAC corpus
    (`db` under `work`): no flag but the corpus, the epochs, the seed, the
    loader threads, the logging step and the checkpoint directory."""
    return ["--pathDB", os.path.join(work, db), "--nEpoch", "1",
            "--random_seed", "0", "--n_process_loader", "2",
            "--logging_step", "10", "--pathCheckpoint", ck, *extra]


def augment_argv(work: str) -> list:
    """The augmented epochs' flags: both views through AUGMENT_TYPES, the
    noise corpus and the impulse responses of `write_sounds`."""
    return ["--augment_past", "--augment_future", "--augment_type",
            *AUGMENT_TYPES, "--pathDBNoise", os.path.join(work, "noise"),
            "--pathImpulseResponses", os.path.join(work, "irs")]


def run_training(dev, work: str, mode: str = "default") -> dict:
    """One epoch at the CLI defaults with `--pathCheckpoint <work>/ck_<mode>`:
    `default`; `fused`, with both opt-in kernels' variables set; `fp32`,
    with `--precision fp32` (the FFN's fp32 route); `wide`, with WIDE (a
    512-wide encoder and LSTM: the LSTM's grid route); `profiled`, with
    `--profile_dir <work>/profile`; and on `train_db_part` with
    `augment_argv`, `augmented_host` (`--host_prefetch 2`, the default),
    `augmented_host_noprefetch` (`--host_prefetch 0`) and
    `augmented_device` (`--augment_on_device`); the graph route
    (DISPATCH_FLAGS) `dispatch`, and on `train_db` with `augmented_device`'s
    flags `device_augmented` at N = 1 and `dispatch_augmented` on the graph
    route; and two epochs across a learning-rate halving (SCHEDULE_FLAGS),
    `schedule` at N = 1 and `dispatch_schedule` on the graph route; phase
    11's BF16_EPOCHS with their flags (and opt-in kernels)."""
    from cpc2_torch.ops import _build
    from cpc2_torch.train import main
    ck = os.path.join(work, f"ck_{mode}")
    extra = {"fp32": ["--precision", "fp32"], "wide": WIDE,
             "profiled": ["--profile_dir", os.path.join(work, "profile")],
             "augmented_host": ["--host_prefetch", "2"],
             "augmented_host_noprefetch": ["--host_prefetch", "0"],
             "augmented_device": ["--augment_on_device"],
             "dispatch": DISPATCH_FLAGS,
             "device_augmented": augment_argv(work) + ["--augment_on_device"],
             "dispatch_augmented": augment_argv(work) + [
                 "--augment_on_device"] + DISPATCH_FLAGS,
             "schedule": SCHEDULE_FLAGS,
             "dispatch_schedule": SCHEDULE_FLAGS + DISPATCH_FLAGS,
             }.get(mode, BF16_EPOCHS.get(mode, ([], False))[0])
    db = "train_db"
    if mode.startswith("augmented"):
        extra, db = augment_argv(work) + extra, "train_db_part"
    n_epochs = 2 if mode.endswith("schedule") else 1
    fused = mode == "fused" or BF16_EPOCHS.get(mode, ([], False))[1]
    live = torch.cuda.memory_allocated(dev)
    with fused_switches(fused):
        _build.reset_launches()
        record = main(train_argv(work, ck, *extra, db=db))
        launches = dict(_build.LAUNCHES)
    # the run's own peak: earlier checks of this process leave tensors live
    record["peak_above_live_bytes"] = record["peak_memory_bytes"] - live
    must, must_not = EPOCHS[mode] if mode in EPOCHS else BF16_EPOCH_KERNELS[
        mode]
    check_launched(f"{mode} training", launches, must)
    ran = [k for k in must_not if launches[k]]
    if ran:
        raise AssertionError(f"the {mode} training path launched {ran}")
    for name in ("checkpoint_0.pt", "checkpoint_args.json",
                 "checkpoint_logs.json"):
        if not os.path.exists(os.path.join(ck, name)):
            raise AssertionError(f"the trainer wrote no {name}")
    logs = record["logs"]
    for key in ("locLoss_train", "locAcc_train", "locLoss_val"):
        values = np.asarray(logs[key], dtype=np.float64)
        if values.shape != (n_epochs, 12) or not np.isfinite(values).all():
            raise AssertionError(f"{key}: {values}")
    if len(record["step_ms"]) < 5:
        raise AssertionError(f"only {len(record['step_ms'])} steps ran")
    if set(record["param_devices"]) != {str(dev)}:
        raise AssertionError(f"parameters on {record['param_devices']}")
    record["launches"] = launches
    record["checkpoint"] = os.path.join(ck, "checkpoint_0.pt")
    return record


# Name fragments of the default step's kernels in a trace: the resident
# LSTM's, InfoNCE's and the bf16 FFN's products.
TRACE_KERNELS = {"lstm": "lstm_fwd_resident", "infonce": "gathered_fwd",
                 "ffn": "ffn_wgmma_gemm"}


def check_trace(work: str) -> dict:
    """The `profiled` epoch's trace: one file, naming the LSTM's, InfoNCE's
    and the bf16 FFN's kernels; its window, the device's busy time, the
    host's share and the ten largest device entries
    (`cpc2_torch.profile_step.trace_summary`)."""
    from cpc2_torch.profile_step import trace_summary
    from cpc2_torch.train import TRACE_NAME
    folder = os.path.join(work, "profile")
    files = os.listdir(folder) if os.path.isdir(folder) else []
    if files != [TRACE_NAME]:
        raise AssertionError(f"--profile_dir wrote {files}")
    path = os.path.join(folder, TRACE_NAME)
    summary = trace_summary(path, top=10)
    with open(path) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]
                 if e.get("cat") == "kernel"}
    missing = [k for k, frag in TRACE_KERNELS.items()
               if not any(frag in n for n in names)]
    if missing:
        raise AssertionError(f"the trace names no {missing} kernel")
    summary["trace_bytes"] = os.path.getsize(path)
    return summary


def _flat(tree, prefix: str = "") -> dict:
    """The tensors of a checkpoint by dotted key."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def diff_checkpoints(path_a: str, path_b: str) -> dict:
    """{key: (max abs difference, relative 2-norm)} of every tensor that
    differs between two checkpoints; raises when their keys or shapes
    differ, or an integer tensor (the generator's state, a step count)."""
    a, b = (_flat(torch.load(p, weights_only=True)) for p in (path_a, path_b))
    if set(a) != set(b):
        raise AssertionError(f"checkpoint keys differ: {set(a) ^ set(b)}")
    out = {}
    for key in sorted(a):
        x, y = a[key], b[key]
        if x.shape != y.shape:
            raise AssertionError(f"{key}: {tuple(x.shape)} vs "
                                 f"{tuple(y.shape)}")
        if torch.equal(x, y):
            continue
        if not x.is_floating_point():
            raise AssertionError(f"{key} differs between {path_a} and "
                                 f"{path_b}")
        out[key] = ((x.double() - y.double()).abs().max().item(),
                    norm_rel(y, x))
    return out


def hold_resumed(whole: str, resumed: str) -> dict:
    """The tensors of `resumed`'s `checkpoint_1.pt` that differ from
    `whole`'s, each within the bf16mix step tolerance of PERF.md section 2
    in the 2-norm (lin1's looser)."""
    diffs = diff_checkpoints(os.path.join(whole, "checkpoint_1.pt"),
                             os.path.join(resumed, "checkpoint_1.pt"))
    for key, (_diff, rel) in diffs.items():
        tol = (FFN_LIN1_GRAD_NORM_TOL if ".ffnetwork.lin1." in key
               else FUSED_GRAD_NORM_TOL)
        if rel > tol:
            raise AssertionError(f"{key}: resumed vs uninterrupted {rel:.3e} "
                                 f"(2-norm, relative)")
    return diffs


def run_resume(work: str, tag: str = "", source: str = "ck_default",
               extra=()) -> dict:
    """Two epochs from scratch in `ck_whole<tag>` (with the flags
    `extra`); the one-epoch directory `source` (the default epoch's, or the
    `dispatch` epoch's for the graph route) copied to `ck_split<tag>` and
    resumed to two epochs. Every tensor of the two
    `checkpoint_1.pt`: bit for bit, or else within the bf16mix step
    tolerance (`hold_resumed`); integer tensors (the generator's state,
    step counts) equal. The two runs' `checkpoint_0.pt` (one epoch each
    from the same seed) are compared too, to tell a resume's difference
    from a run's; and `ck_same`, the whole run's own first epoch (its
    `checkpoint_0.pt` and the logs it wrote then) resumed to two epochs, is
    held to the whole run the same way: there the runs share the state the
    resume starts from."""
    import shutil

    from cpc2_torch.train import main
    whole = os.path.join(work, "ck_whole" + tag)
    split = os.path.join(work, "ck_split" + tag)
    same = os.path.join(work, "ck_same" + tag)
    shutil.copytree(os.path.join(work, source), split)
    start = time.perf_counter()
    main(train_argv(work, whole, "--nEpoch", "2", *extra))
    whole_s = time.perf_counter() - start
    start = time.perf_counter()
    main(["--pathCheckpoint", split, "--nEpoch", "2"])
    resume_s = time.perf_counter() - start
    os.makedirs(same)
    for name in ("checkpoint_0.pt", "checkpoint_args.json"):
        shutil.copy(os.path.join(whole, name), same)
    with open(os.path.join(whole, "checkpoint_logs.json")) as fh:
        logs = json.load(fh)
    with open(os.path.join(same, "checkpoint_logs.json"), "w") as fh:
        # what the whole run's logs held after its first epoch
        json.dump({k: v[:1] if isinstance(v, list) else v
                   for k, v in logs.items()}, fh)
    main(["--pathCheckpoint", same, "--nEpoch", "2"])
    diffs = {0: diff_checkpoints(os.path.join(whole, "checkpoint_0.pt"),
                                 os.path.join(split, "checkpoint_0.pt")),
             1: hold_resumed(whole, split)}
    same_diffs = hold_resumed(whole, same)
    n_tensors = len(_flat(torch.load(os.path.join(whole, "checkpoint_1.pt"),
                                     weights_only=True)))
    return {"bit_for_bit": not diffs[1], "tensors": n_tensors,
            "differing": {k: v[0] for k, v in list(diffs[1].items())[:12]},
            "n_differing": len(diffs[1]),
            "max_rel_2norm": max((v[1] for v in diffs[1].values()),
                                 default=0.0),
            "largest_rel_2norm": dict(sorted(
                ((k, v[1]) for k, v in diffs[1].items()),
                key=lambda kv: -kv[1])[:5]),
            "epoch0_differing": {k: v[0] for k, v in
                                 list(diffs[0].items())[:12]},
            "epoch0_n_differing": len(diffs[0]),
            "same_start_bit_for_bit": not same_diffs,
            "same_start_differing": {k: v[0] for k, v in
                                     list(same_diffs.items())[:12]},
            "two_epochs_s": whole_s, "resumed_epoch_s": resume_s}


# [dispatch]: `--steps_per_dispatch` groups of DISPATCH_N steps, each a
# CUDA graph replay (`cpc2_torch/training.py:MultiStep`), held against the
# same steps run eagerly. The setups: (name, precision, both opt-in kernels,
# encoder and LSTM width, the device augmentation chain on both views).
DISPATCH_N = 4
DISPATCH_SETUPS = (("default", "bf16mix", False, 256, False),
                   ("fused", "bf16mix", True, 256, False),
                   ("fp32", "fp32", False, 256, False),
                   ("wide", "bf16mix", False, 512, False),
                   ("augmented", "bf16mix", False, 256, True),
                   # `--supervised` on speaker labels
                   ("speaker", "bf16mix", False, 256, False))
# the kernels each setup's step must launch inside the graph
DISPATCH_KERNELS = {"default": TRAINING_KERNELS,
                    "bf16": LSTM_RESIDENT + ("infonce_fwd", "infonce_bwd",
                                             "ffn_fwd_bf16io", "ffn_bwd_bf16io",
                                             "adam_bf16_moment"),
                    "fused": TRAINING_KERNELS + FUSED_KERNELS,
                    "fp32": FP32_KERNELS, "wide": WIDE_KERNELS,
                    "augmented": TRAINING_KERNELS,
                    "speaker": LSTM_RESIDENT,
                    # phase 12: batch 64 in groups of 8
                    "neg_pool": LSTM_RESIDENT + BF16_FFN + (
                        "infonce_fwd_grouped", "infonce_bwd_grouped")}
# Where a replay is not bit for bit the eager steps (a library kernel
# choosing another algorithm under capture), the differing tensors are
# held to `tests/test_multi_step.py`'s tolerances: losses atol 1e-6,
# parameters and Adam's moments atol 2e-5.
DISPATCH_LOSS_ATOL, DISPATCH_PARAM_ATOL = 1e-6, 2e-5
# the flags of the CLI's graph route, N = 4 with the pack on the device
DISPATCH_FLAGS = ["--corpus_on_device", "--steps_per_dispatch",
                  str(DISPATCH_N)]
# two epochs across a learning-rate halving: a captured graph keeps the
# rate it was captured with, so the route must capture again
SCHEDULE_FLAGS = ["--schedulerStep", "1", "--nEpoch", "2"]


def dispatch_trainer(dev, width: int, chain=None, supervised=False,
                     flags=()):
    """A trainer at the recipe's CLI defaults and `width` (with
    `supervised`, `--supervised` over SUP_SPEAKERS speakers), and `flags`
    over them, its Adam capturable, built from seed 0: (args, trainer)."""
    from cpc2_torch.config import parse_args
    from cpc2_torch.feature_loader import build_model
    from cpc2_torch.train import get_criterion
    from cpc2_torch.training import Trainer, make_optimizer
    args = parse_args(["--pathDB", ".", "--random_seed", "0",
                       "--hiddenEncoder", str(width), "--hiddenGar",
                       str(width)] + (["--supervised"] if supervised else [])
                      + list(flags))
    torch.manual_seed(0)
    model = build_model(args).to(dev)
    criterion = get_criterion(args, SUP_SPEAKERS).to(dev)
    params = list(model.parameters()) + list(criterion.parameters())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    aug_gen = torch.Generator(device=dev)
    aug_gen.manual_seed(1)
    trainer = Trainer(model, criterion,
                      make_optimizer(args, params, capturable=True), gen,
                      device_augment=(None if chain is None
                                      else (chain, True, True, False)),
                      augment_generator=aug_gen)
    return args, trainer


def trainer_state(trainer) -> dict:
    """Every parameter, Adam's moments and step counts, and both
    generators' states of `trainer`, by name."""
    out = {}
    named = (list(trainer.model.named_parameters(prefix="model"))
             + list(trainer.criterion.named_parameters(prefix="criterion")))
    for name, p in named:
        out[name] = p.detach()
        for key, value in trainer.optimizer.state[p].items():
            out[f"{name}.{key}"] = value
    out["generator"] = trainer.generator.get_state()
    out["augment_generator"] = trainer.augment_generator.get_state()
    return out


def dispatch_corpus(dev, seconds: int = 120, seed: int = 3, batch: int = 8):
    """A resident pack of `seconds` of random 16-bit audio and groups of
    window offsets into it, (4, DISPATCH_N, batch) int32, drawn with
    numpy."""
    from cpc2_torch.data.device_corpus import DeviceCorpus
    rs = np.random.RandomState(seed)
    pack = rs.randint(-32768, 32768, 16000 * seconds).astype(
        np.float32) / 32768.0
    corpus = DeviceCorpus(20480, dev, pack.shape[0])
    corpus.ensure(pack)
    offsets = torch.from_numpy(rs.randint(
        0, pack.shape[0] - 20480, (4, DISPATCH_N, batch)).astype(np.int32))
    return corpus, offsets.pin_memory() if dev.type == "cuda" else offsets


def check_dispatch_setup(dev, setup, corpus, offsets, chain=None,
                         flags=()) -> dict:
    """One setup of DISPATCH_SETUPS: a `MultiStep` of DISPATCH_N steps
    from one seeded state, its first group the eager warm-up; the state
    then copied to a second trainer. Three groups on the first trainer as
    graph replays (the second a replay of the first's graph, the third at
    half the learning rate: captured again), and the same 3 x N steps
    eagerly on the second. The losses, every parameter, Adam's moments and
    step counts and both generators' states: bit for bit, else the
    differing tensors named and held to DISPATCH_*_ATOL. Each kernel's
    launches per replay must be N times its launches in an eager step, and
    the setup's kernels must launch inside the graph. `flags` go over the
    trainers' defaults (phase 11's bf16 setup)."""
    from cpc2_torch.ops import _build
    from cpc2_torch.training import MultiStep
    from cpc2_torch.training import precision as library_precision
    name, prec, fused, width, augmented = setup
    supervised = name == "speaker"
    labels = torch.from_numpy(np.random.RandomState(5).randint(
        0, SUP_SPEAKERS, tuple(offsets.shape))).to(dev)
    with fused_switches(fused), library_precision(prec):
        args, graphed = dispatch_trainer(dev, width,
                                         chain if augmented else None,
                                         supervised, flags)
        _, eager = dispatch_trainer(dev, width, chain if augmented else None,
                                    supervised, flags)
        multi = MultiStep(graphed, DISPATCH_N, corpus)
        if multi.route != "graph":
            raise AssertionError(f"[dispatch {name}] route {multi.route}")
        multi(offsets[0], labels[0])             # the warm-up, eager
        eager.model.load_state_dict(graphed.model.state_dict())
        eager.criterion.load_state_dict(graphed.criterion.state_dict())
        # a copy: `load_state_dict` would share the tensors it is given
        eager.optimizer.load_state_dict(
            copy.deepcopy(graphed.optimizer.state_dict()))
        eager.generator.set_state(graphed.generator.get_state())
        eager.augment_generator.set_state(
            graphed.augment_generator.get_state())
        lrs = (args.learningRate, args.learningRate, args.learningRate / 2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        rows, group_ms = [], []
        for g, lr in enumerate(lrs, start=1):
            graphed.set_learning_rate(lr)
            start = time.perf_counter()
            losses, _accs = multi(offsets[g], labels[g])
            rows.append(losses.clone())
            torch.cuda.synchronize()
            group_ms.append(1000.0 * (time.perf_counter() - start))
        launches = dict(_build.LAUNCHES)
        graph_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        eager_rows, per_step, eager_ms = [], None, []
        for g, lr in enumerate(lrs, start=1):
            eager.set_learning_rate(lr)
            start = time.perf_counter()
            for i in range(DISPATCH_N):
                batch = corpus.put(offsets[g][i])
                label = labels[g][i] if supervised else None
                if per_step is None:
                    _build.reset_launches()
                    eager_rows.append(eager.train_step(batch,
                                                       label=label)[0])
                    per_step = dict(_build.LAUNCHES)
                else:
                    eager_rows.append(eager.train_step(batch,
                                                       label=label)[0])
            torch.cuda.synchronize()
            eager_ms.append(1000.0 * (time.perf_counter() - start))
        eager_peak = torch.cuda.max_memory_allocated(dev)
    if multi.captures != 2:
        raise AssertionError(f"[dispatch {name}] {multi.captures} captures, "
                             f"not 2 (a learning-rate change must capture "
                             f"again)")
    counts = {k: (multi.launches.get(k, 0), per_step[k]) for k in per_step
              if per_step[k] or multi.launches.get(k, 0)}
    off = {k: v for k, v in counts.items() if v[0] != DISPATCH_N * v[1]
           or launches[k] != 3 * v[0]}
    if off:
        raise AssertionError(f"[dispatch {name}] launches a replay vs an "
                             f"eager step: {off}")
    check_launched(f"dispatch {name} graph",
                   {k: multi.launches.get(k, 0) for k in
                    DISPATCH_KERNELS[name]}, DISPATCH_KERNELS[name])
    got, want = torch.cat(rows), torch.cat(eager_rows)
    differing = {}
    if not torch.equal(got, want):
        differing["losses"] = (got - want).abs().max().item()
    state_g, state_e = trainer_state(graphed), trainer_state(eager)
    for key, value in state_g.items():
        if not torch.equal(value, state_e[key]):
            if not value.is_floating_point():
                raise AssertionError(f"[dispatch {name}] {key} differs "
                                     f"between the replays and the eager "
                                     f"steps")
            differing[key] = (value.double() - state_e[key].double()
                              ).abs().max().item()
    for key, diff in differing.items():
        tol = DISPATCH_LOSS_ATOL if key == "losses" else DISPATCH_PARAM_ATOL
        if diff > tol:
            raise AssertionError(f"[dispatch {name}] {key}: replay vs eager "
                                 f"{diff:.3e} > {tol}")
    return {"bit_for_bit": not differing, "differing": differing,
            "tensors": len(state_g) + 1, "captures": multi.captures,
            "launches_per_replay": multi.launches,
            "group_ms_graph": group_ms, "group_ms_eager": eager_ms,
            "peak_bytes_graph": graph_peak, "peak_bytes_eager": eager_peak}


def time_adam_routes(dev, iters: int = 10) -> dict:
    """One Adam step over the recipe's parameters (model and criterion at
    width 256, random gradients) by device time, for torch's three routes:
    `plain` (foreach, step counts on the host: the CPU runs' Adam),
    `capturable` (foreach, step counts and bias corrections on the
    device) and `fused` (fused and capturable: what `make_optimizer(...,
    capturable=True)` builds). Each: device ms and kernel launches a step,
    from one device-only profile of `iters` steps after 3 (the profiler
    can lose launches: a mean, not a count)."""
    from cpc2_torch.config import parse_args
    from cpc2_torch.feature_loader import build_model
    from cpc2_torch.profile_step import device_kernels, device_us
    from cpc2_torch.train import get_criterion
    args = parse_args(["--pathDB", ".", "--random_seed", "0"])
    torch.manual_seed(0)
    params = list(build_model(args).to(dev).parameters()) + list(
        get_criterion(args, SUP_SPEAKERS).to(dev).parameters())
    for p in params:
        p.grad = torch.randn_like(p) * 1e-3
    out = {"parameters": len(params)}
    for route, flags in (("plain", {}), ("capturable", {"capturable": True}),
                         ("fused", {"capturable": True, "fused": True})):
        opt = torch.optim.Adam(params, lr=2e-4, **flags)
        for _ in range(3):
            opt.step()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                opt.step()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        out[route] = {"ms": sum(map(device_us, kernels)) / 1e3 / iters,
                      "launches": sum(e.count for e in kernels) / iters}
    return out


def check_capturable_adam(dev, steps: int = 5) -> float:
    """`make_optimizer(..., capturable=True)`'s Adam, every card run's
    (torch's fused Adam, bias corrections on the card in fp32), against
    optax's `adam` formula in float64 over
    `steps` steps of random gradients: each parameter's total update held
    to 1e-4 of its largest value (the step tolerance of
    `tests/test_torch_step.py`). Returns the largest error over that
    value."""
    rs = np.random.RandomState(4)
    shapes = ((256, 512), (512,), (12, 256))
    lr, b1, b2, eps = 2e-4, 0.9, 0.999, 1e-8
    start = [rs.randn(*s) * 1e-2 for s in shapes]
    params = [torch.nn.Parameter(torch.from_numpy(x.astype(np.float32)).to(
        dev)) for x in start]
    from cpc2_torch.training import make_optimizer
    opt = make_optimizer(argparse.Namespace(
        optimizer="adam", learningRate=lr, beta1=b1, beta2=b2, epsilon=eps),
        params, capturable=True)
    if not (opt.param_groups[0]["fused"] and
            opt.param_groups[0]["capturable"]):
        raise AssertionError("the card's Adam is not fused and capturable")
    ref = [p.detach().double().cpu().numpy() for p in params]
    mu = [np.zeros(s) for s in shapes]
    nu = [np.zeros(s) for s in shapes]
    for t in range(1, steps + 1):
        grads = [rs.randn(*s).astype(np.float32) for s in shapes]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g).to(dev)
        opt.step()
        for i, g in enumerate(grads):
            g = g.astype(np.float64)
            mu[i] = b1 * mu[i] + (1 - b1) * g
            nu[i] = b2 * nu[i] + (1 - b2) * g * g
            ref[i] = ref[i] - lr * (mu[i] / (1 - b1 ** t)) / (
                np.sqrt(nu[i] / (1 - b2 ** t)) + eps)
    worst = 0.0
    for p, x0, want in zip(params, start, ref):
        got = p.detach().double().cpu().numpy() - x0.astype(np.float32)
        upd = want - x0.astype(np.float32)
        err = np.abs(got - upd).max() / np.abs(upd).max()
        worst = max(worst, float(err))
    if worst > 1e-4:
        raise AssertionError(f"capturable Adam vs optax: {worst:.3e} of the "
                             f"largest update")
    return worst


def hold_dispatch_epochs(graph: dict, eager: dict, what: str,
                         n_epochs: int = 1) -> dict:
    """A CLI run of the graph route (`DISPATCH_FLAGS`) against the same
    run at N = 1 with the corpus on the host: the route, its captures, its
    groups, and each epoch's mean training and validation losses and
    accuracies bit for bit (both runs update with the same capturable
    Adam, and a replay is bit for bit N eager steps: `[dispatch <setup>]`).
    Returns the largest differences, all zero."""
    if graph["dispatch"] != "graph" or graph["steps_per_dispatch"] != \
            DISPATCH_N:
        raise AssertionError(f"{what}: route {graph['dispatch']}, N "
                             f"{graph['steps_per_dispatch']}")
    if not graph["graph_captures"] >= n_epochs or not len(
            graph["dispatch_ms"]) < len(graph["step_ms"]):
        raise AssertionError(f"{what}: {graph['graph_captures']} captures, "
                             f"{len(graph['dispatch_ms'])} dispatches for "
                             f"{len(graph['step_ms'])} steps")
    out = {}
    for key in ("locLoss_train", "locAcc_train", "locLoss_val",
                "locAcc_val"):
        a = np.asarray(graph["logs"][key], np.float64)
        b = np.asarray(eager["logs"][key], np.float64)
        if a.shape != (n_epochs, 12) or b.shape != a.shape:
            raise AssertionError(f"{what} {key}: {a.shape} vs {b.shape}")
        out[key] = float(np.abs(a - b).max())
    differing = {k: v for k, v in out.items() if v != 0.0}
    if differing:
        raise AssertionError(f"{what}: graph vs eager epoch means differ "
                             f"(max abs) {differing}")
    return out


# files a speaker of the timing corpus: 8 (12 gave a third more steps an
# epoch, and the whole script came near its limit once phase 11 was added)
TIMING_FILES = 8
# the fresh processes of the [dispatch] timings: (label, flags), run in
# this order; then PROFILED_TIMINGS again under a device-only profiler
DISPATCH_TIMINGS = (("N=1 host corpus", []),
                    ("N=1 device corpus", ["--corpus_on_device"]),
                    ("N=4", DISPATCH_FLAGS),
                    ("N=8", ["--corpus_on_device", "--steps_per_dispatch",
                             "8"]))
# The profiled repeats: the graph route's busy share. The eager route's is
# the `profiled` epoch's (`[profile]`); repeating all four routes profiled
# took 150 s of a whole run that came to 1,177 s of its 1,200 s limit with
# phase 12 on an H100 80GB HBM3.
PROFILED_TIMINGS = ("N=4",)
# A timing process: `main` on argv[4:], its record's numbers written to
# argv[2]; with a trace path in argv[3], the whole run under
# `torch.profiler` with device activity only (no host events to slow the
# host), its Chrome trace written there.
RUNNER = ("import json, sys\n"
          "sys.path.insert(0, sys.argv[1])\n"
          "import torch\n"
          "from cpc2_torch.train import main\n"
          "if sys.argv[3]:\n"
          "    with torch.profiler.profile(activities=["
          "torch.profiler.ProfilerActivity.CUDA]) as prof:\n"
          "        r = main(sys.argv[4:])\n"
          "    prof.export_chrome_trace(sys.argv[3])\n"
          "else:\n"
          "    r = main(sys.argv[4:])\n"
          "keys = ('median_step_ms', 'median_dispatch_ms', 'step_ms', "
          "'dispatch_ms', 'peak_memory_bytes', 'dispatch', "
          "'steps_per_dispatch', 'graph_captures', 'audio_hours_per_hour')\n"
          "out = {k: r.get(k) for k in keys}\n"
          "out['epoch_steps'] = r['logs']['iter']\n"
          "json.dump(out, open(sys.argv[2], 'w'))\n")


def time_dispatch(work: str) -> list:
    """The default training on `timing_db` (2 speakers x TIMING_FILES
    files x 24 s of FLAC: a short batch a speaker breaks a group, so fewer
    speakers than `train_db`'s) in a fresh process per run, no
    checkpoint written: DISPATCH_TIMINGS in order for two epochs, then
    PROFILED_TIMINGS for one epoch under a device-only profiler. Median
    ms/step, the second epoch's mean ms/step (the warm-up, the capture and
    the first calls are in the first), median ms to dispatch, peak device
    memory and, from the profiled runs' traces (`trace_summary`), the
    device's busy share from the run's first kernel to its last (loading,
    validation and the profiler's own cost on the host included) and its
    busy ms per training step, which `main` sets beside the unprofiled
    runs' median ms/step."""
    from cpc2_torch.profile_step import trace_summary
    write_corpus(os.path.join(work, "timing_db"), n_speakers=2,
                 n_files=TIMING_FILES,
                 seed=5)
    runs = [(label, flags, False) for label, flags in DISPATCH_TIMINGS]
    runs += [(label, flags, True) for label, flags in DISPATCH_TIMINGS
             if label in PROFILED_TIMINGS]
    out = []
    for i, (label, flags, profiled) in enumerate(runs):
        result = os.path.join(work, f"timing_{i}.json")
        trace = os.path.join(work, f"timing_{i}.trace.json") \
            if profiled else ""
        argv = ["--pathDB", os.path.join(work, "timing_db"), "--nEpoch",
                "1" if profiled else "2", "--random_seed", "0",
                "--n_process_loader", "2",
                "--logging_step", "10", *flags]
        proc = subprocess.run(
            [sys.executable, "-c", RUNNER, ROOT, result, trace, *argv],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"[dispatch timing {label}] exit "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        with open(result) as fh:
            rec = json.load(fh)
        rec.update(label=label, profiled=profiled)
        if not profiled:
            rec["second_epoch_mean_ms"] = statistics.mean(
                rec["step_ms"][rec["epoch_steps"][0]:])
        if profiled:
            summary = trace_summary(trace)
            rec["busy_share"] = 1.0 - summary["host_share"]
            rec["trace_window_ms"] = summary["window_ms"]
            rec["trace_busy_ms"] = summary["device_busy_ms"]
            rec["trace_kernels"] = summary["kernel_launches"]
            rec["device_ms_per_step"] = summary["device_busy_ms"] / len(
                rec["step_ms"])
            os.remove(trace)
        out.append(rec)
    return out


def run_concat(dev, default_ck: str, wide_ck: str, paths) -> dict:
    """The default and wide checkpoints as one model (256 + 512 wide):
    features of `paths` on the card, the launch counts set to 0 just before
    and read just after; held against the CPU's and, channel by channel,
    against each model's own on the card."""
    from cpc2_torch.feature_loader import (FeatureModule, build_feature,
                                           build_feature_files, load_model)
    from cpc2_torch.models import ConcatenatedModel
    from cpc2_torch.ops import _build
    own_models = [load_model([ck]) for ck in (default_ck, wide_ck)]
    widths = np.cumsum([0] + [m[1] for m in own_models]).tolist()
    model, hidden_gar, hidden_encoder = load_model([default_ck, wide_ck])
    if not isinstance(model, ConcatenatedModel) or (
            hidden_gar, hidden_encoder) != (widths[-1], sum(
                m[2] for m in own_models)):
        raise AssertionError(f"concatenated model: {type(model).__name__}, "
                             f"{hidden_gar}, {hidden_encoder}")
    maker = FeatureModule(model.to(dev), False, keep_hidden=True)
    _build.reset_launches()
    start = time.perf_counter()
    card = build_feature_files(maker, paths)
    torch.cuda.synchronize()
    features_s = time.perf_counter() - start
    launches = dict(_build.LAUNCHES)
    check_launched("concatenated features", launches,
                   ("lstm_fwd", "lstm_fwd_grid"))
    for i, (own_model, _hg, _he) in enumerate(own_models):
        own = build_feature_files(FeatureModule(own_model.to(dev), False,
                                                keep_hidden=True), paths)
        for p in paths:
            part = card[p][..., widths[i]:widths[i + 1]]
            if not np.array_equal(part, own[p]):
                raise AssertionError(f"concatenated features of {p}, "
                                     f"channels {widths[i]}:{widths[i + 1]}, "
                                     f"differ from model {i}'s own")
    cpu = FeatureModule(model.cpu(), False, keep_hidden=True)
    err = compare("concatenated features (card vs cpu)",
                  [torch.from_numpy(card[p]) for p in paths[:2]],
                  [torch.from_numpy(build_feature(cpu, p))
                   for p in paths[:2]], rtol=1e-3)
    return {"files": len(paths), "widths": widths[1:],
            "dims": int(card[paths[0]].shape[-1]),
            "features_s": features_s, "max_abs_err_vs_cpu": err,
            "launches": {k: n for k, n in launches.items() if n}}


PHONES = {"aa": (220, 900), "iy": (260, 1150), "uw": (240, 800),
          "eh": (290, 1000), "sil": (120, 120)}


def write_phone_corpus(root: str, n_speakers: int = 4, n_files: int = 8,
                       n_tokens: int = 24) -> str:
    """A phone corpus and its `.item` file: each file is `n_tokens` phone
    tokens between silences, each token two tones of its phone, jittered,
    plus noise and a speaker hum. "aa" and "iy" last 0.10-0.15 s (9-14
    frames), "uw" and "eh" 0.20-0.30 s (19-29 frames), so that token
    lengths fall in DTW buckets 16 and 32. File i of every speaker has the
    same phones and timings, so feature extraction batches 4 files of one
    length. Beside the `.item` file it writes the phone labels of every
    file (`phone_labels_path`: one line a file, the index in PHONES of the
    token each 160-sample frame starts in, silences included), the
    `--pathPhone` of the supervised epochs and probes. Returns the `.item`
    path."""
    from cpc2_torch.data.audio_io import save_wav
    sr, sil = 16000, 0.12
    lines = ["#file onset offset #phone prev-phone next-phone speaker"]
    label_lines = []
    noise = np.random.RandomState(1)
    for f in range(n_files):
        rs = np.random.RandomState(100 + f)
        phones = [list(PHONES)[k] for k in rs.randint(0, 4, n_tokens)]
        durs = [(0.10 if p in ("aa", "iy") else 0.20)
                + 0.01 * rs.randint(0, 6 if p in ("aa", "iy") else 11)
                for p in phones]
        tokens = [("sil", sil)]
        for p, d in zip(phones, durs):
            tokens += [(p, d), ("sil", sil)]
        for s in range(n_speakers):
            spk = f"spk{s}"
            os.makedirs(os.path.join(root, spk), exist_ok=True)
            name = f"{spk}-{f:02d}"
            wav, t, ids = [], 0.0, []
            for tok, dur in tokens:
                n = int(round(dur * sr))
                ids.append(np.full(n, list(PHONES).index(tok)))
                tt = np.arange(n) / sr
                f1, f2 = (f * (1 + 0.1 * noise.randn()) for f in PHONES[tok])
                wav.append(0.4 * np.sin(2 * np.pi * f1 * tt)
                           + 0.3 * np.sin(2 * np.pi * f2 * tt)
                           + 0.15 * noise.randn(n)
                           + 0.05 * s * np.sin(2 * np.pi * 60 * tt))
                if tok != "sil":
                    lines.append(f"{name} {t:.4f} {t + dur:.4f} {tok} sil sil "
                                 f"{spk}")
                t += n / sr
            save_wav(os.path.join(root, spk, name + ".wav"),
                     np.concatenate(wav).astype(np.float32), sr)
            ids = np.concatenate(ids)
            label_lines.append(name + " " + " ".join(
                map(str, ids[:len(ids) // 160 * 160:160])))
    item = os.path.join(os.path.dirname(root), "phones.item")
    with open(item, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(phone_labels_path(root), "w") as fh:
        fh.write("\n".join(label_lines) + "\n")
    return item


def phone_labels_path(root: str) -> str:
    """The phone labels `write_phone_corpus(root)` writes."""
    return os.path.join(os.path.dirname(root), "phone_labels.txt")


def run_abx(dev, work: str, checkpoint: str, cpu_batched: bool = False
            ) -> dict:
    """`eval_ABX from_checkpoint` on the card at its defaults, then the
    scoring held against itself with the plain DTW on the same features,
    and two files' features card against CPU. With `cpu_batched` the CPU
    makes the features of the files of the first file's length as the card
    does, in one batch (`build_feature_files`): the MFCC front-end's top-dB
    clamp is against its batch's maximum, so a file's MFCCs depend on the
    files batched with it."""
    import random

    from cpc2_torch.eval import eval_ABX
    from cpc2_torch.eval.abx import abx_group_computation as abx_g
    from cpc2_torch.feature_loader import (FeatureModule, build_feature,
                                           build_feature_files, load_model)
    from cpc2_torch.ops import _build
    from cpc2_torch.ops.dtw import dtw_normalized, dtw_normalized_plain
    root = os.path.join(work, "phones")
    item = write_phone_corpus(root)
    _build.reset_launches()
    scores = eval_ABX.main(["from_checkpoint", checkpoint, item, root,
                            "--out", os.path.join(work, "abx")])
    launches = dict(_build.LAUNCHES)
    run = dict(eval_ABX.LAST_RUN)
    check_launched("ABX", launches, ABX_KERNELS)
    ran = [k for k in LSTM_GRID if launches[k]]
    if ran:
        raise AssertionError(f"the ABX path launched {ran}")
    for mode in ("within", "across"):
        if not 0.0 <= scores.get(mode, math.nan) <= 1.0:
            raise AssertionError(f"ABX {mode}: {scores.get(mode)}")

    # the same features, scored with the kernel and with the plain DTW
    paths = sorted(glob.glob(os.path.join(root, "*", "*.wav")))
    model = load_model([checkpoint])[0]
    card = build_feature_files(
        FeatureModule(model.to(dev), False, keep_hidden=True), paths)
    seqs = [(os.path.splitext(os.path.basename(p))[0], p) for p in paths]
    events = []

    def timed_dtw(dist, n1, n2):
        # CUDA events around each launch: the DTW kernel's share of scoring
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        out = dtw_normalized(dist, n1, n2)
        pair[1].record()
        events.append(pair)
        return out

    def score(dtw):
        # the scorer's DTW swapped for this call; the same subsampled
        # groups both times
        abx_g.dtw_normalized = dtw
        random.seed(0)
        try:
            return eval_ABX.ABX(card.__getitem__, item, seqs, "cosine",
                                100.0, ["within", "across"],
                                max_size_group=20, device=dev)
        finally:
            abx_g.dtw_normalized = dtw_normalized

    kernel_scores = score(timed_dtw)
    torch.cuda.synchronize()
    dtw_ms = sum(a.elapsed_time(b) for a, b in events)
    timed_scoring_s = eval_ABX.LAST_RUN["scoring_s"]
    plain_scores = score(dtw_normalized_plain)
    if kernel_scores != plain_scores:
        raise AssertionError(f"ABX with the DTW kernel {kernel_scores} vs "
                             f"the plain DTW {plain_scores}")

    cpu = FeatureModule(model.cpu(), False, keep_hidden=True)
    if cpu_batched:
        from cpc2_torch.data.audio_io import audio_info
        group = [p for p in paths
                 if audio_info(p)[0] == audio_info(paths[0])[0]]
        on_cpu = build_feature_files(cpu, group)
        got, want = ([torch.from_numpy(card[p]) for p in group],
                     [torch.from_numpy(on_cpu[p]) for p in group])
    else:
        got = [torch.from_numpy(card[p]) for p in paths[:2]]
        want = [torch.from_numpy(build_feature(cpu, p)) for p in paths[:2]]
    err = compare("features (card vs cpu)", got, want, rtol=1e-3)
    return {"scores": scores, "launches": launches, "features_s":
            run["features_s"], "scoring_s": run["scoring_s"],
            "flushes": run["flushes"], "dtw_pairs": run["dtw_pairs"],
            "kernel_vs_plain_scores": kernel_scores,
            "feature_max_abs_err": err,
            "files": len(paths), "dtw_calls": len(events),
            "dtw_device_ms": dtw_ms,
            "dtw_share_of_scoring": dtw_ms / 1e3 / timed_scoring_s}


# The supervised criteria at the recipe's shapes: 8 contexts and encodings
# of 128 frames, 256 wide, over the phone corpus's phones and 4 speakers.
SUP_B, SUP_T, SUP_H, SUP_SPEAKERS = 8, 128, 256, 4
SUP_PHONES = len(PHONES)
# CTC card against CPU: torch's CUDA `ctc_loss` sums each sample's
# alignment terms in log space in another order than its CPU loop, and its
# backward adds each frame's terms with atomics in the order they land; so
# the CTC head's loss and gradients are held to 1e-3 of each tensor's
# largest value, every other criterion to RTOL.
CTC_RTOL = 1e-3
# kernels no supervised epoch or probe may launch: the supervised path has
# no InfoNCE, no head FFN, no attention; the encoder is not opted in and
# every model here is 256 wide (the LSTM's resident route)
SUPERVISED_MUST_NOT = (("infonce_fwd", "infonce_bwd") + FFN_KERNELS
                       + FUSED_KERNELS + LSTM_GRID)


def phone_runs(rs, b: int, t: int, n_phones: int) -> np.ndarray:
    """(b, t) int64 phone labels in runs of 4-24 frames."""
    out = np.empty((b, t), np.int64)
    for i in range(b):
        runs, n = [], 0
        while n < t:
            runs.append(np.full(rs.randint(4, 25), rs.randint(n_phones)))
            n += len(runs[-1])
        out[i] = np.concatenate(runs)[:t]
    return out


def supervised_cases() -> dict:
    """name -> (a maker of the criterion at SUP_H, the kind of its label)."""
    from cpc2_torch.losses import (AdvSpeakerCriterion, CTCPhoneCriterion,
                                   PhoneCriterion, SpeakerCriterion)
    h = SUP_H
    return {
        "speaker": (lambda: SpeakerCriterion(h, SUP_SPEAKERS), "speaker"),
        "adv_speaker": (lambda: AdvSpeakerCriterion(h, h, SUP_SPEAKERS),
                        "speaker"),
        "adv_speaker_no_label": (
            lambda: AdvSpeakerCriterion(h, h, SUP_SPEAKERS), None),
        "phone": (lambda: PhoneCriterion(h, h, SUP_PHONES), "phone"),
        "phone_3_levels_on_encoder": (
            lambda: PhoneCriterion(h, h, SUP_PHONES, on_encoder=True,
                                   n_layers=3), "phone"),
        "ctc": (lambda: CTCPhoneCriterion(h, SUP_PHONES), "phone"),
    }


def check_supervised_criteria(dev) -> dict:
    """Each supervised criterion, forward and backward, on the card against
    the CPU at the recipe's shapes (SUP_B x SUP_T x SUP_H), same weights
    and inputs: loss, accuracy and the gradients of the context, the
    encodings and every weight (CTC at CTC_RTOL, the rest at RTOL). Returns
    each one's max abs error and its forward and backward ms on the card
    by events."""
    rs = np.random.RandomState(21)
    c = torch.from_numpy(rs.randn(SUP_B, SUP_T, SUP_H).astype(np.float32))
    e = torch.from_numpy(rs.randn(SUP_B, SUP_T, SUP_H).astype(np.float32))
    labels = {"speaker": torch.from_numpy(
        rs.randint(0, SUP_SPEAKERS, SUP_B).astype(np.int64)),
        "phone": torch.from_numpy(phone_runs(rs, SUP_B, SUP_T, SUP_PHONES)),
        None: None}
    out = {}
    for name, (make, kind) in supervised_cases().items():
        torch.manual_seed(0)
        cpu_mod = make()
        card_mod = make().to(dev)
        card_mod.load_state_dict(cpu_mod.state_dict())

        def run(mod, device):
            # fresh leaves on each device: `c` itself never takes a grad
            ct = c.detach().clone().to(device).requires_grad_(True)
            et = e.detach().clone().to(device).requires_grad_(True)
            lab = None if labels[kind] is None else labels[kind].to(device)
            loss, acc = mod(ct, et, lab)
            loss.sum().backward()
            grads = [torch.zeros_like(x) if x.grad is None else x.grad
                     for x in [ct, et] + list(mod.parameters())]
            for p in mod.parameters():
                p.grad = None
            return [loss.detach(), acc] + grads

        want = run(cpu_mod, torch.device("cpu"))
        got = [x.cpu() for x in run(card_mod, dev)]
        err = compare(f"{name} criterion (card vs cpu)", got, want,
                      rtol=CTC_RTOL if name == "ctc" else RTOL)
        out[name] = {"max_abs_err": err,
                     "ms": cuda_ms(lambda: run(card_mod, dev))}
    return out


def check_lstm_no_grad(dev) -> dict:
    """`fused_lstm` at the recipe's shapes (B 8, T 128, H 256) with and
    without gradients, as a frozen probe and a supervised step call it:
    without, it must launch `lstm_fwd` only, return outputs with no
    autograd history, and keep on the card no more than those outputs
    (the gates and cells it writes for a backward are freed with the
    call); with, those stay until the backward. Returns the bytes kept
    each way."""
    from cpc2_torch.ops import _build
    from cpc2_torch.ops.lstm import fused_lstm
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    b, t, h = 8, 128, 256

    def draw(*shape):
        return (0.1 * torch.randn(*shape, device=dev, generator=gen)
                ).requires_grad_(True)

    inputs = [draw(b, t, 4 * h), draw(b, h), draw(b, h), draw(4 * h, h),
              draw(4 * h)]
    with torch.no_grad():      # any first-call allocation out of the count
        fused_lstm(*inputs)
    kept = {}
    for grad in (False, True):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        _build.reset_launches()
        with torch.set_grad_enabled(grad):
            outs = fused_lstm(*inputs)
        torch.cuda.synchronize()
        kept[grad] = torch.cuda.memory_allocated(dev) - before
        launches = dict(_build.LAUNCHES)
        if launches["lstm_fwd"] != 1 or launches["lstm_bwd"]:
            raise AssertionError(f"fused_lstm (grad {grad}) launched "
                                 f"{launches}")
        if (outs[0].grad_fn is None) == grad:
            raise AssertionError(f"fused_lstm (grad {grad}): grad_fn "
                                 f"{outs[0].grad_fn}")
        if not grad and kept[grad] > nbytes(*outs) + 3 * 512:
            raise AssertionError(f"fused_lstm without gradients keeps "
                                 f"{kept[grad]} bytes, its outputs "
                                 f"{nbytes(*outs)}")
        del outs
    return {"bytes_kept_no_grad": kept[False], "bytes_kept_grad": kept[True]}


# The supervised steps held card against CPU, as `check_step` holds the
# CPC step under `fp32`.
SUPERVISED_STEPS = ("speaker", "phone", "ctc")


def supervised_argv(kind: str) -> list:
    return ["--supervised"] + {"speaker": [], "phone": ["--pathPhone", "p"],
                               "ctc": ["--pathPhone", "p", "--CTC"]}[kind]


def check_supervised_step(dev, kind: str) -> tuple:
    """One `--supervised` training step (speaker, phone or CTC) on the card
    against the same step on the CPU at width 64, same weights, batch and
    labels, under `fp32`: the loss and every gradient within 1e-3 of each
    tensor's largest value (`check_step`'s `fp32` tolerance, which holds
    CTC_RTOL too). It must launch the resident LSTM's kernels and none of
    SUPERVISED_MUST_NOT. Returns the max abs error and the launches."""
    from cpc2_torch.config import parse_args
    from cpc2_torch.feature_loader import build_model
    from cpc2_torch.ops import _build
    from cpc2_torch.train import get_criterion
    from cpc2_torch.training import Trainer, make_optimizer
    from cpc2_torch.training import precision as library_precision
    args = parse_args(["--pathDB", ".", "--file_extension", ".wav",
                       "--hiddenEncoder", "64", "--hiddenGar", "64",
                       "--sizeWindow", "3840", "--random_seed", "0"]
                      + supervised_argv(kind))
    rs = np.random.RandomState(1)
    batch = torch.from_numpy(rs.randn(4, 2, 1, 3840).astype(np.float32))
    label = torch.from_numpy(
        rs.randint(0, SUP_SPEAKERS, 4).astype(np.int64) if kind == "speaker"
        else phone_runs(rs, 4, 24, SUP_PHONES))
    torch.manual_seed(0)
    model_cpu = build_model(args)
    crit_cpu = get_criterion(args, SUP_SPEAKERS, SUP_PHONES)
    results = []
    with library_precision("fp32"):
        _build.reset_launches()
        for device in (torch.device("cpu"), dev):
            model = build_model(args).to(device)
            crit = get_criterion(args, SUP_SPEAKERS, SUP_PHONES).to(device)
            model.load_state_dict(model_cpu.state_dict())
            crit.load_state_dict(crit_cpu.state_dict())
            params = list(model.parameters()) + list(crit.parameters())
            trainer = Trainer(model, crit, make_optimizer(args, params))
            losses, _accs = trainer.train_step(batch.to(device),
                                               label=label.to(device))
            results.append([losses.cpu()] + [p.grad.cpu() for p in params])
        launches = dict(_build.LAUNCHES)
    err = compare(f"--supervised {kind} step (card vs cpu)", results[1],
                  results[0], rtol=1e-3)
    check_launched(f"--supervised {kind} step", launches, LSTM_RESIDENT)
    ran = [k for k in SUPERVISED_MUST_NOT if launches[k]]
    if ran:
        raise AssertionError(f"the --supervised {kind} step launched {ran}")
    return err, launches


def supervised_corpus(work: str, mode: str) -> tuple:
    """(the label flags, the corpus under `work`, its extension) of a
    supervised epoch or probe: the speakers of the FLAC training corpus, or
    the phone corpus (WAV) with its labels."""
    if mode == "speaker":
        return [], "train_db", ".flac"
    labels = phone_labels_path(os.path.join(work, "phones"))
    return (["--pathPhone", labels] + (["--CTC"] if mode == "ctc" else []),
            "phones", ".wav")


def run_supervised(dev, work: str, mode: str) -> dict:
    """One `--supervised` epoch at the CLI defaults (256-d, batch 8 x
    20,480): `speaker` on the FLAC training corpus, `phone` and `ctc` on
    the phone corpus with `--pathPhone`; the launch counts set to 0 just
    before and read just after. The resident LSTM's forward and backward
    must launch, none of SUPERVISED_MUST_NOT; the one-column logs finite,
    the accuracies in [0, 1], the checkpoint's `cpcCriterion` the head's
    weight and bias."""
    from cpc2_torch.io.checkpoint import load_torch_checkpoint
    from cpc2_torch.ops import _build
    from cpc2_torch.train import main
    ck = os.path.join(work, f"ck_supervised_{mode}")
    flags, db, ext = supervised_corpus(work, mode)
    if ext != ".flac":
        flags += ["--file_extension", ext]
    _build.reset_launches()
    record = main(train_argv(work, ck, "--supervised", *flags, db=db))
    launches = dict(_build.LAUNCHES)
    check_launched(f"--supervised {mode} training", launches, LSTM_RESIDENT)
    ran = [k for k in SUPERVISED_MUST_NOT if launches[k]]
    if ran:
        raise AssertionError(f"the --supervised {mode} epoch launched {ran}")
    logs = record["logs"]
    for key in ("locLoss_train", "locAcc_train", "locLoss_val",
                "locAcc_val"):
        values = np.asarray(logs[key], dtype=np.float64)
        if values.shape != (1, 1) or not np.isfinite(values).all():
            raise AssertionError(f"--supervised {mode} {key}: {values}")
        if key.startswith("locAcc") and not 0.0 <= values[0, 0] <= 1.0:
            raise AssertionError(f"--supervised {mode} {key}: {values}")
    head = ("linearSpeakerClassifier" if mode == "speaker"
            else "PhoneCriterionClassifier")
    saved = load_torch_checkpoint(os.path.join(ck, "checkpoint_0.pt"))
    if set(saved["cpcCriterion"]) != {f"{head}.weight", f"{head}.bias"}:
        raise AssertionError(f"--supervised {mode} checkpoint's head: "
                             f"{sorted(saved['cpcCriterion'])}")
    if len(record["step_ms"]) < 5:
        raise AssertionError(f"only {len(record['step_ms'])} steps ran")
    if set(record["param_devices"]) != {str(dev)}:
        raise AssertionError(f"parameters on {record['param_devices']}")
    return {"steps": len(record["step_ms"]),
            "median_step_ms": record["median_step_ms"],
            "audio_hours_per_hour": record["audio_hours_per_hour"],
            "loss_train": logs["locLoss_train"][0][0],
            "acc_train": logs["locAcc_train"][0][0],
            "loss_val": logs["locLoss_val"][0][0],
            "acc_val": logs["locAcc_val"][0][0],
            "launches": {k: n for k, n in launches.items() if n}}


# probe -> (the supervised mode whose corpus and labels it reads, whether
# the model trains too)
PROBES = {"speaker": ("speaker", False), "phone": ("phone", False),
          "phone_unfrozen": ("phone", True), "ctc": ("ctc", False)}


def run_probe(dev, work: str, checkpoint: str, probe: str) -> dict:
    """`linear_separability.main` on `checkpoint` for one epoch at its
    defaults (batch 8 x 20,480), every fourth file of the corpus in
    validation; the launch counts set to 0 just before and read just
    after. A frozen probe launches `lstm_fwd` and no `lstm_bwd`, an
    unfrozen one both; none of SUPERVISED_MUST_NOT; the accuracy in [0, 1],
    the logs and the checkpoint written."""
    from cpc2_torch.eval import linear_separability as ls
    from cpc2_torch.ops import _build
    mode, unfrozen = PROBES[probe]
    flags, db, ext = supervised_corpus(work, mode)
    root = os.path.join(work, db)
    names = sorted(os.path.splitext(os.path.basename(p))[0] for p in
                   glob.glob(os.path.join(root, "**", "*" + ext),
                             recursive=True))
    out = os.path.join(work, f"probe_{probe}")
    os.makedirs(out)
    lists = {}
    for part, chosen in (("train", [n for i, n in enumerate(names)
                                    if i % 4 != 3]), ("val", names[3::4])):
        lists[part] = os.path.join(out, f"{part}.txt")
        with open(lists[part], "w") as fh:
            fh.write("\n".join(chosen) + "\n")
    _build.reset_launches()
    acc = ls.main([root, lists["train"], lists["val"], checkpoint,
                   "--pathCheckpoint", os.path.join(out, "run"),
                   "--n_epoch", "1", "--file_extension", ext, *flags]
                  + (["--unfrozen"] if unfrozen else []))
    launches = dict(_build.LAUNCHES)
    check_launched(f"{probe} probe", launches, ("lstm_fwd",) + (
        ("lstm_bwd",) if unfrozen else ()))
    ran = [k for k in SUPERVISED_MUST_NOT + (() if unfrozen
                                             else ("lstm_bwd",))
           if launches[k]]
    if ran:
        raise AssertionError(f"the {probe} probe launched {ran}")
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"the {probe} probe's accuracy: {acc}")
    for name in ("checkpoint_logs.json", "checkpoint_0.pt"):
        if not os.path.exists(os.path.join(out, "run", name)):
            raise AssertionError(f"the {probe} probe wrote no {name}")
    return {"steps": len(ls.LAST_RUN["train_step_ms"]),
            "median_step_ms": ls.LAST_RUN["median_train_step_ms"],
            "best_acc": acc, "files": len(names),
            "launches": {k: n for k, n in launches.items() if n}}


# ---------------------------------------------------------------------------
# Phase 8: the discrete-unit path (clustering, quantization, unit ABX, the
# ZeroSpeech export and CPCModule)
# ---------------------------------------------------------------------------

# Kernels the unit path must not launch: it runs every model without
# gradients, the encoder in cuDNN's fp32 route and no InfoNCE; `CPCModule`
# alone runs the heads' FFNs, on their fp32 route.
UNIT_MUST_NOT = ("lstm_bwd", "infonce_fwd", "infonce_bwd", "encoder_fwd",
                 "encoder_bwd") + FFN_KERNELS
KMEANS_ITERS = 5
DPMEANS_ITERS = 2
# A frame whose two nearest centroids' squared distances differ by less
# than this share of the nearest one may take either id on the card and on
# the CPU (fp32 sums in another order). The card's and the CPU's features of
# one frame differ by their own fp32 rounding too, so a frame whose ids
# differ is a near tie where its gap is below this on either side's
# features (`unit_pass`).
UNIT_GAP = 1e-5
UNIT_RTOL = 1e-3


def seeded(main, argv):
    """`main(argv)` with `random` and numpy's global state seeded: the
    corpus's order and the uniform windows (and k-means' start rows) come
    from them, so two runs draw the same."""
    import random
    random.seed(0)
    np.random.seed(0)
    return main(argv)


def iteration_seconds(out: str) -> list:
    """The fit's seconds an iteration, from its `training_logs.txt`."""
    import re
    with open(os.path.join(out, "training_logs.txt")) as fh:
        return [float(m.group(1)) for m in re.finditer(
            r"ITER \d+ done in ([0-9.]+) seconds", fh.read())]


def centroids_of(path: str) -> torch.Tensor:
    return torch.load(path, map_location="cpu",
                      weights_only=False)["state_dict"]["Ck"]


@contextlib.contextmanager
def recorded_features(store: list):
    """While open, the feature maker of `clustering_script.main` appends a
    copy of each batch's features (on their own device) to `store`."""
    from cpc2_torch.clustering import clustering_script
    make = clustering_script._make_feature_fn

    def recording(args, device):
        maker = make(args, device)

        def record(data):
            out = maker(data)
            store.append(out.detach().clone())
            return out
        return record

    clustering_script._make_feature_fn = recording
    try:
        yield store
    finally:
        clustering_script._make_feature_fn = make


def unit_pass(batches: list, mu: torch.Tensor, lam, device,
              follow: list = None, follow_batches: list = None,
              gaps: list = None):
    """One pass of k-means (`lam` None) or DP-means (penalty `lam`) over
    recorded feature batches from the centroids `mu` (k, D), in the fit's
    own arithmetic (`clustering._sq_distances`, `_one_hot_sums`, the sums
    in the same order and the same division). Returns the next centroids
    (k', D) on the CPU, each batch's decisions (the argmin ids before a
    cluster opens, and the row that opens one or -1) and how many decisions
    differ from `follow`'s. With `follow`, another run's decisions on the
    same frames (made on `follow_batches`, that run's features of them),
    each decision of this pass must be that run's or a near tie (an id:
    `near_ties` on this pass's features or on the other run's; the row
    that opens a cluster: a farthest distance within UNIT_GAP of the other
    row's, or of `lam`), and the sums then take `follow`'s decisions: one
    run's arithmetic held to the other run's choices. Each differing id's
    gaps on both sides' features (`tie_gaps`) are appended to `gaps` as
    (batch, row, this side's, the other run's)."""
    from cpc2_torch.clustering.clustering import (_one_hot_sums, _rows,
                                                  _sq_distances)
    mu = mu.to(device, torch.float32)
    k, d = mu.shape
    sums = torch.zeros((k, d), device=device)
    counts = torch.zeros((k,), device=device,
                         dtype=torch.float32 if lam is None else torch.float64)
    decisions, differing = [], 0
    for b, batch in enumerate(batches):
        x = _rows(batch, d, device)
        dist2 = _sq_distances(x, mu)
        assign = dist2.argmin(dim=1)
        opened = -1
        if lam is not None:
            dist = dist2.gather(1, assign[:, None])[:, 0].sqrt()
            far, idx = torch.stack([dist.max().double(),
                                    dist.argmax().double()]).tolist()
            if far > lam:
                opened = int(idx)
        if follow is not None:
            want, want_opened = follow[b]
            want = want.to(device)
            differ = (assign != want).nonzero()[:, 0]
            if differ.numel():
                ck = mu.cpu().numpy()
                here = tie_gaps(x[differ].cpu().numpy(), ck)
                there = (tie_gaps(_rows(follow_batches[b], d, "cpu")[
                    differ.cpu()].numpy(), ck) if follow_batches is not None
                    else here)
                rows = differ.cpu().tolist()
                if gaps is not None:
                    gaps += [(b, r, float(g1), float(g2))
                             for r, g1, g2 in zip(rows, here, there)]
                bad = [(r, float(g1), float(g2))
                       for r, g1, g2 in zip(rows, here, there)
                       if min(g1, g2) >= UNIT_GAP]
                if bad:
                    raise AssertionError(
                        f"batch {b}: ids differ at rows that are no near "
                        f"ties (row, gap over the nearest on this side's "
                        f"features, on the other run's): {bad[:10]}")
                differing += int(differ.numel())
            if opened != want_opened:
                # both open a cluster, at two rows: their farthest
                # distances; one does and one does not: lambda
                ref = (dist[want_opened].item()
                       if min(opened, want_opened) >= 0 else lam)
                if abs(far - ref) > UNIT_GAP * far:
                    raise AssertionError(
                        f"batch {b}: row {opened} opens a cluster, the other "
                        f"run's {want_opened} (farthest {far}, lambda {lam})")
                differing += 1
            assign, opened = want.clone(), want_opened
        decisions.append((assign.clone(), opened))
        if opened >= 0:
            mu = torch.cat([mu, x[opened:opened + 1]], dim=0)
            sums = torch.cat([sums, sums.new_zeros((1, d))], dim=0)
            counts = torch.cat([counts, counts.new_zeros(1)], dim=0)
            assign[opened] = k
            k += 1
        s, c = _one_hot_sums(x, assign, k)
        sums += s
        counts += c.to(counts.dtype)
    if lam is None:
        nxt = sums / (counts[:, None] + 1e-8)
    else:
        nxt = (sums.double() / (counts + 1e-4)[:, None]).float()
    return nxt.cpu(), decisions, differing


def dp_start(batches: list) -> torch.Tensor:
    """DP-means' start without `--load`: the mean row of the first pass's
    features over 100, summed batch by batch as `fastDPMean` sums them."""
    acc = None
    for f in batches:
        f = f.to(torch.float32)
        acc = f if acc is None else acc + f
    return acc.reshape(-1, acc.shape[-1]).mean(dim=0)[None, :] / 100


def audit_fit(name: str, lam, start: dict, runs: dict) -> dict:
    """Hold a card fit to a CPU fit iteration by iteration. `runs[tag]` has
    the fit's recorded feature batches (`batches`, the start pass first for
    DP-means) and its centroids after each iteration (`steps`); `start[tag]`
    the centroids it began from. Each run's pass over its own batches from
    its own centroids must give its next centroids bit for bit (the record
    is the fit). From the card's centroids, the CPU's pass must make the
    card's decisions but at near ties, and with the card's decisions give
    the card's next centroids within 1e-4 of the largest (`compare`). Where
    the two fits made the same decisions at every iteration, their last
    centroids must agree within 1e-4; where a near tie parted them, their
    paths differ from there on, and the error is reported, not held."""
    iters = len(runs["card"]["steps"])
    if iters == 0 or len(runs["cpu"]["steps"]) != iters:
        raise AssertionError(f"{name}: iterations card {iters}, cpu "
                             f"{len(runs['cpu']['steps'])}")
    per_iter = {}
    decisions = {}
    for tag, run in runs.items():
        batches = run["batches"]
        if len(batches) % iters:
            raise AssertionError(f"{name} {tag}: {len(batches)} batches "
                                 f"for {iters} iterations")
        per_iter[tag] = len(batches) // iters
        dev = batches[0].device
        prev, decisions[tag] = start[tag], []
        for i in range(iters):
            nb = per_iter[tag]
            nxt, dec, _ = unit_pass(batches[i * nb:(i + 1) * nb], prev, lam,
                                    dev)
            if not torch.equal(nxt, run["steps"][i]):
                raise AssertionError(f"{name} {tag}: the recorded pass "
                                     f"{i + 1} is not the fit's")
            decisions[tag].append(dec)
            prev = run["steps"][i]
    if per_iter["card"] != per_iter["cpu"]:
        raise AssertionError(f"{name}: {per_iter} batches an iteration")
    nb = per_iter["cpu"]
    cpu_batches = runs["cpu"]["batches"]
    card_batches = runs["card"]["batches"]
    errs, ties, parted, gaps = [], [], None, []
    prev = start["card"]
    for i in range(iters):
        held, _, differing = unit_pass(
            cpu_batches[i * nb:(i + 1) * nb], prev, lam, torch.device("cpu"),
            follow=decisions["card"][i],
            follow_batches=card_batches[i * nb:(i + 1) * nb], gaps=gaps)
        want = runs["card"]["steps"][i]
        errs.append(compare(f"{name} iteration {i + 1} (cpu from the card's "
                            f"centroids, the card's decisions)", [held],
                            [want], rtol=1e-4))
        ties.append(differing)
        same = all(o_c == o_p and torch.equal(a_c.cpu(), a_p)
                   for (a_c, o_c), (a_p, o_p) in zip(decisions["card"][i],
                                                     decisions["cpu"][i]))
        if parted is None and not same:
            parted = i + 1
        prev = want
    last = {tag: run["steps"][-1] for tag, run in runs.items()}
    if last["card"].shape != last["cpu"].shape:
        end = None
    elif parted is None:
        end = compare(f"{name} centroids (card vs cpu)", [last["card"]],
                      [last["cpu"]], rtol=1e-4)
    else:
        end = (last["card"].double() - last["cpu"].double()).abs().max().item()
    return {"iteration_max_abs_err": errs, "near_tie_decisions": ties,
            "parted_at": parted, "max_abs_err_vs_cpu": end,
            "tie_gaps": gaps}


def audit_line(audit: dict) -> str:
    errs = ", ".join(f"{e:.2e}" for e in audit["iteration_max_abs_err"])
    end = audit["max_abs_err_vs_cpu"]
    if audit["parted_at"] is None:
        ends = (f"the same decisions at every iteration, last centroids "
                f"card vs cpu max abs err {end:.2e}")
    else:
        ends = (f"a near tie parted the two fits at iteration "
                f"{audit['parted_at']}, last centroids card vs cpu max abs "
                f"err {end:.2e} (not held)")
    gaps = ", ".join(f"({cpu:.2e}, {card:.2e})"
                     for _b, _r, cpu, card in audit["tie_gaps"][:12])
    return (f"each iteration, cpu from the card's centroids with its "
            f"decisions, max abs err [{errs}], decisions at near ties "
            f"{audit['near_tie_decisions']} (their two nearest centroids' "
            f"gap over the nearest on the cpu's features and on the card's: "
            f"{gaps or 'none'}); {ends}")


def fit_steps(run_dir: str, iters: int) -> list:
    """The centroids (k, D) after each of the fit's iterations (fewer than
    `iters` where it converged before)."""
    steps = []
    for i in range(1, iters + 1):
        path = os.path.join(run_dir, f"checkpoint_{i}.pt")
        if not os.path.exists(path):
            break
        steps.append(centroids_of(path)[0])
    return steps


def unit_kmeans(work: str, checkpoint: str) -> dict:
    """`clustering_script.main` at its defaults (-k 50, --batchSizeGPU 50,
    --sizeWindow 10240) on the FLAC corpus: 50 start rows drawn from the
    features (`-n 0`), then -n KMEANS_ITERS from them twice on the card
    (bit for bit; the first with the launch counts set to 0 just before
    and read just after, the second with its features recorded) and once
    on the CPU (recorded), held to the card by `audit_fit`."""
    from cpc2_torch.clustering import clustering_script
    from cpc2_torch.ops import _build
    db = os.path.join(work, "train_db")
    out = os.path.join(work, "units")
    seeded(clustering_script.main, [checkpoint, os.path.join(out, "start"),
                                    db, "-n", "0"])
    start = os.path.join(out, "start", "checkpoint_last.pt")
    runs = {}
    for tag, extra in (("card", []), ("card_again", []),
                       ("cpu", ["--device", "cpu"])):
        run_dir = os.path.join(out, f"kmeans_{tag}")
        batches = []
        record = (recorded_features(batches) if tag != "card"
                  else contextlib.nullcontext())
        _build.reset_launches()
        t = time.perf_counter()
        with record:
            seeded(clustering_script.main, [
                checkpoint, run_dir, db, "-n", str(KMEANS_ITERS), "--load",
                start] + extra)
        runs[tag] = {"s": time.perf_counter() - t,
                     "launches": dict(_build.LAUNCHES),
                     "iteration_s": iteration_seconds(run_dir),
                     "centroids": centroids_of(os.path.join(
                         run_dir, "checkpoint_last.pt")),
                     "batches": batches,
                     "steps": fit_steps(run_dir, KMEANS_ITERS)}
    launches = runs["card"]["launches"]
    check_launched("k-means", launches, ("lstm_fwd",))
    ran = [k for k in UNIT_MUST_NOT if launches[k]]
    if ran:
        raise AssertionError(f"k-means launched {ran}")
    if not torch.equal(runs["card"]["centroids"],
                       runs["card_again"]["centroids"]):
        raise AssertionError("k-means: two card runs differ")
    ck0 = centroids_of(start)[0]
    audit = audit_fit("k-means", None, {"card": ck0, "cpu": ck0},
                      {"card": runs["card_again"], "cpu": runs["cpu"]})
    return {"checkpoint": os.path.join(out, "kmeans_card",
                                       "checkpoint_last.pt"),
            "k": int(runs["card"]["centroids"].shape[1]),
            "audit": audit,
            "card_iteration_s": runs["card"]["iteration_s"],
            "card_again_iteration_s": runs["card_again"]["iteration_s"],
            "cpu_iteration_s": runs["cpu"]["iteration_s"],
            "card_s": runs["card"]["s"], "cpu_s": runs["cpu"]["s"],
            "launches": {k: n for k, n in launches.items() if n}}


def unit_dpmeans(work: str, checkpoint: str) -> dict:
    """`--getDistanceEstimation` on the card, which must end in a clean
    `sys.exit()`; then `--DPMean -n DPMEANS_ITERS` with lambda the
    distances' median, on the card and on the CPU, features recorded: the
    same number of clusters, the fits held to each other by `audit_fit`."""
    from cpc2_torch.clustering import clustering_script
    db = os.path.join(work, "train_db")
    est = os.path.join(work, "units", "estimate")
    try:
        seeded(clustering_script.main, [checkpoint, est, db,
                                        "--getDistanceEstimation"])
    except SystemExit as done:
        if done.code not in (None, 0):
            raise
    else:
        raise AssertionError("--getDistanceEstimation did not exit")
    with open(os.path.join(est, "quantiles.json")) as fh:
        deciles = {float(k): v for k, v in json.load(fh).items()}
    lam = deciles[min(deciles, key=lambda q: abs(q - 0.5))]
    runs, start = {}, {}
    for tag, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        run_dir = os.path.join(work, "units", f"dpmeans_{tag}")
        batches = []
        t = time.perf_counter()
        with recorded_features(batches):
            seeded(clustering_script.main, [
                checkpoint, run_dir, db, "--DPMean", "-l", repr(lam), "-n",
                str(DPMEANS_ITERS)] + extra)
        seconds = time.perf_counter() - t
        steps = fit_steps(run_dir, DPMEANS_ITERS)
        # the start pass, then one pass an iteration
        nb = len(batches) // (len(steps) + 1)
        start[tag] = dp_start(batches[:nb])
        runs[tag] = {"s": seconds, "batches": batches[nb:], "steps": steps}
    n = {tag: int(run["steps"][-1].shape[0]) for tag, run in runs.items()}
    if n["card"] != n["cpu"] or n["card"] < 2:
        raise AssertionError(f"DP-means clusters: card {n['card']}, cpu "
                             f"{n['cpu']}")
    audit = audit_fit("DP-means", lam, start, runs)
    return {"lambda": lam, "clusters": n["card"], "audit": audit,
            "card_s": runs["card"]["s"], "cpu_s": runs["cpu"]["s"]}


def tie_gaps(feats: np.ndarray, ck: np.ndarray) -> np.ndarray:
    """Per frame, its two nearest centroids' squared distances' difference
    (float64) over the nearest one."""
    x = feats.reshape(-1, ck.shape[-1]).astype(np.float64)
    c = ck.reshape(-1, ck.shape[-1]).astype(np.float64)
    d = (x * x).sum(1)[:, None] - 2 * x @ c.T + (c * c).sum(1)[None]
    d.sort(axis=1)
    return (d[:, 1] - d[:, 0]) / np.maximum(d[:, 0], 1e-12)


def near_ties(feats: np.ndarray, ck: np.ndarray) -> np.ndarray:
    """Per frame, whether its two nearest centroids' squared distances
    (float64) lie within UNIT_GAP of the nearest."""
    return tie_gaps(feats, ck) < UNIT_GAP


def read_quantized(path: str) -> dict:
    with open(path) as fh:
        return {name: list(map(int, ids.split(","))) for name, ids in (
            line.split("\t") for line in fh.read().splitlines())}


def unit_quantization(dev, work: str, checkpoint: str, clusters: str,
                      phones: str) -> dict:
    """`clustering_quantization.main` of the phone corpus with the card's
    k-means centroids, batched and `--nobatch`, on the card (launch counts
    read) and on the CPU: the same ids but at frames whose two nearest
    centroids are near ties (`near_ties`, from the card's features of the
    same path)."""
    from cpc2_torch.clustering import clustering_quantization as cq
    from cpc2_torch.feature_loader import (FeatureModule,
                                           build_feature_batch,
                                           build_feature_files, load_model)
    from cpc2_torch.ops import _build
    ck = centroids_of(clusters).numpy()
    paths = sorted(glob.glob(os.path.join(phones, "*", "*.wav")))
    model = load_model([checkpoint])[0].to(dev)
    result = {}
    for mode, flags in (("batched", []), ("nobatch", ["--nobatch"])):
        tables, seconds = {}, {}
        for tag, extra in (("card", []), ("cpu", ["--device", "cpu"])):
            out = os.path.join(work, "units", f"quantized_{mode}_{tag}")
            _build.reset_launches()
            t = time.perf_counter()
            cq.main([clusters, phones, out, "--file_extension", ".wav"]
                    + flags + extra)
            seconds[tag] = time.perf_counter() - t
            if tag == "card":
                launches = dict(_build.LAUNCHES)
            tables[tag] = read_quantized(os.path.join(
                out, "quantized_outputs.txt"))
        check_launched(f"quantization {mode}", launches, ("lstm_fwd",))
        ran = [k for k in UNIT_MUST_NOT if launches[k]]
        if ran:
            raise AssertionError(f"quantization {mode} launched {ran}")
        if mode == "nobatch":
            feats = build_feature_files(
                FeatureModule(model, False, keep_hidden=True), paths,
                strict=True, maxSizeSeq=10240)
        else:
            maker = FeatureModule(model, False)
            feats = {p: build_feature_batch(maker, p, strict=True,
                                            maxSizeSeq=10240, batch_size=8)
                     for p in paths}
        frames = differing = ties = 0
        for p in paths:
            name = os.path.splitext(os.path.basename(p))[0]
            card = np.asarray(tables["card"][name])
            cpu = np.asarray(tables["cpu"][name])
            tie = near_ties(feats[p], ck)
            if card.shape != cpu.shape or card.shape != tie.shape:
                raise AssertionError(f"quantization {mode} {name}: frames "
                                     f"{card.shape} {cpu.shape} {tie.shape}")
            frames += card.size
            ties += int(tie.sum())
            differ = card != cpu
            differing += int(differ.sum())
            if (differ & ~tie).any():
                raise AssertionError(
                    f"quantization {mode} {name}: ids differ card vs cpu at "
                    f"frames {np.flatnonzero(differ & ~tie)[:10]} that are "
                    f"no near ties")
        result[mode] = {"files": len(paths), "frames": frames,
                        "differing": differing, "near_ties": ties,
                        "card_s": seconds["card"], "cpu_s": seconds["cpu"],
                        "launches": {k: n for k, n in launches.items()
                                     if n},
                        "table": os.path.join(
                            work, "units", f"quantized_{mode}_card",
                            "quantized_outputs.txt")}
    return result


def unit_abx(work: str, clusters: str, table: str, phones: str,
             item: str) -> dict:
    """`eval_ABX_clustering.main` on the phone corpus with `--clustering`
    (the card's k-means checkpoint) and `--quantized` (the card's
    `--nobatch` table), on the card with the DTW kernel (launch counts
    read: the lane route's DTW, and for `--clustering` `lstm_fwd`) and
    again with the plain DTW: the same scores, in [0, 1]."""
    import random

    from cpc2_torch.eval import eval_ABX_clustering as abx_cl
    from cpc2_torch.eval.abx import abx_group_computation as abx_g
    from cpc2_torch.ops import _build
    from cpc2_torch.ops.dtw import dtw_normalized, dtw_normalized_plain
    base = ["--path_audio_data", phones, "--path_abx_item", item,
            "--file-extension", ".wav"]
    out = {}
    for source, flags, kernels in (
            ("clustering", ["--clustering", clusters],
             ("dtw", "dtw_lanes", "lstm_fwd")),
            ("quantized", ["--quantized", table], ("dtw", "dtw_lanes"))):
        scores = {}
        for dtw in ("kernel", "plain"):
            abx_g.dtw_normalized = (dtw_normalized if dtw == "kernel"
                                    else dtw_normalized_plain)
            _build.reset_launches()
            random.seed(1)
            t = time.perf_counter()
            try:
                scores[dtw] = abx_cl.main(flags + base)
            finally:
                abx_g.dtw_normalized = dtw_normalized
            if dtw == "kernel":
                seconds = time.perf_counter() - t
                launches = dict(_build.LAUNCHES)
        check_launched(f"unit ABX {source}", launches, kernels)
        ran = [k for k in UNIT_MUST_NOT if launches[k]]
        if ran:
            raise AssertionError(f"unit ABX {source} launched {ran}")
        if scores["kernel"] != scores["plain"]:
            raise AssertionError(f"unit ABX {source}: the DTW kernel "
                                 f"{scores['kernel']} vs the plain DTW "
                                 f"{scores['plain']}")
        for mode in ("within", "across"):
            if not 0.0 <= scores["kernel"].get(mode, math.nan) <= 1.0:
                raise AssertionError(f"unit ABX {source} {mode}: "
                                     f"{scores['kernel'].get(mode)}")
        out[source] = {"scores": scores["kernel"], "s": seconds,
                       "launches": {k: n for k, n in launches.items()
                                    if n}}
    return out


def unit_export(dev, work: str, checkpoint: str, clusters: str,
                phones: str) -> dict:
    """`build_zeroSpeech_features.main` of the phone corpus as npy with
    `--clusters` (the card's k-means centroids) and with `--dimReduction`
    (a PCA that the port's `dim_reduction.main` builds on the card), on
    the card and on the CPU (UNIT_RTOL); then `CPCModule` on the default
    checkpoint's model and criterion at 8 x 20,480 samples, card (launch
    counts read: the fp32 FFN's, not the bf16 one's) against CPU."""
    from cpc2_torch.eval import build_zeroSpeech_features as zs
    from cpc2_torch.feature_loader import (CPCModule, CriterionWrapper,
                                           load_model, load_state)
    from cpc2_torch.io.checkpoint import (get_checkpoint_data,
                                          load_torch_checkpoint)
    from cpc2_torch.ops import _build
    from cpc2_torch.research import dim_reduction
    from cpc2_torch.train import get_criterion
    pca = os.path.join(work, "units", "pca.pt")
    t = time.perf_counter()
    seeded(dim_reduction.main, [checkpoint, pca, "--pathDB", phones,
                                "--extension", ".wav", "--recursionLevel",
                                "1", "--mode", "PCA"])
    result = {"pca_s": time.perf_counter() - t}
    for head, flags in (("clusters", ["--clusters", clusters]),
                        ("dimReduction", ["--dimReduction", pca])):
        outs, seconds = {}, {}
        for tag, extra in (("card", []), ("cpu", ["--device", "cpu"])):
            out = os.path.join(work, "units", f"zs_{head}_{tag}")
            t = time.perf_counter()
            zs.main([phones, out, checkpoint, "--format", "npy"] + flags
                    + extra)
            seconds[tag] = time.perf_counter() - t
            outs[tag] = {os.path.basename(p): np.load(p) for p in
                         sorted(glob.glob(os.path.join(out, "*.npy")))}
        if sorted(outs["card"]) != sorted(outs["cpu"]) or not outs["card"]:
            raise AssertionError(f"export {head}: files differ")
        err = compare(f"export {head} (card vs cpu)",
                      [torch.from_numpy(outs["card"][k])
                       for k in sorted(outs["card"])],
                      [torch.from_numpy(outs["cpu"][k])
                       for k in sorted(outs["cpu"])], rtol=UNIT_RTOL)
        result[head] = {"files": len(outs["card"]), "max_abs_err_vs_cpu": err,
                        "dims": int(next(iter(outs["card"].values()))
                                    .shape[1]),
                        "card_s": seconds["card"], "cpu_s": seconds["cpu"]}

    args = get_checkpoint_data(os.path.dirname(checkpoint))[2]

    def cpc_module(device):
        crit = get_criterion(args)
        load_state(crit, load_torch_checkpoint(checkpoint)["cpcCriterion"],
                   "cpcCriterion")
        return CPCModule(load_model([checkpoint])[0].to(device),
                         CriterionWrapper(crit.to(device)))
    x = (0.1 * np.random.RandomState(4).randn(8, 20480)).astype(np.float32)
    card_module = cpc_module(dev)
    card_module((x, None))
    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    scores = card_module((x, None))
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t) * 1e3
    launches = dict(_build.LAUNCHES)
    check_launched("CPCModule", launches, ("ffn_fwd_fp32", "lstm_fwd"))
    ran = [k for k in ("ffn_fwd", "ffn_bwd", "ffn_bwd_fp32", "lstm_bwd")
           if launches[k]]
    if ran:
        raise AssertionError(f"CPCModule launched {ran}")
    want = cpc_module("cpu")((x, None))
    if scores.shape != (8, 20480 // 160 - args.nPredicts):
        raise AssertionError(f"CPCModule: shape {tuple(scores.shape)}")
    result["cpc_module"] = {
        "max_abs_err_vs_cpu": compare("CPCModule (card vs cpu)",
                                      [scores.cpu()], [want],
                                      rtol=UNIT_RTOL),
        "card_ms": card_ms,
        "launches": {k: n for k, n in launches.items() if n}}
    return result


def log_units(units: dict, card: str) -> None:
    k, d, q, a, e = (units[key] for key in ("kmeans", "dpmeans",
                                            "quantization", "abx", "export"))
    log(f"[units k-means] {card}: -k {k['k']} --batchSizeGPU 50 "
        f"--sizeWindow 10240 -n {KMEANS_ITERS} on train_db, s an "
        f"iteration: card {k['card_iteration_s']}, again "
        f"{k['card_again_iteration_s']}, cpu {k['cpu_iteration_s']}; "
        f"the two card runs bit for bit; {audit_line(k['audit'])}; "
        f"launches {k['launches']}")
    log(f"[units dp-means] lambda {d['lambda']:.4f} (the distances' "
        f"median), -n {DPMEANS_ITERS}: {d['clusters']} clusters on the card "
        f"and the cpu; {audit_line(d['audit'])}; card {d['card_s']:.1f} s, "
        f"cpu {d['cpu_s']:.1f} s")
    log("[units quantization] the phone corpus, card vs cpu: " + "; ".join(
        f"{mode} {r['files']} files, {r['frames']} frames, "
        f"{r['differing']} ids differ, {r['near_ties']} near ties (gap "
        f"under {UNIT_GAP} of the nearest), card {r['card_s']:.2f} s, cpu "
        f"{r['cpu_s']:.2f} s, launches {r['launches']}"
        for mode, r in q.items()))
    log("[units abx] the phone corpus, the same scores with the DTW kernel "
        "and the plain DTW: " + "; ".join(
            f"{source} {r['scores']} in {r['s']:.2f} s, launches "
            f"{r['launches']}" for source, r in a.items()))
    log(f"[units export] npy of the phone corpus, card vs cpu: " + "; ".join(
        f"{head} {e[head]['dims']} dims, max abs err "
        f"{e[head]['max_abs_err_vs_cpu']:.2e}, card {e[head]['card_s']:.2f} "
        f"s, cpu {e[head]['cpu_s']:.2f} s" for head in ("clusters",
                                                        "dimReduction"))
        + f" (PCA built in {e['pca_s']:.2f} s); CPCModule at 8 x 20,480: "
        f"max abs err {e['cpc_module']['max_abs_err_vs_cpu']:.2e}, "
        f"{e['cpc_module']['card_ms']:.3f} ms (host clock), launches "
        f"{e['cpc_module']['launches']}")


def run_units(dev, work: str, checkpoint: str, phones: str,
              item: str) -> dict:
    """Phase 8 on the default epoch's checkpoint: k-means, DP-means, the
    quantization, unit ABX and the export (`unit_*`)."""
    units = {"kmeans": unit_kmeans(work, checkpoint)}
    clusters = units["kmeans"]["checkpoint"]
    units["dpmeans"] = unit_dpmeans(work, checkpoint)
    units["quantization"] = unit_quantization(dev, work, checkpoint,
                                              clusters, phones)
    units["abx"] = unit_abx(work, clusters,
                            units["quantization"]["nobatch"]["table"],
                            phones, item)
    units["export"] = unit_export(dev, work, checkpoint, clusters, phones)
    return units


def unit_launches(units: dict) -> dict:
    """This path's launches of `lstm_fwd`, `dtw` and `ffn_fwd_fp32` for the
    kernel table: per k-means iteration, per quantized corpus, per unit-ABX
    pass and per `CPCModule` call."""
    k = units["kmeans"]["launches"]
    q = units["quantization"]
    a = units["abx"]
    c = units["export"]["cpc_module"]["launches"]
    return {
        "lstm_fwd": {"kmeans_per_iteration": k.get("lstm_fwd", 0)
                     / KMEANS_ITERS,
                     "quantization_batched": q["batched"]["launches"].get(
                         "lstm_fwd", 0),
                     "quantization_nobatch": q["nobatch"]["launches"].get(
                         "lstm_fwd", 0),
                     "unit_abx_clustering": a["clustering"]["launches"].get(
                         "lstm_fwd", 0),
                     "cpc_module": c.get("lstm_fwd", 0)},
        "dtw": {"unit_abx_clustering": a["clustering"]["launches"].get(
                    "dtw", 0),
                "unit_abx_quantized": a["quantized"]["launches"].get(
                    "dtw", 0)},
        "ffn_fwd_fp32": {"cpc_module": c.get("ffn_fwd_fp32", 0)}}


# ---------------------------------------------------------------------------
# Phase 9: Common Voices CTC phone recognition and PER, the hub entry and
# the host DTW
# ---------------------------------------------------------------------------

# The synthetic Common Voice-like corpus: transcripts of CV_RATE phones a
# second from CV_PHONES phones, each phone a segment of two tones of its
# own; 40 training utterances of 2-10 s (the first 10 s, 1,000 frames) and
# 4 validation ones of 2-6 s.
CV_PHONES, CV_RATE = 40, 12
CV_TRAIN, CV_VAL = 40, 4
# [cv per]: the posteriors card against CPU, and a differing PER counts as
# a near tie where one side's best sequence scores within CV_NEAR_TIE
# (relative) of the other side's best among the other side's final beams
CV_POSTERIOR_ATOL = 1e-4
CV_NEAR_TIE = 1e-3
# [cv step]: each parameter after the step, card against CPU, in the
# 2-norm of the difference over the CPU's (`check_step`'s fp32 tolerance)
CV_PARAM_NORM_TOL = 1e-3
# lstm_fwd, lstm_bwd a training step (the CPC model's forward, the head's
# forward and backward; unfrozen the model's backward too) and a
# validation step; nothing else of ours runs on this path (no InfoNCE, FFN,
# attention or DTW; the encoder is cuDNN's in full fp32; 256 wide)
CV_STEP_LAUNCHES = {"frozen_lstm": ({"lstm_fwd": 2, "lstm_bwd": 1},
                                    {"lstm_fwd": 2}),
                    "unfrozen_lstm": ({"lstm_fwd": 2, "lstm_bwd": 2},
                                      {"lstm_fwd": 2})}
CV_RUNS = {"frozen_lstm": ["--freeze", "--LSTM", "--seqNorm"],
           "unfrozen_lstm": ["--LSTM"]}


def cv_utterance(rs, seconds: float) -> tuple:
    """(16 kHz samples, phone labels) of one utterance of `seconds`."""
    n = int(round(seconds * 16000))
    phones = rs.randint(0, CV_PHONES, max(1, int(round(CV_RATE * seconds))))
    bounds = np.linspace(0, n, len(phones) + 1).astype(int)
    t = np.arange(n) / 16000
    x = 0.03 * rs.randn(n)
    for k, p in enumerate(phones):
        part = slice(bounds[k], bounds[k + 1])
        x[part] += (0.4 * np.sin(2 * np.pi * (200 + 20 * p) * t[part])
                    + 0.3 * np.sin(2 * np.pi * (900 + 45 * p) * t[part]))
    return x.astype(np.float32), phones


def write_cv_corpus(root: str, seed: int = 10) -> dict:
    """CV_TRAIN + CV_VAL WAV utterances in 4 speaker folders, the
    transcripts (`name p1 p2 ...`) and the train and validation lists."""
    from cpc2_torch.data.audio_io import save_wav
    rs = np.random.RandomState(seed)
    seconds = ([10.0] + list(rs.uniform(2, 10, CV_TRAIN - 1))
               + list(rs.uniform(2, 6, CV_VAL)))
    names, lines = [], []
    for i, s in enumerate(seconds):
        x, phones = cv_utterance(rs, s)
        spk = f"spk{i % 4}"
        os.makedirs(os.path.join(root, spk), exist_ok=True)
        name = f"cv-{i:03d}"
        save_wav(os.path.join(root, spk, name + ".wav"), x, 16000)
        names.append(name)
        lines.append(name + " " + " ".join(map(str, phones)))
    out = {"root": root, "seconds": sum(seconds),
           "longest_frames": int(max(seconds) * 16000) // 160}
    for key, text in (("phones", lines), ("train", names[:CV_TRAIN]),
                      ("val", names[CV_TRAIN:])):
        out[key] = os.path.join(os.path.dirname(root), f"cv_{key}.txt")
        with open(out[key], "w") as fh:
            fh.write("\n".join(text) + "\n")
    return out


def check_cv_lstm(dev) -> dict:
    """`fused_lstm`'s resident route at (8, 1,000, 256), a batch of 10 s
    utterances, forward and every gradient against `lstm_plain` (RTOL, as
    `check_lstm`), the backward bit-identical across two calls; inputs
    from a generator of this check's own."""
    from cpc2_torch.ops import _build
    from cpc2_torch.ops.lstm import _LSTMResident, lstm_plain, lstm_plan
    from cpc2_torch.time_kernels import lstm_inputs
    b, t, h = 8, 1000, 256
    plan = lstm_plan(b, h, _build.sm_count(dev))
    if plan.route != "resident":
        raise AssertionError(f"lstm_plan({b}, {h}) = {plan}")
    own = torch.Generator(device=dev)
    own.manual_seed(9)
    inputs, cot = lstm_inputs(dev, own, b, t, h)

    def fn(*a):
        return _LSTMResident.apply(*a, plan.cluster, plan.bc)
    out_k, grad_k, bwd_k = grads_of(fn, inputs, cot)
    out_p, grad_p, _bwd = grads_of(lstm_plain, inputs, cot)
    err_f = compare("cv lstm (8, 1000, 256) forward", out_k, out_p)
    err_b = compare("cv lstm (8, 1000, 256) backward", grad_k, grad_p)
    if not all(torch.equal(a, g) for a, g in zip(bwd_k(), grad_k)):
        raise AssertionError("cv lstm (8, 1000, 256) backward: two calls "
                             "differ")
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: fn(*inputs), iters=5, warmup=1)
    return {"forward_max_abs_err": err_f, "backward_max_abs_err": err_b,
            "plan": list(plan[:3]), "fwd_ms": fwd_ms,
            "bwd_ms": cuda_ms(bwd_k, iters=5, warmup=1)}


def cv_step_batch(seed: int = 11) -> tuple:
    """A batch of 2 utterances of 2 and 3 s: (seq (2, 1, S), size_seq,
    phone, size_phone), as `SingleSequenceDataset.batches` gives it."""
    rs = np.random.RandomState(seed)
    utts = [cv_utterance(rs, s) for s in (2.0, 3.0)]
    seq = np.zeros((2, 1, max(len(x) for x, _ in utts)), np.float32)
    phone = np.zeros((2, max(len(p) for _, p in utts)), np.int64)
    for i, (x, p) in enumerate(utts):
        seq[i, 0, :len(x)] = x
        phone[i, :len(p)] = p
    return (seq, np.asarray([len(x) for x, _ in utts], np.int32), phone,
            np.asarray([len(p) for _, p in utts], np.int32))


class EncoderReluSpy:
    """Around a `CPCEncoder` on its torch route inside a `with` block: keeps
    each layer's normalized output, the input of its ReLU, on the CPU; with
    `masks` (one 0/1 tensor a layer), runs the stack with those ReLU
    decisions in place of its own."""

    def __init__(self, encoder, masks=None):
        self.encoder, self.masks, self.pre, self.hooks = encoder, masks, [], []

    def __enter__(self):
        from cpc2_torch.models.encoder import CONV_STACK
        for i in range(len(CONV_STACK)):
            norm = getattr(self.encoder, f"batchNorm{i}")
            self.hooks.append(norm.register_forward_hook(
                lambda _m, _x, out: self.pre.append(out.detach().cpu())))
        if self.masks is not None:
            self.encoder.forward = self.masked
        return self

    def __exit__(self, *exc):
        for hook in self.hooks:
            hook.remove()
        self.encoder.__dict__.pop("forward", None)

    def masked(self, x):
        from cpc2_torch.models.encoder import conv_windows
        if x.dim() == 2:
            x = x[:, None, :]
        for i, mask in enumerate(self.masks):
            conv = getattr(self.encoder, f"conv{i}")
            x = conv_windows(x, conv) if i == 0 else conv(x)
            x = getattr(self.encoder, f"batchNorm{i}")(x) * mask
        return x.transpose(1, 2)


def encoder_flips(card: list, cpu: list, what: str) -> list:
    """By encoder layer, the card's ReLU inputs (`card`) against the CPU's
    fp32 ones (`cpu`): each layer within RTOL of its largest value, so a
    decision can differ only where both sides lie that close to 0; and the
    decisions that differ, with the largest |input| among them on each
    side over the layer's largest (the gaps to 0 that one rounding
    crossed)."""
    if len(card) != len(cpu) or not card:
        raise AssertionError(f"{what}: {len(card)} encoder layers on the "
                             f"card, {len(cpu)} on the cpu (torch route)")
    out = []
    for i, (k, c) in enumerate(zip(card, cpu)):
        scale = c.double().abs().max().item()
        spread = (k.double() - c.double()).abs().max().item()
        if spread > ATOL + RTOL * scale:
            raise AssertionError(f"{what} encoder layer {i} ReLU input: max "
                                 f"abs err {spread:.3e} vs max |cpu| "
                                 f"{scale:.3e}")
        flip = (k > 0) != (c > 0)
        out.append({"flips": int(flip.sum()), "spread": spread / scale,
                    "gap_card": (k[flip].abs().max().item() / scale
                                 if flip.any() else 0.0),
                    "gap_cpu": (c[flip].abs().max().item() / scale
                                if flip.any() else 0.0)})
    return out


def cv_matched_reference(base_model, base_crit, batch, masks) -> list:
    """The unfrozen `CVSteps` step's loss and gradients in float64 on the
    CPU with the ReLU decisions `masks` in the encoder (`EncoderReluSpy`):
    the model and criterion in train mode, the gradients from zero."""
    model = copy.deepcopy(base_model).double().train()
    crit = copy.deepcopy(base_crit).double().train()
    seq = torch.from_numpy(np.asarray(batch[0])[:, 0]).double()
    size_seq, phone, size_phone = (torch.as_tensor(np.asarray(a),
                                                   dtype=torch.long)
                                   for a in batch[1:])
    with EncoderReluSpy(model.gEncoder, [m.double() for m in masks]):
        c_feature, _encoded, _hidden = model(seq)
    loss = crit(c_feature, size_seq, phone, size_phone).mean()
    loss.backward()
    return [loss.detach().reshape(1)] + [
        p.grad for p in list(model.parameters()) + list(crit.parameters())]


def check_cv_step(dev, checkpoint: str, mode: str) -> dict:
    """`cv_step` on the checkpoint's model and `cv_step_batch`."""
    from cpc2_torch.feature_loader import load_model
    base_model, hidden_gar, _ = load_model([checkpoint])
    return cv_step(dev, base_model, hidden_gar, mode, cv_step_batch())


def cv_step(dev, base_model, hidden_gar: int, mode: str, batch) -> dict:
    """One `CVSteps` training step (`mode`: frozen with --LSTM --seqNorm,
    or unfrozen with the default head) at full width on `batch`, on the
    card and on the CPU from the same weights, and whether a second card
    step from the same weights is bit for bit (a report: torch lists its
    CUDA `ctc_loss` backward as nondeterministic). Frozen, the loss and
    every gradient within CTC_RTOL of each tensor's largest value, card
    against CPU. Unfrozen, the encoder's ReLU inputs card against CPU
    (`encoder_flips`), then the loss and every gradient within CTC_RTOL
    against a float64 CPU step that takes the card's ReLU decisions
    (`cv_matched_reference`): a decision that one fp32 rounding flips moves
    the gradient of its own layer's convolution by tenths of a percent of
    its largest value.
    Either way every parameter after the step within CV_PARAM_NORM_TOL in
    the 2-norm, card against CPU."""
    from cpc2_torch.eval import common_voices_eval as cve
    flags = ["--freeze", "--LSTM", "--seqNorm"] if mode == "frozen" else []
    args = cve.parse_args(["train", "db", "phones.txt", "model.pt"] + flags)
    torch.manual_seed(0)
    base_crit = cve.CTCPhoneCriterionCV(
        hidden_gar, CV_PHONES, use_lstm=args.LSTM, seq_norm=args.seqNorm,
        reduction=args.loss_reduction)
    batch = (batch[0], batch[1] // 160, *batch[2:])
    runs, spies = [], []
    for device in (torch.device("cpu"), dev, dev):
        model = copy.deepcopy(base_model).to(device)
        crit = copy.deepcopy(base_crit).to(device)
        steps = cve.CVSteps(model, crit, cve.make_optimizer(model, crit,
                                                            args),
                            args.freeze)
        named = (list(model.named_parameters(prefix="model"))
                 + list(crit.named_parameters(prefix="criterion")))
        spies.append(EncoderReluSpy(model.gEncoder))
        with spies[-1] if mode == "unfrozen" else contextlib.nullcontext():
            loss = steps.train_batch(*batch)
        runs.append((loss.reshape(1).cpu(),
                     [p.grad.detach().cpu() for _n, p in named],
                     [p.detach().cpu() for _n, p in named]))
    (loss_c, grad_c, par_c), (loss_k, grad_k, par_k) = runs[:2]
    what = f"cv step {mode} (card vs cpu)"
    out = {}
    if mode == "frozen":
        loss_err = compare(what + " loss", [loss_k], [loss_c],
                           rtol=CTC_RTOL)
        grad_err = compare(what + " gradients", grad_k, grad_c,
                           rtol=CTC_RTOL)
    else:
        out["flips"] = encoder_flips(spies[1].pre, spies[0].pre, what)
        out["past_fp32"] = {}
        for (name, _p), k, c in zip(named, grad_k, grad_c):
            err = (k.double() - c.double()).abs().max().item()
            scale = c.double().abs().max().item()
            if err > ATOL + CTC_RTOL * scale:
                out["past_fp32"][name] = err / scale
        ref = cv_matched_reference(base_model, base_crit, batch,
                                   [p > 0 for p in spies[1].pre])
        what = f"cv step {mode} (card vs float64 with the card's decisions)"
        loss_err = compare(what + " loss", [loss_k], ref[:1], rtol=CTC_RTOL)
        grad_err = compare(what + " gradients", grad_k, ref[1:],
                           rtol=CTC_RTOL)
    rels = {name: norm_rel(k, c) for (name, _p), k, c in
            zip(named, par_k, par_c)}
    worst = max(rels, key=rels.get)
    if rels[worst] > CV_PARAM_NORM_TOL:
        raise AssertionError(f"{what} parameter {worst} after the step: "
                             f"{rels[worst]:.3e} (2-norm, relative)")
    again = runs[2]
    differing = [name for (name, _p), a, b in zip(named, again[2], par_k)
                 if not torch.equal(a, b)]
    out.update({"loss": loss_c.item(), "loss_err": loss_err,
                "grad_max_abs_err": grad_err, "worst_param": worst,
                "worst_param_rel": rels[worst],
                "card_steps_bit_for_bit": (torch.equal(again[0], loss_k)
                                           and not differing),
                "card_steps_differing": differing[:5]})
    return out


def run_cv_train(cv: dict, checkpoint: str, work: str, mode: str) -> dict:
    """`common_voices_eval.main train` on the card for one epoch with the
    flags of CV_RUNS[mode] (batch 8, the default), the launch counts read
    around each step: every training and validation step must launch
    exactly CV_STEP_LAUNCHES[mode]."""
    from cpc2_torch.eval import common_voices_eval as cve
    out = os.path.join(work, f"cv_{mode}")
    best = cve.main(["train", cv["root"], cv["phones"], checkpoint,
                     "--file_extension", ".wav", "--pathTrain", cv["train"],
                     "--pathVal", cv["val"], "--nEpochs", "1", "-o", out,
                     *CV_RUNS[mode]])
    run = copy.deepcopy(cve.LAST_RUN)
    want_train, want_val = CV_STEP_LAUNCHES[mode]
    for part, want in (("train", want_train), ("val", want_val)):
        steps = run[f"{part}_launches"][0]
        bad = [(i, got) for i, got in enumerate(steps) if got != want]
        if not steps or bad:
            raise AssertionError(f"cv {mode} {part} steps launched {bad} "
                                 f"(each must launch {want})")
    if not math.isfinite(best) or not os.path.exists(
            os.path.join(out, "checkpoint.pt")):
        raise AssertionError(f"cv {mode}: best loss {best}, no checkpoint")
    return {"out": out, "epoch_s": run["epoch_s"][0],
            "loss_train": run["loss_train"][0], "loss_val": best,
            "train_steps": len(run["train_launches"][0]),
            "val_steps": len(run["val_launches"][0]),
            "launches_per_train_step": want_train,
            "launches_per_val_step": want_val,
            "launches_epoch": {k: sum(s.get(k, 0) for p in ("train", "val")
                                      for s in run[f"{p}_launches"][0])
                               for k in ("lstm_fwd", "lstm_bwd")}}


def cv_near_tie(a: np.ndarray, b: np.ndarray, blank: int) -> bool:
    """Whether the best sequence of one side's beam search scores within
    CV_NEAR_TIE of the best among the other side's final beams."""
    from cpc2_torch.losses.seq_alignment import beam_search
    for p, q in ((a, b), (b, a)):
        best = beam_search(p, 20, blank)[0][1]
        beams = beam_search(q, 20, blank)
        if any(seq == best and score >= (1 - CV_NEAR_TIE) * beams[0][0]
               for score, seq in beams):
            return True
    return False


def run_cv_per(out: str) -> dict:
    """`common_voices_eval.main per` on `out`'s checkpoint on the card
    (the CPC model's forward and the head's LSTM: 2 `lstm_fwd` a batch)
    and on the CPU: the posteriors the beam search read within
    CV_POSTERIOR_ATOL, each utterance's PER equal but at counted near
    ties."""
    from cpc2_torch.eval import common_voices_eval as cve
    from cpc2_torch.ops import _build
    _build.reset_launches()
    per_card = cve.main(["per", out])
    card = copy.deepcopy(cve.LAST_RUN)
    launches = dict(_build.LAUNCHES)
    n_batches = -(-len(card["pers"]) // 8)
    want = {"lstm_fwd": 2 * n_batches}
    if card["launches"] != want or {k: n for k, n in launches.items()
                                    if n} != want:
        raise AssertionError(f"cv per launched {card['launches']}, want "
                             f"{want}")
    per_cpu = cve.main(["per", out, "--device", "cpu"])
    cpu = copy.deepcopy(cve.LAST_RUN)
    err = max(float(np.abs(k - c).max()) for k, c in
              zip(card["posteriors"], cpu["posteriors"]))
    if err > CV_POSTERIOR_ATOL:
        raise AssertionError(f"cv per posteriors card vs cpu: max abs err "
                             f"{err:.3e}")
    ties = []
    for i, (pk, pc, k, c) in enumerate(zip(card["pers"], cpu["pers"],
                                           card["posteriors"],
                                           cpu["posteriors"])):
        if pk != pc:
            if not cv_near_tie(k, c, k.shape[1] - 1):
                raise AssertionError(f"cv per utterance {i}: PER {pk} on "
                                     f"the card, {pc} on the cpu, and no "
                                     f"near tie")
            ties.append((i, pk, pc))
    return {"per_card": per_card, "per_cpu": per_cpu,
            "pers": list(map(float, card["pers"])),
            "posterior_max_abs_err": err, "near_ties": ties,
            "per_s_card": card["per_s"], "per_s_cpu": cpu["per_s"],
            "launches": card["launches"], "utterances": len(card["pers"])}


def check_hub(dev, work: str, checkpoint: str) -> dict:
    """`hub.CPC_audio` on the card: a payload in the published layout
    (`{'config', 'weights'}`) written from `checkpoint` gives features bit
    for bit those of `feature_loader.load_model` on the same batch; at its
    defaults it builds the 256-d model on the card, whose forward launches
    `lstm_fwd`."""
    from cpc2_torch.feature_loader import load_model
    from cpc2_torch.hub import CPC_audio
    from cpc2_torch.io.checkpoint import (get_checkpoint_data,
                                          load_torch_checkpoint)
    from cpc2_torch.ops import _build
    from cpc2_torch.training import full_fp32
    *_, args = get_checkpoint_data(os.path.dirname(checkpoint))
    path = os.path.join(work, "hub_payload.pt")
    torch.save({"config": vars(args),
                "weights": load_torch_checkpoint(checkpoint)["gEncoder"]},
               path)
    hub_model = CPC_audio(pretrained_path=path)
    ref = load_model([checkpoint])[0].to(dev)
    x = torch.from_numpy(np.random.RandomState(12).randn(4, 32000).astype(
        np.float32)).to(dev)
    with torch.no_grad(), full_fp32():
        c_h, e_h, _h = hub_model(x)
        c_r, e_r, _r = ref(x)
    if not (torch.equal(c_h, c_r) and torch.equal(e_h, e_r)):
        raise AssertionError("hub payload features differ from load_model's")
    fresh = CPC_audio()
    devices = {str(p.device) for p in fresh.parameters()}
    if devices != {str(dev)} or fresh.dim_context != 256:
        raise AssertionError(f"CPC_audio(): {fresh.dim_context} wide on "
                             f"{devices}")
    _build.reset_launches()
    with torch.no_grad():
        c, _e, _h = fresh(x)
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    if launches.get("lstm_fwd", 0) < 1:
        raise AssertionError(f"CPC_audio()'s forward launched {launches}")
    return {"frames": int(c_h.shape[1]), "dims": int(c_h.shape[2]),
            "fresh_context": list(c.shape), "launches": launches}


def check_dtw_host(dev) -> dict:
    """The host DTW (`ops/dtw_host.py`, g++) on one ABX flush's distances
    (18,432 pairs of 32 x 16) against the DTW kernel: bit for bit."""
    from cpc2_torch.ops.dtw import dtw_normalized
    from cpc2_torch.ops.dtw_host import dtw_normalized_host
    own = torch.Generator(device=dev)
    own.manual_seed(13)
    dist, n1, n2 = dtw_draw(dev, own, 18432, 32, 16, "flush")
    kernel = dtw_normalized(dist, n1, n2).cpu().numpy()
    host_in = (dist.cpu().numpy(), n1.cpu().numpy(), n2.cpu().numpy())
    dtw_normalized_host(*host_in)           # builds the library
    start = time.perf_counter()
    host = dtw_normalized_host(*host_in)
    host_s = time.perf_counter() - start
    differing = int(np.count_nonzero(host != kernel))
    if differing:
        raise AssertionError(f"dtw host vs csrc/dtw.cu: {differing} of "
                             f"{len(kernel)} pairs differ")
    return {"pairs": len(kernel), "host_ms": 1e3 * host_s,
            "kernel_ms": cuda_ms(lambda: dtw_normalized(dist, n1, n2))}


def run_common_voices(dev, work: str, checkpoint: str, card: str) -> dict:
    """Phase 9 on the default epoch's checkpoint: [dtw host], [cv lstm],
    the corpus, [cv step] frozen and unfrozen, the two training epochs,
    [cv per], [cv launches] and [hub], each logged as it ends."""
    cv = {"dtw_host": check_dtw_host(dev)}
    d = cv["dtw_host"]
    log(f"[dtw host] one ABX flush ({d['pairs']} pairs of 32 x 16): the "
        f"host DTW bit for bit the csrc/dtw.cu kernel; host "
        f"{d['host_ms']:.2f} ms (one thread), kernel {d['kernel_ms']:.4f} "
        f"ms (events)")
    cv["lstm"] = lstm = check_cv_lstm(dev)
    log(f"[cv lstm] fused_lstm resident route {lstm['plan']} at (8, 1000, "
        f"256) vs lstm_plain: forward {lstm['forward_max_abs_err']:.2e}, "
        f"gradients {lstm['backward_max_abs_err']:.2e} (RTOL {RTOL} of the "
        f"largest), the backward bit-identical across two calls; "
        f"{lstm['fwd_ms']:.4f} ms forward, {lstm['bwd_ms']:.4f} ms "
        f"backward (CUDA events: this late in a whole run the profiler "
        f"has come back without device kernels)")
    corpus = write_cv_corpus(os.path.join(work, "cv"))
    cv["corpus"] = {k: corpus[k] for k in ("seconds", "longest_frames")}
    for mode in ("frozen", "unfrozen"):
        r = cv[f"step_{mode}"] = check_cv_step(dev, checkpoint, mode)
        against = ("cpu" if mode == "frozen" else
                   "float64 with the card's ReLU decisions")
        log(f"[cv step {mode}] 2 utterances of 2 and 3 s at 256 wide, card "
            f"vs {against}: loss {r['loss']:.4f} err {r['loss_err']:.2e}, "
            f"gradients {r['grad_max_abs_err']:.2e} (CTC_RTOL {CTC_RTOL} of "
            f"the largest), parameters after the step (vs cpu) at most "
            f"{r['worst_param_rel']:.2e} in the 2-norm ({r['worst_param']}; "
            f"tolerance {CV_PARAM_NORM_TOL}); two card steps "
            + ("bit for bit" if r["card_steps_bit_for_bit"] else
               f"differ in {r['card_steps_differing']}"))
        if mode == "unfrozen":
            log("  [cv step unfrozen] by encoder layer, the card's ReLU "
                "inputs vs the cpu's (max abs over the largest) and the "
                "decisions that "
                "differ, with the largest |input| among them on the card / "
                "the cpu over the largest: " + "; ".join(
                    f"{i}: {f['spread']:.1e}, {f['flips']}" + (
                        f" ({f['gap_card']:.1e} / {f['gap_cpu']:.1e})"
                        if f["flips"] else "")
                    for i, f in enumerate(r["flips"]))
                + "; gradients past CTC_RTOL card vs cpu (fp32), max abs "
                "over the largest: " + (", ".join(
                    f"{n} {v:.2e}" for n, v in r["past_fp32"].items())
                    or "none"))
    runs = cv["epochs"] = {mode: run_cv_train(corpus, checkpoint, work, mode)
                           for mode in CV_RUNS}
    per = cv["per"] = run_cv_per(runs["frozen_lstm"]["out"])
    log(f"[cv epochs] {card}: {CV_TRAIN} training and {CV_VAL} validation "
        f"utterances ({corpus['seconds']:.0f} s in all, the longest "
        f"{corpus['longest_frames']} frames), batch 8, s per epoch: "
        + ", ".join(f"{mode} {r['epoch_s']:.3f} ({r['train_steps']} + "
                    f"{r['val_steps']} steps, loss {r['loss_train']:.3f} "
                    f"train / {r['loss_val']:.3f} val)"
                    for mode, r in runs.items()))
    log(f"[cv per] {card}: {per['utterances']} utterances, PER "
        f"{per['per_card']:.4f} on the card, {per['per_cpu']:.4f} on the "
        f"cpu; posteriors card vs cpu {per['posterior_max_abs_err']:.2e} "
        f"(held to {CV_POSTERIOR_ATOL}); near ties {per['near_ties']}; s "
        f"per pass {per['per_s_card']:.3f} card, {per['per_s_cpu']:.3f} cpu "
        f"(beam search on the host)")
    log("[cv launches] a training and a validation step each: " + "; ".join(
        f"{mode} {r['launches_per_train_step']} and "
        f"{r['launches_per_val_step']} (the epoch {r['launches_epoch']})"
        for mode, r in runs.items())
        + f"; the per pass {per['launches']}")
    cv["hub"] = hub = check_hub(dev, work, checkpoint)
    log(f"[hub] CPC_audio(pretrained_path=<payload of the default epoch>) "
        f"on the card: features bit for bit load_model's ({hub['frames']} "
        f"frames x {hub['dims']} on 4 x 32,000 samples); CPC_audio() "
        f"{hub['fresh_context']}, launches {hub['launches']}")
    for r in runs.values():
        del r["out"]
    return cv


def cv_launches(cv: dict) -> dict:
    """This path's launches of `lstm_fwd` and `lstm_bwd` for the kernel
    table: per epoch of each training run and per `per` pass."""
    return {name: {**{mode: r["launches_epoch"][name]
                      for mode, r in cv["epochs"].items()},
                   "per": cv["per"]["launches"].get(name, 0)}
            for name in ("lstm_fwd", "lstm_bwd")}


# ---------------------------------------------------------------------------
# Phase 10: the model and criterion modes (`--rnnMode`, `--multihead_rnn`,
# `--cpc_mode`, `--encoder_type`, `--mask_prob`, `--signal_quality_path`)
# ---------------------------------------------------------------------------

# The multi-head trunk's FFN at the recipe (`--multihead_rnn`: 8 x 116 rows,
# 256 -> 2048 -> 12 x 256) and an LSTM prediction head's recurrence
# (`--rnnMode LSTM`: 8 x 116 frames, 256 wide)
VARIANT_FFN = (8 * 116, 256, 2048, 12 * 256)
VARIANT_LSTM = (8, 116, 256)
# The bf16 FFN at VARIANT_FFN: dx sums dh over dff and dh sums the incoming
# gradient over dout = 3,072 terms, 12 times the recipe's, before each is
# rounded to bf16; the kernel's wgmma sums and the plain version's cuBLAS
# sums run in other orders, so more of those rounding points flip between
# the two than between the plain version in fp32 and fp64 (dx 1.245e-4 in
# the 2-norm against a 1.95e-5 spread, at rate 0, on an H100 80GB HBM3).
# A relative 2-norm error of 5e-4 is an eighth of one bf16
# unit of the whole tensor; a wrong tile or index moves it by whole
# percents.
FFN_WIDE_FLOOR = 5e-4
# one training step per flag value, card against CPU at the recipe's
# widths, under `--precision fp32` (held to 1e-3 of each tensor's largest
# value), the multi-head trunk and the MFCC front-end also under `bf16mix`
# (the FFN's bf16 route: FUSED_LOSS_RTOL, FUSED_GRAD_NORM_TOL)
VARIANT_STEPS = (
    ("RNN", ["--rnnMode", "RNN"]), ("LSTM", ["--rnnMode", "LSTM"]),
    ("linear", ["--rnnMode", "linear"]), ("ffd", ["--rnnMode", "ffd"]),
    ("conv4", ["--rnnMode", "conv4"]), ("conv8", ["--rnnMode", "conv8"]),
    ("conv12", ["--rnnMode", "conv12"]),
    ("adaptive_span", ["--rnnMode", "transformer_adaptive_span"]),
    ("multihead", ["--multihead_rnn"]),
    ("reverse", ["--cpc_mode", "reverse"]), ("bert", ["--cpc_mode", "bert"]),
    ("none", ["--cpc_mode", "none"]), ("mfcc", ["--encoder_type", "mfcc"]),
    ("lfb", ["--encoder_type", "lfb"]),
    ("mask", ["--mask_prob", "0.01", "--mask_length", "10"]),
    ("quality", ["--signal_quality_path", ".", "--growth_rate", "5",
                 "--inflection_point_x", "0.4"]))
VARIANT_BOTH_PRECISIONS = ("multihead", "mfcc")
# The MFCC step under `fp32` is held against a float64 CPU step that takes
# the card's ReLU decisions in the heads' FFN (`relu_matched_reference`).
# Its features reach the hundreds and differ between cuFFT and the CPU's
# FFT by fp32 rounding made larger by the log, so a head FFN's input
# differs between the card's and the CPU's fp32 steps by more than one
# rounding, and the rare hidden unit whose input lies that close to 0
# takes the other side of the ReLU on one of them. One such unit moves
# its head's lin1 gradient by whole percents of its largest value (head
# 3's by 1.9e-2, card against CPU, on an H100 80GB HBM3), while the
# tensors no flip reaches agree within 1e-5.
VARIANT_RELU_MATCHED = ("mfcc",)
# one CLI epoch per group; `mask_quality` on the WAV corpus with its
# signal-quality files (`write_quality`)
VARIANT_EPOCHS = {"heads": ["--rnnMode", "LSTM"],
                  "multihead": ["--multihead_rnn"],
                  "reverse": ["--cpc_mode", "reverse"],
                  "bert": ["--cpc_mode", "bert"],
                  "mfcc": ["--encoder_type", "mfcc"],
                  "mask_quality": ["--mask_prob", "0.01",
                                   "--mask_length", "10"]}
# --steps_per_dispatch 4 replays against eager steps
VARIANT_DISPATCH = {"mask_quality": VARIANT_EPOCHS["mask_quality"],
                    "bert": VARIANT_EPOCHS["bert"]}


def variant_launches(flags, train: bool, prec: str = "bf16mix") -> dict:
    """The kernel launches of one step (`train`) or validation step of the
    recipe with `flags`: the context LSTM (none under BERT, whose context
    is a GRU) and an LSTM head a prediction (`--rnnMode LSTM`); the head
    FFN once a transformer head, once for the multi-head trunk, on the
    route `prec` picks; InfoNCE once; `--cpc_mode none` runs no criterion
    and no backward."""
    flags = list(flags)

    def value(name, default):
        return flags[flags.index(name) + 1] if name in flags else default
    mode, rnn = value("--cpc_mode", None), value("--rnnMode", "transformer")
    multihead = "--multihead_rnn" in flags
    k = 12
    lstm = (0 if mode == "bert" else 1) + (k if rnn == "LSTM" and mode not in
                                           ("bert", "none") else 0)
    ffn = (0 if mode in ("bert", "none") else 1 if multihead
           else k if rnn == "transformer" else 0)
    infonce = 0 if mode in ("bert", "none") else 1
    back = train and mode != "none"
    suffix = "_fp32" if prec == "fp32" else ""
    out = {"lstm_fwd": lstm, "lstm_bwd": lstm if back else 0,
           "ffn_fwd" + suffix: ffn, "ffn_bwd" + suffix: ffn if back else 0,
           "infonce_fwd": infonce, "infonce_bwd": infonce if back else 0}
    return {name: n for name, n in out.items() if n}


def held_launches(what: str, launches: dict, want: dict) -> None:
    """Every kernel's launches exactly `want`'s (0 where it has none)."""
    off = {k: (n, want.get(k, 0)) for k, n in launches.items()
           if n != want.get(k, 0)}
    if off:
        raise AssertionError(f"{what}: launches (got, want) {off}")


# Kernel timings late in a whole run go to a process of their own: there
# the profiler has lost launches in every profile (all 17 of phase 10's
# timings in one run on an H100 80GB HBM3; a minute or more of retakes in
# others; phase 11's attention backward in another), while a fresh process
# keeps them. The runner calls `chip_smoke.<argv[3]>(the card)` and writes
# its result as JSON to argv[2].
FRESH_RUNNER = (
    "import json, sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import torch\n"
    "import chip_smoke\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "torch.backends.cudnn.allow_tf32 = False\n"
    "out = getattr(chip_smoke, sys.argv[3])(torch.device('cuda', 0))\n"
    "json.dump(out, open(sys.argv[2], 'w'))\n")


def fresh(work: str, fn: str, label: str) -> dict:
    """`fn` of this script in a fresh process (FRESH_RUNNER), the library
    built by `main` loaded there; its `[profiler]` lines and the lines of
    the checks it prints (indented) are passed on."""
    path = os.path.join(work, f"{fn}.json")
    proc = subprocess.run([sys.executable, "-c", FRESH_RUNNER, ROOT, path,
                           fn], capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        if line.startswith(("[profiler]", "  ")):
            log(line)
    if proc.returncode != 0:
        raise AssertionError(f"[{label}] exit {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    with open(path) as fh:
        return json.load(fh)


def check_variant_kernels(dev) -> dict:
    """The FFN kernels at the multi-head trunk's shape (VARIANT_FFN: dout
    wider than din, 3,072 columns), both routes at dropout 0 and 0.1 held
    against `ffn_plain` as `check_ffn` holds them (the bf16 route's floor
    FFN_WIDE_FLOOR), each backward bit for bit across two calls; the LSTM
    kernels at an LSTM head's (8, 116, 256) against `lstm_plain` (RTOL),
    which must take the resident route, the
    backward bit for bit across two calls. Each timed at the step's
    dropout (0.1) by device time beside its plain version, the bound and
    the library route (the same products as `torch.matmul`, `ffn_route`;
    cuDNN's LSTM), each by device time (`device_ms`). `run_variants` runs
    it in a fresh process (`fresh`)."""
    from cpc2_torch.ops import _build
    from cpc2_torch.ops.ffn import keep_mask
    from cpc2_torch.ops.lstm import fused_lstm, lstm_plain, lstm_plan
    from cpc2_torch.time_kernels import cudnn_lstm, lstm_inputs
    own = torch.Generator(device=dev)
    own.manual_seed(19)
    seed = torch.tensor([12345], device=dev, dtype=torch.int32)
    m, din, dff, dout = VARIANT_FFN
    inputs, cot = ffn_inputs(dev, own, m, din, dff, dout)
    fwd_flops = 2 * m * dff * (din + dout)
    bwd_flops = 2 * m * dff * (3 * din + 2 * dout)
    keep = keep_mask(seed, m, dff, 0.1)
    out = {}
    for bf16 in (True, False):
        errs, ties, ratios = [], 0, []
        for rate in (0.0, 0.1):
            held = hold_ffn(inputs, cot, seed, rate, bf16, FFN_WIDE_FLOOR)
            errs.append(held[:2])
            if bf16:
                ratios.append([f"{r:.2f}" for r in held[2]])
            else:
                ties = max(ties, held[2])
        kern, plain, bwd_k, bwd_p, out_k, grad_k = held[4]
        if not all(torch.equal(a, b) for a, b in zip(grad_k, bwd_k())):
            raise AssertionError(f"ffn {'bf16' if bf16 else 'fp32'} at "
                                 f"{VARIANT_FFN}: backward differs between "
                                 f"two calls")
        suffix, peak, dtype = (("", BF16_FLOP_PER_S, torch.bfloat16) if bf16
                               else ("_fp32", TF32X3_FLOP_PER_S,
                                     torch.float32))
        gemm = "ffn_wgmma_gemm" if bf16 else "ffn_tf32x3_gemm"
        with torch.no_grad():
            fwd_ms = device_ms(lambda: kern(*inputs), expect=gemm)
            plain_fwd = device_ms(lambda: plain(*inputs), 5)
            _y, saved = ffn_route(*inputs, keep, 1 / 0.9, dtype)
            route_fwd = device_ms(
                lambda: ffn_route(*inputs, keep, 1 / 0.9, dtype))
            route_bwd = device_ms(
                lambda: ffn_route_bwd(cot[0], keep, 1 / 0.9, saved))
        bwd_ms = device_ms(bwd_k, expect=gemm)
        plain_bwd = device_ms(bwd_p, 5)
        for name, err, ms, pms, rms, n_bytes, flops in (
                ("ffn_fwd" + suffix, max(e[0] for e in errs), fwd_ms,
                 plain_fwd, route_fwd, nbytes(*inputs) + nbytes(*out_k),
                 fwd_flops),
                ("ffn_bwd" + suffix, max(e[1] for e in errs), bwd_ms,
                 plain_bwd, route_bwd,
                 nbytes(*inputs[:4], *cot) + nbytes(*grad_k), bwd_flops)):
            bound, by = bound_ms(n_bytes, flops, peak)
            out[name] = {"shape": list(VARIANT_FFN), "max_abs_err": err,
                         "ms": ms, "plain_ms": pms, "route_ms": rms,
                         "bound_ms": bound, "bound_by": by}
        if bf16:
            out["ffn_fwd"]["band_ratios"] = ratios
        else:
            out["ffn_fwd_fp32"]["relu_ties"] = ties

    b, t, h = VARIANT_LSTM
    plan = lstm_plan(b, h, _build.sm_count(dev))
    if plan.route != "resident":
        raise AssertionError(f"lstm_plan{VARIANT_LSTM[::2]} = {plan}")
    inputs, cot = lstm_inputs(dev, own, b, t, h)
    _build.reset_launches()
    out_k, grad_k, bwd_k = grads_of(fused_lstm, inputs, cot)
    held_launches(f"fused_lstm at {VARIANT_LSTM}",
                  {k: n for k, n in _build.LAUNCHES.items() if n},
                  {"lstm_fwd": 1, "lstm_bwd": 1})
    out_p, grad_p, bwd_p = grads_of(lstm_plain, inputs, cot)
    what = f"lstm resident {VARIANT_LSTM}"
    err_f = compare(what + " forward", out_k, out_p)
    err_b = compare(what + " backward", grad_k, grad_p)
    if not all(torch.equal(a, g) for a, g in zip(bwd_k(), grad_k)):
        raise AssertionError(f"{what} backward: two calls differ")
    lib_fwd, lib_bwd = cudnn_lstm(inputs, cot)
    with torch.no_grad():
        fwd_ms = device_ms(lambda: fused_lstm(*inputs),
                           expect="lstm_fwd_resident")
        plain_fwd = device_ms(lambda: lstm_plain(*inputs), 3)
        lib_f = device_ms(lib_fwd)
    gi, h0, c0, w_hh, _b_hh = inputs
    mm = 2 * b * t * 4 * h * h
    fwd_bytes = nbytes(*inputs) + nbytes(*out_k) + nbytes(out_k[0], gi)
    bwd_bytes = (nbytes(w_hh, h0, c0) + nbytes(*cot) + nbytes(out_k[0]) * 2
                 + nbytes(gi) + nbytes(*grad_k))
    for name, err, ms, pms, lms, n_bytes, flops in (
            ("lstm_fwd", err_f, fwd_ms, plain_fwd, lib_f, fwd_bytes, mm),
            ("lstm_bwd", err_b,
             device_ms(bwd_k, expect="lstm_bwd_resident"),
             device_ms(bwd_p, 3), device_ms(lib_bwd),
             bwd_bytes, 2 * mm)):
        bound, by = bound_ms(n_bytes, flops)
        out[name] = {"shape": list(VARIANT_LSTM), "max_abs_err": err,
                     "ms": ms, "plain_ms": pms, "library_ms": lms,
                     "bound_ms": bound, "bound_by": by}
    return out


def variant_args(flags):
    from cpc2_torch.config import parse_args
    return parse_args(["--pathDB", ".", "--random_seed", "0"] + list(flags))


def variant_inputs(args, seed: int = 0):
    """The recipe's batch, negatives, mask and quality for a step of
    `args`, drawn with numpy: BERT's negatives (B*S, N) over the past
    views' unmasked frames, the others' (B, N, W); the mask drawn as the
    loader's side draws it (`train.step_mask`)."""
    from cpc2_torch.train import step_mask
    rs = np.random.RandomState(seed)
    b, s, n = args.batchSizeGPU, args.sizeWindow // 160, \
        args.negativeSamplingExt
    batch = rs.randn(b, 2, 1, args.sizeWindow).astype(np.float32)
    np.random.seed(seed)
    mask = step_mask(args, b)
    if args.cpc_mode == "bert":
        free = np.flatnonzero(~mask[:b].reshape(-1))
        neg = free[rs.randint(0, free.size, (b * s, n))]
    else:
        neg = rs.randint(0, b * s, (b, n, s - args.nPredicts))
    quality = (rs.uniform(0, 1, (b, args.sizeWindow // 1600)).astype(
        np.float32) if args.signal_quality_path is not None else None)
    return [torch.from_numpy(x) if x is not None else None
            for x in (batch, neg.astype(np.int32), mask, quality)]


class FFNSpy:
    """In place of `cpc2_torch.models.transformer.fused_ffn` inside a `with`
    block: keeps each call's (x, w1, b1, seed); with `masks` (one (M, Dff)
    float64 tensor a call), runs the FFN at dropout 0 with those ReLU
    decisions instead of its own."""

    def __init__(self, masks=None):
        self.calls, self.masks, self.real = [], masks, None

    def __enter__(self):
        from cpc2_torch.models import transformer
        self.real, transformer.fused_ffn = transformer.fused_ffn, self
        return self

    def __exit__(self, *exc):
        from cpc2_torch.models import transformer
        transformer.fused_ffn = self.real

    def __call__(self, x, w1, b1, w2, b2, seed, rate=0.0, bf16=False):
        self.calls.append(tuple(t.detach().clone()
                                for t in (x, w1, b1, seed)))
        if self.masks is None:
            return self.real(x, w1, b1, w2, b2, seed, rate, bf16)
        if rate:
            raise AssertionError("FFNSpy with masks runs at dropout 0")
        mask = self.masks[len(self.calls) - 1]
        return ((x @ w1.t() + b1) * mask) @ w2.t() + b2

    def decisions(self):
        """Each call's ReLU decisions, (M, Dff) bool on the CPU, as the
        FFN that ran took them (`ffn_hidden`)."""
        return [(ffn_hidden(*call) > 0).cpu() for call in self.calls]


def relu_matched_reference(card: FFNSpy, cpu: FFNSpy, run) -> tuple:
    """The float64 reference of a step with the card's ReLU decisions in
    every head FFN (`card`'s), from `run(spy)`, which runs the float64 CPU
    step inside `spy` and returns its {name: tensor}; and, by head FFN,
    the decisions that differ between the card and the CPU's fp32 step
    (`cpu`)."""
    ours, theirs = card.decisions(), cpu.decisions()
    flips = [int((a != b).sum()) for a, b in zip(ours, theirs)]
    return run(FFNSpy([d.double() for d in ours])), flips


def check_variant_step(dev, name: str, flags, prec: str,
                       want=None, draw=None) -> tuple:
    """One training step of `flags` at the recipe on the card against the
    same step on the CPU (`_check_step`'s method: same weights, negatives,
    mask and quality, dropout off), under `prec`, with the card step's
    launches held to `variant_launches` (or to `want`). Under `fp32` the
    flags of VARIANT_RELU_MATCHED are held against a float64 CPU step with
    the card's ReLU decisions (`relu_matched_reference`) instead. With
    `draw` ((B, N, W) int32), the criterion draws its negatives itself and
    the draw returns `draw` (`fixed_draw`): the route of drawn indices
    (phase 12's grouped plan). Returns (max abs err, launches, the card
    step's ms by CUDA events over 3 more steps)."""
    from cpc2_torch.feature_loader import build_model
    from cpc2_torch.ops import _build
    from cpc2_torch.train import get_criterion
    from cpc2_torch.training import Trainer, make_optimizer
    from cpc2_torch.training import precision as library_precision
    args = variant_args(flags)
    batch, neg, mask, quality = variant_inputs(args)
    if draw is not None:
        neg = draw
    torch.manual_seed(0)
    model_cpu, crit_cpu = build_model(args), get_criterion(args)
    matched = prec == "fp32" and name in VARIANT_RELU_MATCHED
    spies = {}

    def step(device, dtype=torch.float32, spy=None):
        """The step on `device` in `dtype` (inside `spy`): {name: the
        losses, then each parameter's gradient}, the launches, a call
        that runs another step."""
        model = build_model(variant_args(flags)).to(device, dtype)
        crit = get_criterion(args).to(device, dtype)
        model.load_state_dict(model_cpu.state_dict())
        crit.load_state_dict(crit_cpu.state_dict())
        for mod in crit.modules():
            if hasattr(mod, "rate"):
                mod.rate = 0.0
            if hasattr(mod, "dropout") and isinstance(mod.dropout, float):
                mod.dropout = 0.0
        named = (list(model.named_parameters(prefix="model"))
                 + list(crit.named_parameters(prefix="criterion")))
        trainer = Trainer(model, crit, make_optimizer(
            args, [p for _n, p in named]))
        step_in = [None if x is None else x.to(device) for x in (
            batch, neg, mask, quality)]
        step_in[0] = step_in[0].to(dtype)
        if step_in[3] is not None:
            step_in[3] = step_in[3].to(dtype)
        given = None if draw is not None else step_in[1]
        _build.reset_launches()
        with spy or contextlib.nullcontext(), (
                contextlib.nullcontext() if draw is None
                else fixed_draw(step_in[1], args.neg_pool_group)):
            losses, _accs = trainer.train_step(
                step_in[0], given, mask=step_in[2], quality=step_in[3])
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        out = {"losses": losses.detach().cpu()}
        out.update((n, p.grad.cpu()) for n, p in named)
        return out, launches, lambda: trainer.train_step(
            step_in[0], given, mask=step_in[2], quality=step_in[3])

    with library_precision(prec):
        if matched:
            spies = {"cpu": FFNSpy(), "card": FFNSpy()}
        results = [step(torch.device("cpu"), spy=spies.get("cpu"))[0]]
        card, launches, again = step(dev, spy=spies.get("card"))
        results.append(card)
        ms = cuda_ms(again, iters=3, warmup=1)
        if matched:
            ref, flips = relu_matched_reference(
                spies["card"], spies["cpu"],
                lambda spy: step(torch.device("cpu"), torch.float64, spy)[0])
    held_launches(f"[variant step {name} {prec}]", launches,
                  want or variant_launches(flags, True, prec))
    what = f"{name} {prec} step at the recipe"
    cpu, card = (list(r.values()) for r in results)
    if matched:
        off = {}
        for n, g, c in zip(results[1], card, cpu):
            err = (g.double() - c.double()).abs().max().item()
            scale = c.double().abs().max().item()
            if err > ATOL + 1e-3 * scale:
                off[n] = f"{err / scale:.2e}"
        log(f"  {what}: ReLU decisions that differ card vs cpu (fp32), "
            f"by head FFN: {flips}; past 1e-3 card vs cpu (fp32), max abs "
            f"over the largest: {off or 'none'}; held instead against "
            f"float64 with the card's decisions")
        return compare(what + " (card vs float64 with the card's ReLU "
                       "decisions)", card, list(ref.values()),
                       rtol=1e-3), launches, ms
    if prec == "fp32":
        worst = max(norm_rel(g, c) for g, c in zip(card[1:], cpu[1:])
                    if c.abs().max() > 0) if name != "none" else 0.0
        log(f"  {what}: worst gradient card vs cpu {worst:.2e} (2-norm, "
            f"relative)")
        return compare(what + " (card vs cpu)", card, cpu,
                       rtol=1e-3), launches, ms
    err = compare(f"{what} losses (card vs cpu)", card[:1], cpu[:1],
                  rtol=FUSED_LOSS_RTOL)
    for n, g, c in zip(list(results[1])[1:], card[1:], cpu[1:]):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what} gradient {n}: non-finite")
        rel = norm_rel(g, c)
        tol = (FFN_LIN1_GRAD_NORM_TOL if ".ffnetwork.lin1." in n
               else FUSED_GRAD_NORM_TOL)
        if rel > tol:
            raise AssertionError(f"{what} gradient {n}: card vs cpu "
                                 f"{rel:.3e} (2-norm, relative)")
        err = max(err, (g.double() - c.double()).abs().max().item())
    return err, launches, ms


def write_quality(work: str, source: str = "train_db_wav") -> str:
    """Signal-quality files for the WAV corpus: for every `<rel>.wav`, a
    `<rel>.pt` of its (SNR, C50) every 1,600 samples, each a (n, 1) tensor
    drawn with numpy, and `min_max.csv`; the folder's path."""
    from cpc2_torch.data.audio_io import audio_info
    folder = os.path.join(work, "quality")
    rs = np.random.RandomState(7)
    root = os.path.join(work, source)
    for path in sorted(glob.glob(os.path.join(root, "*", "*", "*.wav"))):
        rel = os.path.relpath(path, root)
        os.makedirs(os.path.join(folder, os.path.dirname(rel)),
                    exist_ok=True)
        n = audio_info(path)[0] // 1600
        torch.save([torch.from_numpy(rs.uniform(0, 30, (n, 1)).astype(
                        np.float32)),
                    torch.from_numpy(rs.uniform(0, 60, (n, 1)).astype(
                        np.float32))],
                   os.path.join(folder, rel[:-len(".wav")] + ".pt"))
    with open(os.path.join(folder, "min_max.csv"), "w") as f:
        f.write("min_snr,max_snr,min_c50,max_c50\n0,30,0,60\n")
    return folder


def run_variant_epoch(dev, work: str, group: str, quality: str) -> dict:
    """One epoch of `python -m cpc2_torch.train` at the CLI defaults with
    the group's VARIANT_EPOCHS flags (`mask_quality`: on the WAV corpus
    with `--signal_quality_path quality`), its launches held exactly to
    `variant_launches` times its training and validation steps, its losses
    finite, its checkpoint written."""
    from cpc2_torch.ops import _build
    from cpc2_torch.train import main
    flags = list(VARIANT_EPOCHS[group])
    db = "train_db"
    if group == "mask_quality":
        flags += ["--file_extension", ".wav", "--signal_quality_path",
                  quality]
        db = "train_db_wav"
    ck = os.path.join(work, f"ck_variant_{group}")
    _build.reset_launches()
    record = main(train_argv(work, ck, *flags, db=db))
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    n_train, n_val = len(record["step_ms"]), record["val_steps"]
    want = {}
    for train, n in ((True, n_train), (False, n_val)):
        for k, per in variant_launches(flags, train).items():
            want[k] = want.get(k, 0) + n * per
    held_launches(f"[variant epoch {group}] ({n_train} + {n_val} steps)",
                  launches, want)
    heads = 1 if group == "bert" else 12
    for key in ("locLoss_train", "locAcc_train", "locLoss_val"):
        values = np.asarray(record["logs"][key], dtype=np.float64)
        if values.shape != (1, heads) or not np.isfinite(values).all():
            raise AssertionError(f"[variant epoch {group}] {key}: {values}")
    if n_train < 5:
        raise AssertionError(f"[variant epoch {group}] only {n_train} steps")
    record["launches"] = launches
    record["checkpoint"] = os.path.join(ck, "checkpoint_0.pt")
    return record


def check_variant_dispatch(dev, group: str, corpus, offsets) -> dict:
    """`--steps_per_dispatch 4` with the group's flags (VARIANT_DISPATCH):
    a `MultiStep` of DISPATCH_N steps, its first group the eager warm-up,
    the state copied to a second trainer, then 3 groups as graph replays
    against the same 3 x N steps eagerly, each step with its mask (drawn as
    the loader's side draws it) and, for `mask_quality`, its signal
    quality, under `bf16mix`: the losses, parameters, Adam's state and the
    generators bit for bit, and a replay's launches N times an eager
    step's."""
    from cpc2_torch.ops import _build
    from cpc2_torch.train import step_mask
    from cpc2_torch.training import MultiStep, precision
    flags = VARIANT_DISPATCH[group]
    args, graphed = dispatch_trainer(dev, 256, flags=flags)
    _, eager = dispatch_trainer(dev, 256, flags=flags)
    np.random.seed(11)
    masks = torch.from_numpy(np.stack([np.stack(
        [step_mask(args, 8) for _ in range(DISPATCH_N)])
        for _ in range(offsets.shape[0])])).to(dev)
    quality = (torch.from_numpy(np.random.RandomState(12).uniform(
        0, 1, (offsets.shape[0], DISPATCH_N, 8, 12)).astype(
            np.float32)).to(dev) if group == "mask_quality" else None)

    def q(g):
        return None if quality is None else quality[g]
    with precision("bf16mix"):
        multi = MultiStep(graphed, DISPATCH_N, corpus)
        multi(offsets[0], None, q(0), masks[0])      # the warm-up, eager
        eager.model.load_state_dict(graphed.model.state_dict())
        eager.criterion.load_state_dict(graphed.criterion.state_dict())
        eager.optimizer.load_state_dict(
            copy.deepcopy(graphed.optimizer.state_dict()))
        eager.generator.set_state(graphed.generator.get_state())
        eager.augment_generator.set_state(
            graphed.augment_generator.get_state())
        torch.cuda.synchronize()
        _build.reset_launches()
        rows = [multi(offsets[g], None, q(g), masks[g])[0].clone()
                for g in range(1, 4)]
        torch.cuda.synchronize()
        eager_rows, per_step = [], None
        for g in range(1, 4):
            for i in range(DISPATCH_N):
                _build.reset_launches()
                eager_rows.append(eager.train_step(
                    corpus.put(offsets[g][i]), mask=masks[g][i],
                    quality=None if quality is None else quality[g][i])[0])
                per_step = per_step or {
                    k: n for k, n in _build.LAUNCHES.items() if n}
    off = {k: (multi.launches.get(k, 0), n) for k, n in per_step.items()
           if multi.launches.get(k, 0) != DISPATCH_N * n}
    if off or set(multi.launches) - set(per_step):
        raise AssertionError(f"[variant dispatch {group}] launches a replay "
                             f"vs an eager step: {off}, "
                             f"{multi.launches}")
    differing = {}
    got, want = torch.cat(rows), torch.cat(eager_rows)
    if not torch.equal(got, want):
        differing["losses"] = (got - want).abs().max().item()
    state_g, state_e = trainer_state(graphed), trainer_state(eager)
    for key, value in state_g.items():
        if not torch.equal(value, state_e[key]):
            differing[key] = (value.double() - state_e[key].double()
                              ).abs().max().item()
    if differing:
        raise AssertionError(f"[variant dispatch {group}] replay vs eager "
                             f"differ: {differing}")
    return {"tensors": len(state_g) + 1, "captures": multi.captures,
            "launches_per_replay": multi.launches}


def run_variants(dev, work: str, card: str) -> dict:
    """Phase 10: the kernels at the variants' new shapes, one step per flag
    value card against CPU, one CLI epoch per group (the launch counts
    held), the N = 4 graph replays with masks and quality, ABX from a
    reverse and an MFCC checkpoint (features card against CPU within 1e-3),
    and the LFB step's determinism."""
    out = {}
    start = time.perf_counter()
    kernels = out["kernels"] = fresh(work, "check_variant_kernels",
                                     "variant kernels")
    log(f"[variant kernels] {time.perf_counter() - start:.1f} s, {card}: "
        + "; ".join(
            f"{name} at {tuple(r['shape'])}: err {r['max_abs_err']:.2e}, "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            + (f"torch.matmul route {r['route_ms']:.4f} ms"
               if "route_ms" in r else f"cuDNN {r['library_ms']:.4f} ms")
            + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            for name, r in kernels.items())
        + "; every backward bit for bit across two calls (device time, in a "
        "fresh process)")
    steps = out["steps"] = {}
    for name, flags in VARIANT_STEPS:
        for prec in (("fp32", "bf16mix") if name in VARIANT_BOTH_PRECISIONS
                     else ("fp32",)):
            start = time.perf_counter()
            err, launches, ms = check_variant_step(dev, name, flags, prec)
            steps[f"{name} {prec}"] = {"max_abs_err": err,
                                       "launches": launches, "ms": ms}
            log(f"[variant step {name} {prec}] {' '.join(flags)}: card vs "
                f"cpu at the recipe, max abs err {err:.2e}, "
                f"{time.perf_counter() - start:.1f} s, card step {ms:.3f} ms "
                f"(events, {card}), launches {launches}")
    quality = write_quality(work)
    epochs = out["epochs"] = {}
    for group in VARIANT_EPOCHS:
        start = time.perf_counter()
        epochs[group] = run_variant_epoch(dev, work, group, quality)
        log(f"[variant epoch {group}] {time.perf_counter() - start:.1f} s, "
            f"{card}: {' '.join(VARIANT_EPOCHS[group])}, "
            f"{len(epochs[group]['step_ms'])} + "
            f"{epochs[group]['val_steps']} steps, median "
            f"{epochs[group]['median_step_ms']:.3f} ms/step, launches "
            f"{epochs[group]['launches']} (held exactly)")
    corpus_d, offsets_d = dispatch_corpus(dev)
    dispatch = out["dispatch"] = {}
    for group in VARIANT_DISPATCH:
        start = time.perf_counter()
        dispatch[group] = check_variant_dispatch(dev, group, corpus_d,
                                                 offsets_d)
        log(f"[variant dispatch {group}] {time.perf_counter() - start:.1f} "
            f"s, {card}: 3 groups of {DISPATCH_N} steps replayed bit for "
            f"bit against eager steps ({dispatch[group]['tensors']} tensors), masks "
            + ("and quality " if group == "mask_quality" else "")
            + f"in each step, launches a replay "
            f"{dispatch[group]['launches_per_replay']}")
    del corpus_d
    abx = out["abx"] = {}
    for group in ("reverse", "mfcc"):
        start = time.perf_counter()
        r = run_abx(dev, work, epochs[group]["checkpoint"],
                    cpu_batched=group == "mfcc")
        abx[group] = {k: r[k] for k in ("scores", "feature_max_abs_err",
                                        "launches", "features_s",
                                        "scoring_s")}
        log(f"[variant abx {group}] {time.perf_counter() - start:.1f} s, "
            f"{card}: scores {r['scores']}, features {r['features_s']:.3f} "
            f"s, scoring {r['scoring_s']:.3f} s, features card vs cpu "
            f"{r['feature_max_abs_err']:.2e} (held to 1e-3)")
    start = time.perf_counter()
    det = out["determinism_lfb"] = step_determinism(
        dev, flags=("--encoder_type", "lfb"))
    log(f"[determinism] {time.perf_counter() - start:.1f} s: a "
        f"--encoder_type lfb step at the CLI defaults, {det['passes']} "
        f"passes on the same weights, batch and draws: of the losses and "
        f"{det['gradients']} gradients these differ (max abs): "
        f"{det['differing'] or 'none'}")
    return out


def variant_launches_by_kernel(variants: dict) -> dict:
    """Each kernel's launches over phase 10's CLI epochs."""
    total = {}
    for record in variants["epochs"].values():
        for k, n in record["launches"].items():
            total[k] = total.get(k, 0) + n
    return total


# ---------------------------------------------------------------------------
# Phase 11: `--precision bf16` (the transformer heads' bf16 activations, the
# FFN's and the attention's bf16-in/bf16-out kernels) and `--adam_mu_dtype
# bf16` (`cpc2_torch/optim.py`, the bf16-moment Adam kernel)
# ---------------------------------------------------------------------------

# the bf16-io FFN at the recipe and at the small step's ragged shape (the
# bf16 kernels take widths that are multiples of 8); the bf16-io attention
# at the recipe and at a unit whose dk comes in chunks (the wide kernels)
BF16_FFN_SHAPES = ((8 * 116, 256, 2048, 256), (84, 64, 2048, 64))
# the recipe, a wide one (dk in chunks), and one whose rows do not fit a
# staging region beside the fp32 ones (its boxes widened in place)
BF16_ATTENTION_SHAPES = ((64, 116, 32), (3, 8, 256), (3, 86, 97))
# the wide attention kernels timed, fp32 and bf16-io, at 64 units of 8 steps
# and dk 256 (above a TMA box's 248: two chunks of dk)
WIDE_ATTENTION_SHAPE = (64, 8, 256)
BF16_IO_FFN = ("ffn_fwd_bf16io", "ffn_bwd_bf16io")
BF16_IO_ATTENTION = ("attention_fwd_bf16io", "attention_bwd_bf16io")
BF16_FLAGS = ["--precision", "bf16"]
BF16_MU_FLAGS = BF16_FLAGS + ["--adam_mu_dtype", "bf16"]
# the bf16 epochs: (flags, both opt-in kernels)
BF16_EPOCHS = {"bf16": (BF16_FLAGS, False),
               "bf16_mu": (BF16_MU_FLAGS, False),
               "bf16_fused": (BF16_MU_FLAGS, True),
               "bf16_dispatch": (BF16_MU_FLAGS + DISPATCH_FLAGS, False)}
# the kernels each bf16 epoch must launch, and those it must not (as EPOCHS)
BF16_CORE = LSTM_RESIDENT + ("infonce_fwd", "infonce_bwd") + BF16_IO_FFN
BF16_MUST_NOT = FFN_KERNELS + LSTM_GRID + ("attention_fwd", "attention_bwd")
BF16_EPOCH_KERNELS = {
    "bf16": (BF16_CORE, BF16_MUST_NOT + FUSED_KERNELS + BF16_IO_ATTENTION
             + ("adam_bf16_moment",)),
    "bf16_mu": (BF16_CORE + ("adam_bf16_moment",),
                BF16_MUST_NOT + FUSED_KERNELS + BF16_IO_ATTENTION),
    "bf16_fused": (BF16_CORE + BF16_IO_ATTENTION
                   + ("encoder_fwd", "encoder_bwd", "adam_bf16_moment"),
                   BF16_MUST_NOT),
    "bf16_dispatch": (BF16_CORE + ("adam_bf16_moment",),
                      BF16_MUST_NOT + FUSED_KERNELS + BF16_IO_ATTENTION)}


@functools.lru_cache(maxsize=None)
def recipe_adam_launches() -> int:
    """The bf16-moment Adam's launches in one step of the recipe: one for
    each `optim.MAX_TENSORS` of the model's and the criterion's parameter
    tensors (built on the CPU)."""
    from cpc2_torch.config import parse_args
    from cpc2_torch.feature_loader import build_model
    from cpc2_torch.optim import MAX_TENSORS
    from cpc2_torch.train import get_criterion
    args = parse_args(["--pathDB", ".", *BF16_MU_FLAGS])
    with torch.random.fork_rng(devices=[]):
        n = len(list(build_model(args).parameters())
                + list(get_criterion(args).parameters()))
    return -(-n // MAX_TENSORS)


def bf16_launches(train: bool, fused: bool, mu: bool) -> dict:
    """The kernel launches of one training (`train`) or validation step of
    the recipe under `--precision bf16`: the context LSTM and InfoNCE once,
    the bf16-io FFN once a head (12), with `fused` the bf16-io attention
    once a head and the encoder once, with `mu` (`--adam_mu_dtype bf16`)
    the bf16-moment Adam's `recipe_adam_launches` a training step."""
    k = 12
    out = {"lstm_fwd": 1, "infonce_fwd": 1, "ffn_fwd_bf16io": k}
    if fused:
        out.update(attention_fwd_bf16io=k, encoder_fwd=1)
    if train:
        out.update({name.replace("_fwd", "_bwd"): n
                    for name, n in out.items()})
        if mu:
            out["adam_bf16_moment"] = recipe_adam_launches()
    return out


# A bf16 output of a bf16-io kernel and of its plain version, both rounded
# once from fp32 sums taken in other orders, differ by one bf16 ulp where a
# value lies within that chatter of a rounding boundary: a handful of such
# flips in a small tensor is its whole 2-norm difference, however right the
# kernel. So a bf16 tensor's floor is what FLIPS flips at its largest
# magnitude's ulp would make (`flip_floor`), or RTOL where that is larger.
FLIPS = 4


def flip_floor(t) -> float:
    """The relative 2-norm of FLIPS one-ulp differences at the ulp of
    max|t|, against t (bf16: 8 bits of significand)."""
    top = t.double().abs().max().item()
    if top == 0.0:
        return RTOL
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    return max(RTOL, ulp * math.sqrt(FLIPS) / t.double().norm().item())


def hold_bf16io(what, names, kern, plain, wide, inputs, cot):
    """`kern` against `plain` on bf16 inputs (the output and the gradients
    of every input), each tensor held to FFN_BAND times the plain version's
    own spread against the float64 version, or to its floor (`flip_floor`
    for a bf16 tensor, else RTOL); the kernel's backward bit for bit across
    two calls. The float64 version is `wide` (the plain version's function
    on float64 tensors, with its rounding points inside) on float64 copies,
    with the io's rounding points too: its output rounded to bf16, and the
    gradient of each input that is bf16 here rounded to bf16. So the band
    holds only the chatter of fp32 sums against float64 at the same
    rounding points, not the roundings themselves. Returns (forward max abs
    error, backward max abs error, each tensor's error over its limit, the
    bands, the timing closures)."""
    from cpc2_torch.ops.encoder import _RoundGrad, _RoundValue
    io = [t.dtype == torch.bfloat16 for t in inputs]

    def rounded(*a):
        return _RoundValue.apply(wide(*(_RoundGrad.apply(t) if r else t
                                        for t, r in zip(a, io))))
    out_k, grad_k, bwd_k = grads_of(kern, inputs, cot)
    out_p, grad_p, bwd_p = grads_of(plain, inputs, cot)
    out_d, grad_d, _ = grads_of(rounded, [t.double() for t in inputs],
                                [c.double() for c in cot])
    got = out_k + list(grad_k)
    want = out_p + list(grad_p)
    errs, _, spreads, rels = band(what, names, got, want,
                                  out_d + list(grad_d))
    ratios = []
    for n, p, err, spread in zip(names, want, rels, spreads):
        floor = flip_floor(p) if p.dtype == torch.bfloat16 else RTOL
        limit = max(FFN_BAND * spread, floor)
        if err > limit:
            raise AssertionError(f"{what} {n}: kernel vs plain {err:.3e} "
                                 f"(2-norm, relative), plain fp32 vs fp64 "
                                 f"{spread:.3e}, floor {floor:.3e}")
        ratios.append(err / limit)
    if not all(torch.equal(x, y) for x, y in zip(grad_k, bwd_k())):
        raise AssertionError(f"{what} backward differs between two calls")
    return errs[0], max(errs[1:]), ratios, spreads, (bwd_k, bwd_p, out_k,
                                                     grad_k)


def kernel_short(name: str) -> str:
    """A profiled kernel's name without its namespaces and parameters."""
    import re
    found = re.search(r"(\w+(?:<[^()]*>)?)\(", name)
    return found[1] if found else name


def split_line(split: dict) -> str:
    return ", ".join(f"{kernel_short(k)} {v:.4f}" for k, v in split.items())


def check_bf16_ffn(dev, gen) -> tuple:
    """The FFN's bf16-io kernels (a bf16 x, y and dx; fp32 weights and
    their gradients) against `ffn_plain` on the same bf16 x at
    BF16_FFN_SHAPES, dropout 0 and 0.1, within FFN_BAND (`hold_bf16io`),
    each backward bit for bit across two calls; at the recipe the launches
    a call by the profile's kernel counts (3 forward, 3 backward, no
    `ffn_sum_partials`); timed at the recipe and 0.1 by device time,
    split by launch (`device_split`; events beside), with the plain
    version and the `torch.matmul` route on bf16 tensors (`ffn_route`).
    Returns the kernel entries, the route's times, the events' times and
    the splits (with the clusters of 2, 4 and 8 split CTAs the card holds
    at once)."""
    from cpc2_torch.ops.ffn import cluster_fits, ffn_plain, fused_ffn, \
        keep_mask
    seed = torch.tensor([12345], device=dev, dtype=torch.int32)
    errs, ratios = [], []
    for shape in BF16_FFN_SHAPES:
        (x, *ws), cot = ffn_inputs(dev, gen, *shape)
        inputs = [x.to(torch.bfloat16)] + ws
        cot = [cot[0].to(torch.bfloat16)]
        if shape == BF16_FFN_SHAPES[0]:
            recipe = inputs, cot
        for rate in (0.0, 0.1):
            def kern(*a, rate=rate):
                return fused_ffn(*a, seed, rate, True)

            def plain(*a, rate=rate):
                return ffn_plain(*a, seed, rate, True)
            held = hold_bf16io(
                f"ffn bf16io {shape} rate {rate}",
                ["y", "dx", "dw1", "db1", "dw2", "db2"], kern, plain, plain,
                inputs, cot)
            errs.append(held[:2])
            ratios += held[2]
            if shape == BF16_FFN_SHAPES[0]:
                timed = held[4]   # the recipe at rate 0.1 last
    inputs, cot = recipe
    bwd_k, bwd_p, out_k, grad_k = timed
    m, din, dff, dout = BF16_FFN_SHAPES[0]
    with torch.no_grad():
        fwd_split = device_split(lambda: kern(*inputs), expect="ffn_io_split")
        fwd_ms = sum(fwd_split.values())
        plain_fwd = device_ms(lambda: plain(*inputs))
        events = {"ffn_fwd_bf16io": cuda_ms(lambda: kern(*inputs))}
        keep = keep_mask(seed, m, dff, 0.1)
        _y, saved = ffn_route(*inputs, keep, 1 / 0.9)
        yard = {"ffn_fwd_bf16io": device_ms(
                    lambda: ffn_route(*inputs, keep, 1 / 0.9)),
                "ffn_bwd_bf16io": device_ms(
                    lambda: ffn_route_bwd(cot[0], keep, 1 / 0.9, saved))}
    bwd_split = device_split(bwd_k, expect="ffn_io_split")
    bwd_ms = sum(bwd_split.values())
    plain_bwd = device_ms(bwd_p)
    events["ffn_bwd_bf16io"] = cuda_ms(bwd_k)
    for what, fn, most in (("fwd", lambda: kern(*inputs), 3),
                           ("bwd", bwd_k, 3)):
        with torch.no_grad() if what == "fwd" else contextlib.nullcontext():
            _, counts = kernel_counts(fn, "ffn_io_split", 5)
        ours = {kernel_short(k): n for k, n in counts.items()
                if kernel_short(k).startswith("ffn_")}
        if (not ours or sum(ours.values()) > most
                or any("sum_partials" in k for k in ours)):
            raise AssertionError(f"ffn bf16io {what}: launches a call "
                                 f"{ours}, at most {most} and no "
                                 f"ffn_sum_partials")
    clusters = dict(zip(("2", "4", "8"), cluster_fits(inputs[0].device)))
    log(f"  ffn bf16io kernels vs plain at {list(BF16_FFN_SHAPES)}, rates 0 "
        f"and 0.1, relative 2-norm: at most {max(ratios):.2f} of the limit "
        f"({FFN_BAND} x the plain version's own spread against float64 at "
        f"the same rounding points, or the floor); every backward bit for "
        f"bit across two calls")
    gemm = 2 * m * din * dff
    src, rep = "cpc2_torch/csrc/ffn.cu", "cpc2_tpu/ops/ffn_pallas.py"
    return [kernel_entry("ffn_fwd_bf16io", src, rep + ":193",
                         max(e[0] for e in errs), fwd_ms, plain_fwd, None,
                         nbytes(*inputs) + nbytes(*out_k), 2 * gemm,
                         BF16_FLOP_PER_S),
            kernel_entry("ffn_bwd_bf16io", src, rep + ":217",
                         max(e[1] for e in errs), bwd_ms, plain_bwd, None,
                         nbytes(*inputs[:4], *cot) + nbytes(*grad_k),
                         5 * gemm, BF16_FLOP_PER_S)], yard, events, {
        "ffn_fwd_bf16io": fwd_split, "ffn_bwd_bf16io": bwd_split,
        "clusters": clusters}


def attention_inputs(dev, draw, n, s, dk, dtype=torch.float32):
    inputs = [torch.randn(n, s, dk, device=dev, generator=draw).to(dtype)
              for _ in range(3)]
    inputs.append(0.2 * torch.randn(dk, s, device=dev, generator=draw))
    return inputs, [torch.randn(n, s, dk, device=dev,
                                generator=draw).to(dtype)]


def attention_ops(dk: int, pairs: int, bf16io: bool, backward: bool):
    """The attention's products (each 2 dk operations a causal (row,
    column) pair) by their operand types, as `bound_ms` takes them. fp32
    io: every product fp32 x fp32 (3xTF32), 3 forward, 8 backward. bf16 io,
    forward: q k^T and p~ v bf16 x bf16, q Krelpos bf16 x fp32; backward:
    q k^T and g v^T bf16 x bf16; q Krelpos, p~^T g, dS k, dS^T q and
    dKrelpos's dQP^T q bf16 x fp32; dQP Krelpos fp32 x fp32."""
    per = 2 * dk * pairs
    if not bf16io:
        return [((8 if backward else 3) * per, TF32X3_FLOP_PER_S)]
    return [(2 * per, BF16_FLOP_PER_S),
            ((5 if backward else 1) * per, TF32X2_FLOP_PER_S),
            ((1 if backward else 0) * per, TF32X3_FLOP_PER_S)]


def check_bf16_attention(dev, gen) -> tuple:
    """The attention's bf16-io kernels (bf16 q, k, v, out, dq, dk, dv; fp32
    Krelpos and dKrelpos; q, k, v and g staged by TMA boxes of a bf16 map
    and widened in shared memory) against `attention_plain` on the same
    bf16 inputs at BF16_ATTENTION_SHAPES, dropout 0 and 0.1, forward and
    every gradient
    within FFN_BAND times the plain version's own fp32-vs-fp64 spread or
    the floor (`hold_bf16io`: its float64 side rounds p~ to bf16 for p~ . v
    as the plain version does, and the output and dq, dk, dv to bf16), each
    backward bit for bit across two calls. A backward that rounds p~ where
    it recomputes it fails this on dv
    (`scripts/plant_attention_pv_rounding.py` shows it on the card). Timed
    at the recipe and 0.1 by device time, split by launch (events beside),
    with the plain version and the module's torch route on the same bf16
    inputs (its shift trick, the port's default path). Then the wide
    kernels (dk in
    chunks), fp32 and bf16-io, timed at WIDE_ATTENTION_SHAPE against their
    plain versions and the module's torch route on the same inputs.
    Returns the kernel entries, the route's times, the events' times, the
    wide kernels' times and the recipe's device split by launch."""
    from cpc2_torch.models.transformer import ScaledDotProductAttention
    from cpc2_torch.ops import attention as att
    seed = torch.tensor([12345], device=dev, dtype=torch.int32)
    errs, ratios = [], []
    for i, (n, s, dk) in enumerate(BF16_ATTENTION_SHAPES):
        inputs, cot = attention_inputs(dev, gen, n, s, dk, torch.bfloat16)
        if i == 0:
            recipe = inputs, cot
        for rate in (0.0, 0.1):
            def kern(*a, rate=rate):
                return att.fused_relpos_attention(*a, seed, rate)

            def plain(*a, rate=rate):
                return att.attention_plain(*a, seed, rate)

            def wide(*a, rate=rate):
                return att._attention_f32(*a, seed, rate, True)
            held = hold_bf16io(f"attention bf16io {(n, s, dk)} rate {rate}",
                               ["out", "dq", "dk", "dv", "dkrel"], kern,
                               plain, wide, inputs, cot)
            errs.append(held[:2])
            ratios += held[2]
    inputs, cot = recipe
    n, s, dk = BF16_ATTENTION_SHAPES[0]

    def kern(*a):
        return att.fused_relpos_attention(*a, seed, 0.1)

    def plain(*a):
        return att.attention_plain(*a, seed, 0.1)
    out_k, grad_k, bwd_k = grads_of(kern, inputs, cot)
    _, _, bwd_p = grads_of(plain, inputs, cot)
    with torch.no_grad():
        fwd_split = device_split(lambda: kern(*inputs),
                                 expect="attention_fwd_mma")
        fwd_ms = sum(fwd_split.values())
        plain_fwd = device_ms(lambda: plain(*inputs))
        events = {"attention_fwd_bf16io": cuda_ms(lambda: kern(*inputs))}
    bwd_split = device_split(bwd_k, expect="attention_bwd_mma")
    bwd_ms = sum(bwd_split.values())
    plain_bwd = device_ms(bwd_p)
    events["attention_bwd_bf16io"] = cuda_ms(bwd_k)
    module = ScaledDotProductAttention(s, dk, 0.1, relpos=True).to(dev)
    with torch.no_grad():
        module.Krelpos.copy_(inputs[3])
    qkv = [t.detach().requires_grad_(True) for t in inputs[:3]]
    out_m = module(*qkv, gen)
    with torch.no_grad():
        yard = {"attention_fwd_bf16io": device_ms(
            lambda: module(*inputs[:3], gen))}
    yard["attention_bwd_bf16io"] = device_ms(lambda: torch.autograd.grad(
        out_m, qkv + [module.Krelpos], cot, retain_graph=True))
    log(f"  attention bf16io kernels vs plain at "
        f"{list(BF16_ATTENTION_SHAPES)}, rates 0 and 0.1, relative 2-norm: "
        f"at most {max(ratios):.2f} of the limit ({FFN_BAND} x the plain "
        f"version's own spread against float64 at the same rounding "
        f"points, or the floor); every backward bit for bit across two "
        f"calls")

    wide_times = {}
    plan = att.attention_plan(*WIDE_ATTENTION_SHAPE)
    if plan.chunks < 2:
        raise AssertionError(f"{WIDE_ATTENTION_SHAPE}: {plan.chunks} chunk")
    own = torch.Generator(device=dev)
    own.manual_seed(23)
    wn, ws, wdk = WIDE_ATTENTION_SHAPE
    pairs_w = wn * ws * (ws + 1) // 2
    for label, dtype in (("fp32", torch.float32), ("bf16io", torch.bfloat16)):
        w_in, w_cot = attention_inputs(dev, own, *WIDE_ATTENTION_SHAPE,
                                       dtype)
        o_k, g_k, b_k = grads_of(kern, w_in, w_cot)
        o_p, g_p, b_p = grads_of(plain, w_in, w_cot)
        if dtype == torch.float32:
            err = max(compare(f"attention wide {WIDE_ATTENTION_SHAPE} fwd",
                              o_k, o_p),
                      compare(f"attention wide {WIDE_ATTENTION_SHAPE} bwd",
                              g_k, g_p))
        else:
            err = hold_bf16io(
                f"attention wide bf16io {WIDE_ATTENTION_SHAPE}",
                ["out", "dq", "dk", "dv", "dkrel"], kern, plain,
                lambda *a: att._attention_f32(*a, seed, 0.1, True), w_in,
                w_cot)[1]
        w_mod = ScaledDotProductAttention(ws, wdk, 0.1, relpos=True).to(dev)
        with torch.no_grad():
            w_mod.Krelpos.copy_(w_in[3])
            f_ms = device_ms(lambda: kern(*w_in), expect="attention_fwd_wide")
            pf_ms = device_ms(lambda: plain(*w_in))
            route_f = device_ms(lambda: w_mod(*w_in[:3], gen))
        w_qkv = [t.detach().requires_grad_(True) for t in w_in[:3]]
        w_out = w_mod(*w_qkv, gen)
        route_b = device_ms(lambda: torch.autograd.grad(
            w_out, w_qkv + [w_mod.Krelpos], w_cot, retain_graph=True))
        io = dtype == torch.bfloat16
        for name, ms, pms, rms, n_bytes, flops in (
                ("fwd", f_ms, pf_ms, route_f,
                 nbytes(*w_in, seed) + nbytes(*o_k),
                 attention_ops(wdk, pairs_w, io, False)),
                ("bwd", device_ms(b_k, expect="attention_bwd_wide"),
                 device_ms(b_p), route_b, nbytes(*w_in, seed, *w_cot)
                 + nbytes(*g_k), attention_ops(wdk, pairs_w, io, True))):
            bound, by = bound_ms(n_bytes, flops)
            wide_times[f"attention_{name}_wide {label}"] = {
                "shape": list(WIDE_ATTENTION_SHAPE), "chunks": plan.chunks,
                "max_abs_err": err, "ms": ms, "plain_ms": pms,
                "route_ms": rms, "bound_ms": bound, "bound_by": by}
    pairs = n * s * (s + 1) // 2
    src = "cpc2_torch/csrc/attention.cuh"
    rep = "cpc2_tpu/ops/attention_pallas.py"
    return [kernel_entry("attention_fwd_bf16io", src, rep + ":159",
                         max(e[0] for e in errs), fwd_ms, plain_fwd, None,
                         nbytes(*inputs, seed) + nbytes(*out_k),
                         attention_ops(dk, pairs, True, False)),
            kernel_entry("attention_bwd_bf16io", src, rep + ":179",
                         max(e[1] for e in errs), bwd_ms, plain_bwd, None,
                         nbytes(*inputs, seed, *cot) + nbytes(*grad_k),
                         attention_ops(dk, pairs, True, True))], \
        yard, events, wide_times, {"attention_fwd_bf16io": fwd_split,
                                   "attention_bwd_bf16io": bwd_split}


def check_adam_bf16(dev) -> tuple:
    """The bf16-moment Adam kernel (`optim.adam_bf16_moment`) over the
    recipe's parameters (model and criterion at the CLI defaults, random
    gradients drawn from a generator of its own) against its plain version
    on copies of the same state over 3 steps: the stored bf16 moments and
    the second moments bit for bit (every operation an explicitly rounded
    fp32 one on both), the parameters within RTOL (the bias corrections'
    powers). Timed by device time (one update, the counts' increment
    excluded) beside its plain version and torch's fused Adam on the same
    parameters (another function: fp32 moments, `lerp`); the bound is the
    bytes (p, nu read and written, g read, mu read and written in bf16).
    Returns the kernel entry and torch's fused Adam's time."""
    from cpc2_torch.config import parse_args
    from cpc2_torch.feature_loader import build_model
    from cpc2_torch.optim import adam_bf16_moment, adam_bf16_plain
    from cpc2_torch.train import get_criterion
    args = parse_args(["--pathDB", ".", "--random_seed", "0"])
    torch.manual_seed(0)
    params = [p.detach() for p in list(build_model(args).to(dev).parameters())
              + list(get_criterion(args).to(dev).parameters())]
    own = torch.Generator(device=dev)
    own.manual_seed(29)
    sides = []
    for _ in range(2):
        sides.append({"p": [p.clone() for p in params],
                      "mu": [torch.zeros_like(p, dtype=torch.bfloat16)
                             for p in params],
                      "nu": [torch.zeros_like(p) for p in params],
                      "t": [torch.zeros((), device=dev) for _ in params]})
    lr, b1, b2, eps = args.learningRate, args.beta1, args.beta2, args.epsilon
    for _ in range(3):
        grads = [torch.randn(p.shape, device=dev, generator=own) * 1e-3
                 for p in params]
        for side, fn in zip(sides, (adam_bf16_moment, adam_bf16_plain)):
            torch._foreach_add_(side["t"], 1.0)
            fn(side["p"], grads, side["mu"], side["nu"], side["t"], lr, b1,
               b2, eps)
    kern_s, plain_s = sides
    for key in ("mu", "nu"):
        for i, (a, b) in enumerate(zip(kern_s[key], plain_s[key])):
            if not torch.equal(a, b):
                raise AssertionError(f"adam_bf16_moment {key}[{i}]: kernel "
                                     f"vs plain differ (max abs "
                                     f"{(a.double() - b.double()).abs().max().item():.3e})")
    err = compare("adam_bf16_moment parameters", kern_s["p"], plain_s["p"])
    s = kern_s
    ms = device_ms(lambda: adam_bf16_moment(s["p"], grads, s["mu"], s["nu"],
                                            s["t"], lr, b1, b2, eps),
                   expect="adam_bf16_moment")
    plain_ms = device_ms(lambda: adam_bf16_plain(
        plain_s["p"], grads, plain_s["mu"], plain_s["nu"], plain_s["t"], lr,
        b1, b2, eps), 5)
    fused = torch.optim.Adam([torch.nn.Parameter(p.clone()) for p in params],
                             lr=lr, capturable=True, fused=True)
    for p, g in zip(fused.param_groups[0]["params"], grads):
        p.grad = g
    fused.step()
    fused_ms = device_ms(fused.step)
    n = sum(p.numel() for p in params)
    return kernel_entry("adam_bf16_moment", "cpc2_torch/csrc/adam.cu",
                        "cpc2_tpu/training.py:56", err, ms, plain_ms, None,
                        24 * n, 15 * n), fused_ms


def check_bf16_kernels(dev) -> dict:
    """Phase 11's kernel checks (`check_bf16_ffn`, `check_bf16_attention`,
    `check_adam_bf16`), each drawing from one generator; `run_bf16` runs
    it in a fresh process (`fresh`)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    with fused_switches(False):
        ffn, ffn_yard, ffn_events, ffn_splits = check_bf16_ffn(dev, gen)
        att, att_yard, att_events, wide, att_splits = check_bf16_attention(
            dev, gen)
        adam, fused_adam_ms = check_adam_bf16(dev)
    return {"kernels": ffn + att + [adam],
            "route_ms": dict(ffn_yard, **att_yard, fused_adam=fused_adam_ms),
            "events_ms": dict(ffn_events, **att_events),
            "attention_wide": wide, "splits": dict(ffn_splits, **att_splits)}


def run_bf16_epochs(dev, work: str) -> dict:
    """One CLI epoch a setup of BF16_EPOCHS on the FLAC corpus
    (`run_training`), each one's launches held exactly to its steps times
    `bf16_launches` (none of the fp32-io FFN kernels); `bf16_dispatch`
    (N = 4, the pack on the device) held bit for bit to `bf16_mu` (N = 1,
    host batches) by `hold_dispatch_epochs`."""
    records = {}
    for mode, (flags, fused) in BF16_EPOCHS.items():
        rec = records[mode] = run_training(dev, work, mode)
        mu = "--adam_mu_dtype" in flags
        want = {}
        for train, n in ((True, len(rec["step_ms"])),
                         (False, rec["val_steps"])):
            for k, per in bf16_launches(train, fused, mu).items():
                want[k] = want.get(k, 0) + n * per
        held_launches(f"[bf16 epoch {mode}]", {k: n for k, n in
                                               rec["launches"].items() if n},
                      want)
    records["held"] = hold_dispatch_epochs(records["bf16_dispatch"],
                                           records["bf16_mu"],
                                           "bf16_dispatch")
    return records


def run_resume_bf16(work: str) -> dict:
    """`--precision bf16 --adam_mu_dtype bf16`: two epochs from scratch
    against the `bf16_mu` epoch's directory resumed to two, every tensor
    of the two `checkpoint_1.pt` bit for bit (Adam's bf16 exp_avg among
    them, saved as bf16)."""
    import shutil

    from cpc2_torch.train import main
    whole = os.path.join(work, "ck_whole_bf16")
    split = os.path.join(work, "ck_split_bf16")
    shutil.copytree(os.path.join(work, "ck_bf16_mu"), split)
    main(train_argv(work, whole, "--nEpoch", "2", *BF16_MU_FLAGS))
    main(["--pathCheckpoint", split, "--nEpoch", "2"])
    diffs = diff_checkpoints(os.path.join(whole, "checkpoint_1.pt"),
                             os.path.join(split, "checkpoint_1.pt"))
    saved = torch.load(os.path.join(split, "checkpoint_1.pt"),
                       weights_only=True)
    dtypes = {s["exp_avg"].dtype for s in saved["optimizer"]["state"].values()}
    if dtypes != {torch.bfloat16}:
        raise AssertionError(f"[resume bf16] exp_avg saved as {dtypes}")
    if diffs:
        raise AssertionError(f"[resume bf16] resumed vs uninterrupted differ "
                             f"(max abs, relative 2-norm): "
                             f"{dict(list(diffs.items())[:8])}")
    return {"bit_for_bit": True, "tensors": len(_flat(saved))}


def run_bf16(dev, work: str, card: str, default: dict) -> dict:
    """Phase 11: `[bf16 kernels]` (the FFN's and the attention's bf16-io
    kernels, the wide attention kernels, the bf16-moment Adam), `[bf16
    step]` (one step at the recipe card against CPU under `--precision
    bf16`, plain and with both opt-in kernels, launches held),
    `[bf16 dispatch]` (3 groups of N = 4 with a bf16-moment Adam replayed
    against eager steps, bit for bit), `[bf16 epochs]` (BF16_EPOCHS beside
    the default epoch, `default`) and `[resume bf16]`."""
    start = time.perf_counter()
    out = fresh(work, "check_bf16_kernels", "bf16 kernels")
    wide, fused_adam_ms = out["attention_wide"], out["route_ms"]["fused_adam"]
    log(f"[bf16 kernels] {time.perf_counter() - start:.1f} s, {card} (a "
        f"fresh process): "
        + "; ".join(
            f"{k['name']} err {k['max_abs_err']:.2e}, {k['ms']:.4f} ms, "
            f"plain {k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']})" + (
                f", route {out['route_ms'][k['name']]:.4f} ms"
                if k["name"] in out["route_ms"] else
                f", torch's fused Adam (fp32 moments) {fused_adam_ms:.4f} ms")
            + (f", events {out['events_ms'][k['name']]:.4f} ms"
               if k["name"] in out["events_ms"] else "")
            for k in out["kernels"])
        + "; wide attention: " + "; ".join(
            f"{name} at {tuple(r['shape'])} ({r['chunks']} chunks of dk) "
            f"err {r['max_abs_err']:.2e}, {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, torch route {r['route_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms"
            for name, r in wide.items()))
    splits = out["splits"]
    log(f"[bf16 kernels] at the recipe, device ms a call by launch "
        f"(route beside, {card}): " + "; ".join(
            f"{name}: {split_line(splits[name])} (sum "
            f"{sum(splits[name].values()):.4f}, route "
            f"{out['route_ms'][name]:.4f})"
            for name in BF16_IO_FFN + BF16_IO_ATTENTION)
        + f"; split-block clusters the card holds at once: "
        f"{splits['clusters']}")
    steps = out["steps"] = {}
    for fused in (False, True):
        start = time.perf_counter()
        name = "bf16 fused" if fused else "bf16"
        with fused_switches(fused):
            err, launches, ms = check_variant_step(
                dev, name, BF16_FLAGS, "bf16",
                want=bf16_launches(True, fused, False))
        steps[name] = {"max_abs_err": err, "launches": launches, "ms": ms}
        log(f"[bf16 step {name}] card vs cpu at the recipe, max abs err "
            f"{err:.2e}, {time.perf_counter() - start:.1f} s, card step "
            f"{ms:.3f} ms (events, {card}), launches {launches}")
    start = time.perf_counter()
    corpus_d, offsets_d = dispatch_corpus(dev)
    r = out["dispatch"] = check_dispatch_setup(
        dev, ("bf16", "bf16", False, 256, False), corpus_d, offsets_d,
        flags=BF16_MU_FLAGS)
    del corpus_d
    if not r["bit_for_bit"]:
        raise AssertionError(f"[bf16 dispatch] replay vs eager differ: "
                             f"{r['differing']}")
    log(f"[bf16 dispatch] {time.perf_counter() - start:.1f} s, {card}: "
        f"{' '.join(BF16_MU_FLAGS)}, 3 groups of {DISPATCH_N} steps as graph "
        f"replays ({r['captures']} captures) vs {3 * DISPATCH_N} eager "
        f"steps: bit for bit ({r['tensors']} tensors: losses, parameters, "
        f"Adam's bf16 and fp32 moments and counts, both generators); "
        f"launches a replay {r['launches_per_replay']}; peak memory "
        f"{r['peak_bytes_graph']} bytes with the graph, "
        f"{r['peak_bytes_eager']} eager")
    start = time.perf_counter()
    records = run_bf16_epochs(dev, work)
    epochs = {mode: records[mode] for mode in BF16_EPOCHS}
    out["epochs"] = {mode: {"steps": len(rec["step_ms"]),
                            "val_steps": rec["val_steps"],
                            "median_step_ms": rec["median_step_ms"],
                            "peak_above_live_bytes": rec[
                                "peak_above_live_bytes"],
                            "launches": rec["launches"]}
                     for mode, rec in epochs.items()}
    log(f"[bf16 epochs] {time.perf_counter() - start:.1f} s, {card}: median "
        f"ms/step, peak memory above what was live before the run: default "
        f"{default['median_step_ms']:.3f} ms, "
        f"{default['peak_above_live_bytes']} bytes; " + "; ".join(
            f"{mode} ({' '.join(BF16_EPOCHS[mode][0])}"
            f"{' CPC2_FUSED_ATTENTION=1 CPC2_FUSED_ENCODER=1' if BF16_EPOCHS[mode][1] else ''}, "
            f"{len(rec['step_ms'])} + {rec['val_steps']} steps) "
            f"{rec['median_step_ms']:.3f} ms, {rec['peak_above_live_bytes']} "
            f"bytes, launches { {k: n for k, n in rec['launches'].items() if n}}"
            for mode, rec in epochs.items())
        + "; every launch count held exactly; bf16_dispatch vs bf16_mu "
        "epoch means bit for bit")
    start = time.perf_counter()
    out["resume"] = run_resume_bf16(work)
    log(f"[resume bf16] {time.perf_counter() - start:.1f} s: "
        f"{' '.join(BF16_MU_FLAGS)}, checkpoint_1.pt of 2 epochs vs 1 + a "
        f"resume to 2: bit for bit ({out['resume']['tensors']} tensors, "
        f"exp_avg saved as bf16)")
    out["records"] = records
    return out


# ---------------------------------------------------------------------------
# Phase 12: grouped negative pools (`--neg_pool_group`)
# ---------------------------------------------------------------------------

# (B, K, W, N, D, P, G): batch 64 in groups of 8 at the recipe's widths (the
# reference's 8-GPU DataParallel recipe on one card), and an odd shape
# whose groups' 60 pool rows are not a multiple of its 64-row dz tile
NEG_POOL_SHAPES = ((64, 12, 116, 128, 256, 8192, 8),
                   (6, 5, 9, 20, 36, 120, 3))
NEG_POOL_FLAGS = ["--batchSizeGPU", "64", "--neg_pool_group", "8"]
# the step card against CPU: batch 16, two groups of 8
NEG_POOL_STEP_FLAGS = ["--batchSizeGPU", "16", "--neg_pool_group", "8"]
GROUPED = ("infonce_fwd_grouped", "infonce_bwd_grouped")
# the batch-64 epoch's corpus (WAV): 4 speakers x 4 files x 90 s; of the 16
# files 15 train (a speaker's 270-360 s make 3-4 batches of 64 and a
# short one) and 1 validates (70 windows: one batch of 64 and one of 6)
NEG_POOL_DB = "neg_pool_db"


def group_local(gen, b, p, w, n, group, dev):
    """(B, W, N) int32 rows of a pool of p, element b's in its group's
    rows; every other sample one of the group's first 16 rows, so that
    rows repeat within a unit and across units."""
    rows = p // (b // group)
    base = (torch.arange(b, device=dev, dtype=torch.int32) // group
            * rows)[:, None, None]
    r = torch.randint(0, rows, (b, w, n), device=dev, generator=gen,
                      dtype=torch.int32)
    r[..., ::2] %= 16
    return base + r


@contextlib.contextmanager
def fixed_draw(neg, group):
    """The CPC criterion's own draw (`sample_negative_indices`) returns
    `neg` (B, N, W) on the draw's device, after checking that it was asked
    for pools of `group`: a step with fixed negatives that still takes the
    route of indices the criterion drew."""
    from cpc2_torch.losses import criterion
    real = criterion.sample_negative_indices

    def draw(generator, b, s, n, w, device, pool_group=None,
             pool_batch=None):
        if pool_group != group or pool_batch is not None:
            raise AssertionError(f"the criterion drew pools of {pool_group}"
                                 f", not {group}")
        return neg.to(device)
    criterion.sample_negative_indices = draw
    try:
        yield
    finally:
        criterion.sample_negative_indices = real


def kernel_counts(fn, expect: str, iters: int = 20) -> tuple:
    """(device ms a call by kernel, kernels of each name a call) of `fn`
    (`time_kernels.device_split` with counts, `expect` in a kernel's
    name), or the events' time and no counts where the profiler lost the
    kernels."""
    from cpc2_torch.time_kernels import ProfilerLostKernels
    from cpc2_torch.time_kernels import device_split as split
    try:
        ms, counts = split(fn, iters, 3, counts=True, expect=expect)
    except ProfilerLostKernels as lost:
        ms = cuda_ms(fn, iters, 0)
        log(f"[profiler] {lost}: timed by CUDA events instead, {ms:.4f} ms "
            f"a call (the host's path included)")
        return {EVENTS_KEY: ms}, {}
    return ms, {k: c / iters for k, c in counts.items()}


def one_launch_each(what: str, counts: dict, names) -> None:
    """Each kernel of `names` once a call in `counts` (a kernel name holds
    the fragment), whatever the number of groups."""
    if not counts:
        return
    for name in names:
        n = sum(c for k, c in counts.items() if name in k)
        if n != 1:
            raise AssertionError(f"{what}: {n} {name} launches a call")


def check_neg_pool_kernels(dev) -> dict:
    """The InfoNCE kernels on grouped pools at NEG_POOL_SHAPES: forward,
    dpreds and dz against `negative_scores_plain` (ATOL + RTOL of the
    largest), dz bit for bit across two calls, one call counted once under
    GROUPED. At batch 64, on the trainer's own grouped draws
    (`sample_negative_indices(pool_group=8)`): the whole pool's plan held
    against the grouped one on the same indices (the forward, the same
    kernel and plan, bit for bit), each kernel's launches a call from the
    profile (one forward, one backward and one sum, whatever the groups),
    and device times: the grouped forward and backward (by kernel), the
    whole pool's backward, the plain version, the library route
    (`infonce_route`, full fp32), and batch 8's kernels at the recipe on
    the same card; the bound as `check_infonce` reckons it. Returns the
    grouped kernels' entries and those figures."""
    from cpc2_torch.losses import sample_negative_indices
    from cpc2_torch.ops import _build
    from cpc2_torch.ops.infonce import (infonce_plan, negative_scores,
                                        negative_scores_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err_f = err_b = 0.0
    plans = {}
    for b, k, w, n, d, p, g in NEG_POOL_SHAPES:
        plan = infonce_plan(b, k, w, n, d + (-d) % 4, p, sms, group=g)
        plans[str((b, k, w, n, d, p, g))] = plan._asdict()
        log(f"  [neg pool] plan at {(b, k, w, n, d, p, g)}: "
            f"{p // plan.group_rows} groups of {plan.group_rows} rows in "
            f"{plan.group_tiles} tiles of {plan.pt}, {plan.splits} splits "
            f"of a group's {plan.group_units} units (at most "
            f"{-(-plan.group_units // plan.splits)} a dz CTA)")
        inputs = [torch.randn(b, k, w, d, device=dev, generator=gen),
                  torch.randn(p, d, device=dev, generator=gen)]
        idx = group_local(gen, b, p, w, n, g, dev)
        cot = [torch.randn(b, k, w, n, device=dev, generator=gen)]
        what = f"infonce grouped {(b, k, w, n, d, p, g)}"
        _build.reset_launches()
        out_k, grad_k, bwd_k = grads_of(
            lambda a, z, idx=idx, g=g: negative_scores(a, z, idx, group=g),
            inputs, cot)
        launched = {name: c for name, c in _build.LAUNCHES.items() if c}
        if launched != {GROUPED[0]: 1, GROUPED[1]: 1}:
            raise AssertionError(f"{what}: launches {launched}")
        out_p, grad_p, _ = grads_of(
            lambda a, z, idx=idx: negative_scores_plain(a, z, idx), inputs,
            cot)
        err_f = max(err_f, compare(what + " forward", out_k, out_p))
        err_b = max(err_b, compare(what + " backward", grad_k, grad_p))
        if not all(torch.equal(a, c) for a, c in zip(bwd_k(), grad_k)):
            raise AssertionError(what + " backward: two calls differ")

    b, k, w, n, d, p, g = NEG_POOL_SHAPES[0]
    inputs = [torch.randn(b, k, w, d, device=dev, generator=gen),
              torch.randn(p, d, device=dev, generator=gen)]
    idx = sample_negative_indices(gen, b, p // b, n, w, dev,
                                  pool_group=g).transpose(1, 2).contiguous()
    cot = [torch.randn(b, k, w, n, device=dev, generator=gen)]

    def grouped(preds, z):
        return negative_scores(preds, z, idx, group=g)

    def whole(preds, z):
        return negative_scores(preds, z, idx)

    def plain(preds, z):
        return negative_scores_plain(preds, z, idx)
    out_g, grad_g, bwd_g = grads_of(grouped, inputs, cot)
    out_w, grad_w, bwd_w = grads_of(whole, inputs, cot)
    out_p, grad_p, bwd_p = grads_of(plain, inputs, cot)
    err_f = max(err_f, compare("infonce grouped drawn forward", out_g,
                               out_p))
    err_b = max(err_b, compare("infonce grouped drawn backward", grad_g,
                               grad_p))
    compare("infonce whole pool vs grouped, backward", grad_w, grad_g)
    if not torch.equal(out_w[0], out_g[0]) or not torch.equal(grad_w[0],
                                                                grad_g[0]):
        raise AssertionError("infonce whole pool vs grouped: the forward or "
                             "dpreds differ (the same kernels and plans)")
    whole_vs_grouped = (grad_w[1] - grad_g[1]).abs().max().item()
    with torch.no_grad():
        fwd_split, fwd_counts = kernel_counts(lambda: grouped(*inputs),
                                              "gathered_fwd")
        plain_fwd = device_ms(lambda: plain(*inputs))
        route_fwd = device_ms(lambda: infonce_route(*inputs, idx))
        events = {GROUPED[0]: cuda_ms(lambda: grouped(*inputs))}
        route_out = infonce_route(*inputs, idx)

        def route_bwd():
            return infonce_route_bwd(cot[0], *inputs, idx)
        route_bwd_ms = device_ms(route_bwd)
        route_grad = route_bwd()
    compare("infonce grouped route forward", [route_out], out_g)
    compare("infonce grouped route backward", route_grad, grad_g)
    bwd_split, bwd_counts = kernel_counts(bwd_g, "dz_sum")
    whole_split, whole_counts = kernel_counts(bwd_w, "dz_sum")
    for what, counts, names in (("grouped forward", fwd_counts,
                                 ["gathered_fwd"]),
                                ("grouped backward", bwd_counts,
                                 ["gathered_bwd", "dz_sum"]),
                                ("whole-pool backward", whole_counts,
                                 ["gathered_bwd", "dz_sum"])):
        one_launch_each(f"infonce {what} at batch {b}", counts, names)
    plain_bwd = device_ms(bwd_p)
    events[GROUPED[1]] = cuda_ms(bwd_g)

    # batch 8's kernels at the recipe, re-read on this card
    b8, k8, w8, n8, d8, p8 = INFONCE_SHAPES[0]
    in8 = [torch.randn(b8, k8, w8, d8, device=dev, generator=gen),
           torch.randn(p8, d8, device=dev, generator=gen)]
    idx8 = sample_negative_indices(gen, b8, p8 // b8, n8, w8, dev).transpose(
        1, 2).contiguous()
    cot8 = [torch.randn(b8, k8, w8, n8, device=dev, generator=gen)]
    _, _, bwd8 = grads_of(lambda a, z: negative_scores(a, z, idx8), in8,
                          cot8)
    with torch.no_grad():
        fwd8 = device_ms(lambda: negative_scores(*in8, idx8),
                         expect="gathered_fwd")
    bwd8_split = device_split(bwd8, expect="dz_sum")

    dots = 2 * b * k * w * n * d
    src, rep = "cpc2_torch/csrc/infonce.cu", "cpc2_tpu/ops/infonce_pallas.py"
    entries = [
        kernel_entry(GROUPED[0], src, rep + ":107", err_f,
                     sum(fwd_split.values()), plain_fwd, None,
                     nbytes(*inputs, idx) + nbytes(*out_g), dots,
                     TF32X3_FLOP_PER_S),
        kernel_entry(GROUPED[1], src, rep + ":170", err_b,
                     sum(bwd_split.values()), plain_bwd, None,
                     nbytes(*cot, *inputs, idx) + nbytes(*grad_g), dots)]
    return {"kernels": entries, "plans": plans,
            "route_ms": {GROUPED[0]: route_fwd, GROUPED[1]: route_bwd_ms},
            "events_ms": events, "grouped_fwd_split": fwd_split,
            "grouped_bwd_split": bwd_split, "whole_pool_bwd_split":
            whole_split, "whole_pool_bwd_ms": sum(whole_split.values()),
            "kernels_a_call": {"grouped_fwd": fwd_counts,
                               "grouped_bwd": bwd_counts,
                               "whole_pool_bwd": whole_counts},
            "dz_whole_vs_grouped_max_abs": whole_vs_grouped,
            "batch8_fwd_ms": fwd8, "batch8_bwd_ms": sum(bwd8_split.values()),
            "batch8_bwd_split": bwd8_split}


def neg_pool_launches(b: int, train: bool) -> dict:
    """One step's launches at batch b with NEG_POOL_FLAGS: the default
    step's (`variant_launches`), InfoNCE's under GROUPED where 8 divides a
    batch above 8 (the criterion's rule), else the whole pool's."""
    out = variant_launches([], train)
    if b > 8 and b % 8 == 0:
        for name in ("infonce_fwd", "infonce_bwd"):
            if name in out:
                out[name + "_grouped"] = out.pop(name)
    return out


def run_neg_pool_epoch(dev, work: str) -> dict:
    """One epoch of `python -m cpc2_torch.train` with NEG_POOL_FLAGS on
    NEG_POOL_DB, each criterion call's batch recorded: every kernel's
    launches held exactly to `neg_pool_launches` over the training and
    validation steps, at least 10 training steps of 64 in groups, the
    losses finite, the checkpoint written."""
    from cpc2_torch.losses import criterion
    from cpc2_torch.ops import _build
    from cpc2_torch.train import main
    calls = []
    forward = criterion.CPCUnsupervisedCriterion.forward

    def spy(self, c_feature, *args, **kwargs):
        calls.append((c_feature.shape[0], self.training))
        return forward(self, c_feature, *args, **kwargs)
    ck = os.path.join(work, "ck_neg_pool")
    live = torch.cuda.memory_allocated(dev)
    criterion.CPCUnsupervisedCriterion.forward = spy
    try:
        _build.reset_launches()
        record = main(train_argv(work, ck, "--file_extension", ".wav",
                                 *NEG_POOL_FLAGS, db=NEG_POOL_DB))
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    finally:
        criterion.CPCUnsupervisedCriterion.forward = forward
    record["peak_above_live_bytes"] = record["peak_memory_bytes"] - live
    n_train = len(record["step_ms"])
    if [t for _b, t in calls].count(True) != n_train or \
            len(calls) != n_train + record["val_steps"]:
        raise AssertionError(f"[neg pool epoch] {len(calls)} criterion "
                             f"calls for {n_train} + {record['val_steps']} "
                             f"steps")
    want = {}
    for b, train in calls:
        for k, per in neg_pool_launches(b, train).items():
            want[k] = want.get(k, 0) + per
    held_launches(f"[neg pool epoch] ({n_train} + {record['val_steps']} "
                  f"steps)", launches, want)
    full = sum(1 for b, t in calls if t and b == 64)
    if full < 10:
        raise AssertionError(f"[neg pool epoch] {full} training steps of "
                             f"64, not 10 or more")
    for key in ("locLoss_train", "locAcc_train", "locLoss_val"):
        values = np.asarray(record["logs"][key], dtype=np.float64)
        if values.shape != (1, 12) or not np.isfinite(values).all():
            raise AssertionError(f"[neg pool epoch] {key}: {values}")
    if not os.path.exists(os.path.join(ck, "checkpoint_0.pt")):
        raise AssertionError("[neg pool epoch] no checkpoint_0.pt")
    record["launches"] = {k: launches.get(k, 0) for k in _build.KERNELS}
    record["batches"] = calls
    return record


def run_neg_pool(dev, work: str, card: str, default: dict) -> dict:
    """Phase 12: `[neg pool kernels]` (`check_neg_pool_kernels`, in a fresh
    process), `[neg pool step]` (one step at batch 16 in groups of 8 at the
    recipe's widths, card against CPU on the same fixed group-local
    negatives, drawn by the criterion (`fixed_draw`), in the `bf16mix`
    band, launches held), `[neg pool epoch]` (`run_neg_pool_epoch` beside
    batch 8's default epoch, `default`) and `[neg pool dispatch]` (3
    groups of N = 4 at batch 64 replayed against eager steps, bit for
    bit)."""
    start = time.perf_counter()
    out = fresh(work, "check_neg_pool_kernels", "neg pool kernels")
    split = out["grouped_bwd_split"]
    log(f"[neg pool kernels] {time.perf_counter() - start:.1f} s, {card} (a "
        f"fresh process): " + "; ".join(
            f"{k['name']} err {k['max_abs_err']:.2e}, {k['ms']:.4f} ms, "
            f"plain {k['plain_ms']:.4f} ms, library route "
            f"{out['route_ms'][k['name']]:.4f} ms, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}), events "
            f"{out['events_ms'][k['name']]:.4f} ms" for k in out["kernels"])
        + f"; at batch 64 the grouped backward by kernel "
        + ", ".join(f"{n[:30]} {v:.4f}" for n, v in split.items())
        + f", the whole pool's plan {out['whole_pool_bwd_ms']:.4f} ms ("
        + ", ".join(f"{n[:30]} {v:.4f}" for n, v in
                    out["whole_pool_bwd_split"].items())
        + f"), its dz {out['dz_whole_vs_grouped_max_abs']:.2e} from the "
        f"grouped one; kernels a call {out['kernels_a_call']}; batch 8 at "
        f"the recipe {out['batch8_fwd_ms']:.4f} / "
        f"{out['batch8_bwd_ms']:.4f} ms")
    start = time.perf_counter()
    rs = np.random.RandomState(4)
    b, w, n = 16, 128 - 12, 128
    base = (np.arange(b) // 8 * 8 * 128)[:, None, None]
    draw = torch.from_numpy(
        (base + rs.randint(0, 8 * 128, (b, n, w))).astype(np.int32))
    want = neg_pool_launches(b, True)
    err, launches, ms = check_variant_step(dev, "neg pool group",
                                           NEG_POOL_STEP_FLAGS, "bf16mix",
                                           want=want, draw=draw)
    out["step"] = {"max_abs_err": err, "launches": launches, "ms": ms}
    log(f"[neg pool step] card vs cpu at batch 16 in groups of 8, the "
        f"recipe's widths, bf16mix, max abs err {err:.2e}, "
        f"{time.perf_counter() - start:.1f} s, card step {ms:.3f} ms "
        f"(events, {card}), launches {launches}")
    start = time.perf_counter()
    write_corpus(os.path.join(work, NEG_POOL_DB), ext=".wav", n_files=4,
                 seconds=90.0, seed=12)
    rec = run_neg_pool_epoch(dev, work)
    out["epoch"] = {key: rec[key] for key in (
        "median_step_ms", "audio_hours_per_hour", "peak_memory_bytes",
        "peak_above_live_bytes", "val_steps", "launches", "batches")}
    out["epoch"]["steps"] = len(rec["step_ms"])
    log(f"[neg pool epoch] {time.perf_counter() - start:.1f} s, {card}: "
        f"{' '.join(NEG_POOL_FLAGS)} on {NEG_POOL_DB} (WAV, 4 x 4 files x "
        f"90 s), {len(rec['step_ms'])} + {rec['val_steps']} steps, batches "
        f"{[b for b, _t in rec['batches']]}: median "
        f"{rec['median_step_ms']:.3f} ms/step, "
        f"{rec['audio_hours_per_hour']:.1f} audio-hours per hour, peak "
        f"memory {rec['peak_memory_bytes']} bytes "
        f"({rec['peak_above_live_bytes']} above what was live); batch 8's "
        f"default epoch {default['median_step_ms']:.3f} ms/step, "
        f"{default['audio_hours_per_hour']:.1f} audio-hours per hour, "
        f"{default['peak_memory_bytes']} bytes; launches held exactly "
        f"{ {k: v for k, v in rec['launches'].items() if v} }")
    start = time.perf_counter()
    corpus_d, offsets_d = dispatch_corpus(dev, batch=64)
    r = out["dispatch"] = check_dispatch_setup(
        dev, ("neg_pool", "bf16mix", False, 256, False), corpus_d, offsets_d,
        flags=NEG_POOL_FLAGS)
    del corpus_d
    if not r["bit_for_bit"]:
        raise AssertionError(f"[neg pool dispatch] replay vs eager differ: "
                             f"{r['differing']}")
    log(f"[neg pool dispatch] {time.perf_counter() - start:.1f} s, {card}: "
        f"{' '.join(NEG_POOL_FLAGS)}, 3 groups of {DISPATCH_N} steps as "
        f"graph replays ({r['captures']} captures) vs {3 * DISPATCH_N} "
        f"eager steps: bit for bit ({r['tensors']} tensors); launches a "
        f"replay {r['launches_per_replay']}; a group "
        + ", ".join(f"{t:.3f}" for t in r["group_ms_graph"])
        + " ms replayed, " + ", ".join(f"{t:.3f}" for t in
                                       r["group_ms_eager"])
        + f" ms eager; peak memory {r['peak_bytes_graph']} bytes with the "
        f"graph, {r['peak_bytes_eager']} eager")
    return out


# ---------------------------------------------------------------------------
# Phase 13: what feature extraction lacked (`FeatureModule(train_mode=)`, the
# CCA projection and its fit, `build_feature_files(bucket_frames=)`) and the
# research clustering criteria
# ---------------------------------------------------------------------------

# The recipe's widths with the transformer context network: 8 windows of
# 20,480 samples, 128 frames of 256 channels, 8 heads of 32, dropout 0.1.
EXTRAS_BATCH, EXTRAS_WINDOW, EXTRAS_WIDTH = 8, 20480, 256
TRAIN_MODE_SEED = 5
# The CCA's components, and its card-vs-CPU tolerance: both fit the same
# float64 matrices, so only another SVD and summation order part them; each
# field is held to CCA_TOL of its largest entry.
CCA_COMPONENTS = 32
CCA_TOL = 1e-6
# Ragged files of 2 to 4 seconds, and the buckets (frames) they share.
BUCKET_FILES, BUCKET_FRAMES = 12, 50
# Features card against CPU: fp32 in another order through the LSTM, as
# `[concat]` holds them.
EXTRAS_CPU_RTOL = 1e-3


class CallSpy:
    """In place of `module.<name>` inside a `with` block: keeps each call's
    arguments (the positional ones, then the keywords' values) and output,
    cloned, and returns the real call's output."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls, self.real = module, name, [], None

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)

    def __call__(self, *args, **kwargs):
        out = self.real(*args, **kwargs)
        self.calls.append((tuple(a.detach().clone() if torch.is_tensor(a)
                                 else a for a in args + tuple(
                                     kwargs.values())),
                           out.detach().clone()))
        return out


def set_dropout_rate(model, rate: float) -> None:
    from cpc2_torch.models.transformer import FFNetwork
    for m in model.modules():
        if isinstance(m, FFNetwork):
            m.dropout = rate
        if hasattr(m, "drop"):
            m.drop.rate = rate


def check_train_mode(dev) -> dict:
    """`FeatureModule(train_mode=True)` on a transformer-context model at the
    recipe's widths (random weights from a seed), with the plain attention
    and with the opt-in kernels on (the encoder's declines in `full_fp32`):
    two calls differ, a second instance of
    the same seed replays the first bit for bit, both differ from
    evaluation's features; every FFN (and fused attention) forward of the
    two calls, with its dropout seed, held against `ffn_plain`
    (`attention_plain`) on the same inputs; the kernels launched in those
    calls (counts set to 0 just before, read just after); at rate 0 the
    features equal evaluation's bit for bit; no parameter, buffer or
    module mode changed."""
    from cpc2_torch import feature_loader as fl
    from cpc2_torch.config import get_default_cpc_config
    from cpc2_torch.models import transformer
    from cpc2_torch.ops import _build
    from cpc2_torch.ops.attention import attention_plain
    from cpc2_torch.ops.ffn import ffn_plain

    args = get_default_cpc_config()
    args.arMode = "transformer"
    args.hiddenEncoder = args.hiddenGar = EXTRAS_WIDTH
    args.sizeWindow = EXTRAS_WINDOW
    torch.manual_seed(13)
    model = fl.build_model(args).to(dev).eval()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    modes = [m.training for m in model.modules()]
    rs = np.random.RandomState(13)
    data = ((0.1 * rs.randn(EXTRAS_BATCH, EXTRAS_WINDOW)).astype(np.float32),
            None)
    out = {"routes": {}}
    for fused in (False, True):
        route = "fused attention" if fused else "plain attention"
        with fused_switches(fused):
            evaluated = fl.FeatureModule(model, False)(data)
            maker = fl.FeatureModule(model, False, train_mode=True,
                                     train_mode_seed=TRAIN_MODE_SEED)
            with CallSpy(transformer, "fused_ffn") as ffn_spy, \
                    CallSpy(transformer, "fused_relpos_attention") as att_spy:
                torch.cuda.synchronize()
                _build.reset_launches()
                start = time.perf_counter()
                first, second = maker(data), maker(data)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - start
                launches = {k: v for k, v in _build.LAUNCHES.items() if v}
            replay = fl.FeatureModule(model, False, train_mode=True,
                                      train_mode_seed=TRAIN_MODE_SEED)(data)
            want = (EXTRAS_BATCH, EXTRAS_WINDOW // 160, EXTRAS_WIDTH)
            if tuple(first.shape) != want or not torch.isfinite(first).all():
                raise AssertionError(f"[train_mode {route}] features "
                                     f"{tuple(first.shape)}, want {want}")
            if torch.equal(first, second):
                raise AssertionError(f"[train_mode {route}] two calls drew "
                                     f"the same masks")
            if not torch.equal(first, replay):
                raise AssertionError(f"[train_mode {route}] the same seed "
                                     f"did not replay the first call")
            if torch.allclose(first, evaluated):
                raise AssertionError(f"[train_mode {route}] the dropout "
                                     f"left the features as evaluation's")
            ffn_err = 0.0
            for (x, w1, b1, w2, b2, seed, rate, bf16), y in ffn_spy.calls:
                if rate != 0.1 or bf16:
                    raise AssertionError(f"[train_mode {route}] an FFN call "
                                         f"at rate {rate}, bf16 {bf16}")
                ffn_err = max(ffn_err, compare(
                    f"train_mode FFN {tuple(x.shape)}", [y],
                    [ffn_plain(x, w1, b1, w2, b2, seed, rate)]))
            att_err = 0.0
            for (q, k, v, krelpos, seed, rate), y in att_spy.calls:
                att_err = max(att_err, compare(
                    f"train_mode attention {tuple(q.shape)}", [y],
                    [attention_plain(q, k, v, krelpos, seed, rate)]))
            if not ffn_spy.calls or launches.get("ffn_fwd_fp32", 0) == 0:
                raise AssertionError(f"[train_mode {route}] the fp32 FFN "
                                     f"kernel did not run: {launches}")
            if fused != bool(att_spy.calls) or fused != bool(
                    launches.get("attention_fwd", 0)):
                raise AssertionError(f"[train_mode {route}] attention "
                                     f"kernel launches {launches}")
            set_dropout_rate(model, 0.0)
            try:
                rate0 = fl.FeatureModule(model, False, train_mode=True)(data)
                eval0 = fl.FeatureModule(model, False)(data)
            finally:
                set_dropout_rate(model, 0.1)
            if not torch.equal(rate0, eval0):
                raise AssertionError(f"[train_mode {route}] at rate 0 the "
                                     f"features differ from evaluation's")
            out["routes"][route] = {
                "ffn_calls": len(ffn_spy.calls),
                "attention_calls": len(att_spy.calls),
                "ffn_max_abs_err": ffn_err, "attention_max_abs_err": att_err,
                "two_calls_ms": 1e3 * seconds, "launches": launches,
                "mean_abs_change_vs_eval": (first - evaluated).abs().mean()
                .item()}
    after = model.state_dict()
    changed = [k for k, v in state.items() if not torch.equal(after[k], v)]
    if changed or [m.training for m in model.modules()] != modes:
        raise AssertionError(f"[train_mode] the model changed: {changed}")
    out["tensors_unchanged"] = len(state)
    return out


def seeded_checkpoint(work: str, checkpoint: str, seed: int) -> str:
    """A checkpoint of `checkpoint`'s flags with random weights from
    `seed`, in a run directory of its own."""
    import shutil
    from cpc2_torch.feature_loader import build_model
    from cpc2_torch.io.checkpoint import get_checkpoint_data, save_checkpoint
    src = os.path.dirname(checkpoint)
    dst = os.path.join(work, f"ck_seed{seed}")
    os.makedirs(dst)
    for name in ("checkpoint_args.json", "checkpoint_logs.json"):
        shutil.copy(os.path.join(src, name), dst)
    args = get_checkpoint_data(src)[2]
    torch.manual_seed(seed)
    save_checkpoint(build_model(args).state_dict(), {}, None, None,
                    os.path.join(dst, "checkpoint_0.pt"))
    return os.path.join(dst, "checkpoint_0.pt")


def hold_cca(what: str, got, want) -> float:
    """The CCA fields of `got` against `want`, each within CCA_TOL of its
    largest entry; the worst such ratio."""
    worst = 0.0
    for name in ("x_mean", "x_std", "x_rotations"):
        a, b = getattr(got, name), getattr(want, name)
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        if a.shape != b.shape or rel > CCA_TOL:
            raise AssertionError(f"[cca] {what}: {name} {rel:.3e} of its "
                                 f"largest entry apart")
        worst = max(worst, rel)
    return worst


def run_cca(dev, work: str, checkpoint: str) -> dict:
    """`research/train_cca.py` between the default epoch's checkpoint and a
    second of the same flags from another seed, over 8 generated WAV files
    of 3 s: the two views extracted on the card, fitted on the card and in
    float64 on the CPU (`hold_cca`, and the projected features); then the
    CLI on the card end to end and `FeatureModule(cca_projection=...)` on
    the card with its pickle."""
    from cpc2_torch import feature_loader as fl
    from cpc2_torch.ops import _build
    from cpc2_torch.research import train_cca
    from cpc2_torch.research.cca import fit_cca, load_cca

    second = seeded_checkpoint(work, checkpoint, 1)
    db = os.path.join(work, "cca_db")
    write_corpus(db, ext=".wav", n_speakers=2, n_files=4, seconds=3.0,
                 seed=13)
    files = train_cca.corpus_files(db, ".wav")
    opts = dict(no_batch=False, strict=True, max_size_seq=10240,
                batch_size=8, device=dev)
    views = [train_cca.checkpoint_extractor(ck, **opts)
             for ck in (checkpoint, second)]
    x, y = (np.vstack([view(os.path.join(db, rel)) for rel in files])
            for view in views)
    torch.cuda.synchronize()
    start = time.perf_counter()
    card = fit_cca(x, y, CCA_COMPONENTS, device=dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - start
    start = time.perf_counter()
    cpu = fit_cca(x, y, CCA_COMPONENTS, device="cpu")
    cpu_s = time.perf_counter() - start
    fields = hold_cca("card vs cpu", card, cpu)
    projected = np.abs(card.transform(x) - cpu.transform(x)).max()
    scale = np.abs(cpu.transform(x)).max()
    if projected > CCA_TOL * scale:
        raise AssertionError(f"[cca] projected features card vs cpu "
                             f"{projected:.3e} of {scale:.3e}")
    out_dir = os.path.join(work, "cca_out")
    _build.reset_launches()
    start = time.perf_counter()
    train_cca.main(["--path_cp_X", checkpoint, "--path_cp_Y", second,
                    "--path_db", db, "--path_output", out_dir,
                    "--n_components", str(CCA_COMPONENTS), "--device",
                    dev.type])
    cli_s = time.perf_counter() - start
    cli_launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    check_launched("train_cca", cli_launches, ("lstm_fwd",))
    pkl = os.path.join(out_dir,
                       f"cca_model_n_components_{CCA_COMPONENTS}.pkl")
    cli_fields = hold_cca("the CLI's pickle vs the card fit", load_cca(pkl),
                          card)
    model = fl.load_model([checkpoint])[0].to(dev)
    rs = np.random.RandomState(15)
    data = ((0.1 * rs.randn(EXTRAS_BATCH, EXTRAS_WINDOW)).astype(np.float32),
            None)
    got = fl.FeatureModule(model, False, cca_projection=pkl)(data)
    plain = fl.FeatureModule(model, False)(data)
    want = torch.from_numpy(load_cca(pkl).transform(
        plain.cpu().double().numpy().reshape(-1, plain.shape[-1]))
        ).reshape(got.shape[0], got.shape[1], -1)
    if got.device != plain.device or tuple(got.shape) != (
            EXTRAS_BATCH, EXTRAS_WINDOW // 160, CCA_COMPONENTS):
        raise AssertionError(f"[cca] projected features {tuple(got.shape)} "
                             f"on {got.device}")
    proj_err = compare("cca projection on the card", [got.cpu()],
                       [want.float()], rtol=1e-5)
    return {"frames": int(x.shape[0]), "files": len(files),
            "fit_s_card": card_s, "fit_s_cpu": cpu_s, "cli_s": cli_s,
            "card_vs_cpu_fields_rel": fields,
            "card_vs_cpu_projected_max_abs": float(projected),
            "cli_vs_card_fit_rel": cli_fields,
            "projection_max_abs_err": proj_err, "cli_launches": cli_launches}


def run_buckets(dev, work: str, checkpoint: str) -> dict:
    """`build_feature_files` over BUCKET_FILES ragged WAV files of 2-4 s on
    the card with and without `bucket_frames`, each against the CPU, the
    counts set to 0 just before and read just after each card pass: one
    `lstm_fwd` a batch, as many batches as distinct (padded) lengths; the
    bucketed features' frames before the last 4 held to the exact ones."""
    from cpc2_torch import feature_loader as fl
    from cpc2_torch.data.audio_io import save_wav
    from cpc2_torch.ops import _build
    rs = np.random.RandomState(16)
    root = os.path.join(work, "ragged_db")
    os.makedirs(root)
    paths, lengths = [], []
    for i in range(BUCKET_FILES):
        n = int(rs.randint(2 * 16000, 4 * 16000))
        path = os.path.join(root, f"r{i:02d}.wav")
        save_wav(path, (0.2 * np.sin(np.arange(n) * (0.01 + 0.001 * i))
                        + 0.05 * rs.randn(n)).astype(np.float32), 16000)
        paths.append(path)
        lengths.append(n)
    card_model = fl.load_model([checkpoint])[0].to(dev)
    cpu_model = fl.load_model([checkpoint])[0]
    out, feats = {}, {}
    for bucket in (0, BUCKET_FRAMES):
        maker = fl.FeatureModule(card_model, False, keep_hidden=True)
        torch.cuda.synchronize()
        _build.reset_launches()
        start = time.perf_counter()
        card = fl.build_feature_files(maker, paths, bucket_frames=bucket)
        seconds = time.perf_counter() - start
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        cpu = fl.build_feature_files(
            fl.FeatureModule(cpu_model, False, keep_hidden=True), paths,
            bucket_frames=bucket)
        padded = {(-(-(n // 160) // bucket) * bucket * 160) if bucket else n
                  for n in lengths}
        if launches.get("lstm_fwd", 0) != len(padded):
            raise AssertionError(f"[buckets {bucket}] lstm_fwd launches "
                                 f"{launches}, want one a batch: "
                                 f"{len(padded)}")
        for p, n in zip(paths, lengths):
            if card[p].shape != (1, n // 160, card_model.dim_context):
                raise AssertionError(f"[buckets {bucket}] {p}: "
                                     f"{card[p].shape}")
        err = compare(f"bucket_frames {bucket} card vs cpu",
                      [torch.from_numpy(card[p]) for p in paths],
                      [torch.from_numpy(cpu[p]) for p in paths],
                      rtol=EXTRAS_CPU_RTOL)
        feats[bucket] = card
        out[bucket] = {"batches": len(padded), "launches": launches,
                       "seconds": seconds, "card_vs_cpu_max_abs": err}
    body = compare("bucketed vs exact features before the last 4 frames",
                   [torch.from_numpy(feats[BUCKET_FRAMES][p][:, :-4])
                    for p in paths],
                   [torch.from_numpy(feats[0][p][:, :-4]) for p in paths])
    tail = max(float(np.abs(feats[BUCKET_FRAMES][p][:, -4:]
                            - feats[0][p][:, -4:]).max()) for p in paths)
    return {"files": BUCKET_FILES, "bucket_frames": BUCKET_FRAMES,
            "exact": out[0], "bucketed": out[BUCKET_FRAMES],
            "body_max_abs_vs_exact": body, "tail_max_abs_vs_exact": tail}


def check_clustering_criteria(dev) -> dict:
    """One `DeepEmbeddedClustering` centroid update (3 batches of 8 x 128 x
    256 features drawn around 50 centroids, at rate 1) and one
    `DeepClustering` loss (the same classifier weights, labels from the
    centroids) on the card against the CPU, at RTOL of the largest value:
    the centroids, and their move by the update on its own scale."""
    from cpc2_torch.clustering.clustering import kMeanCluster
    from cpc2_torch.research import DeepClustering, DeepEmbeddedClustering
    rs = np.random.RandomState(17)
    k, d = 50, EXTRAS_WIDTH
    ck = rs.randn(1, k, d).astype(np.float32)
    loader = [((ck[0][rs.randint(0, k, (EXTRAS_BATCH, 128))]
                + rs.randn(EXTRAS_BATCH, 128, d)).astype(np.float32), None)
              for _ in range(3)]
    dec, dc, seconds = {}, {}, {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        crit = DeepEmbeddedClustering(1.0, k, d, 0, 2, "kmean", device=where)
        crit.init = True
        crit.clusters = kMeanCluster(ck).to(where)
        torch.cuda.synchronize()
        start = time.perf_counter()
        crit.updateCLusters(loader, lambda data: torch.as_tensor(data[0]))
        torch.cuda.synchronize()
        seconds[side] = time.perf_counter() - start
        dec[side] = crit.clusters.Ck.cpu()
        head = DeepClustering(k, d, 0, 1, "kmean", device=where)
        torch.manual_seed(18)
        head.classifier.load_state_dict(torch.nn.Linear(d, k).state_dict())
        head.clusters = kMeanCluster(ck).to(where)
        head.step = 1
        x = torch.from_numpy(loader[0][0]).to(where)
        labels = head.assign_labels(x)
        dc[side] = (head(x, labels).detach().cpu(), labels.cpu())
    moves = {side: ck_new - torch.from_numpy(ck)
             for side, ck_new in dec.items()}
    moved = moves["cpu"].abs().max().item()
    if moved < 1e-3:
        raise AssertionError("[clustering criteria] the DEC update did not "
                             "move the centroids")
    if not torch.equal(dc["card"][1], dc["cpu"][1]):
        raise AssertionError("[clustering criteria] assign_labels differ "
                             "card vs cpu")
    return {"dec_update_max_abs_err": compare(
                "DEC update card vs cpu", [dec["card"], moves["card"]],
                [dec["cpu"], moves["cpu"]]),
            "dec_centroids_moved": moved,
            "dec_update_s": seconds,
            "deep_clustering_loss": dc["cpu"][0].item(),
            "deep_clustering_max_abs_err": compare(
                "DeepClustering loss card vs cpu", [dc["card"][0]],
                [dc["cpu"][0]])}


def run_feature_extras(dev, work: str, card: str, checkpoint: str) -> dict:
    """Phase 13 (`check_train_mode`, `run_cca`, `run_buckets`,
    `check_clustering_criteria`), each printed on its own line."""
    start = time.perf_counter()
    train_mode = check_train_mode(dev)
    log(f"[train_mode] {time.perf_counter() - start:.1f} s, {card}: "
        f"FeatureModule(train_mode=True) on a transformer-context model at "
        f"{EXTRAS_BATCH} x {EXTRAS_WINDOW} samples, width {EXTRAS_WIDTH}, "
        f"dropout 0.1: two calls differ, the seed replays them bit for bit, "
        f"rate 0 equals evaluation bit for bit, "
        f"{train_mode['tensors_unchanged']} tensors and every module's mode "
        f"unchanged; " + "; ".join(
            f"{route}: {r['ffn_calls']} FFN calls (max abs err vs ffn_plain "
            f"{r['ffn_max_abs_err']:.2e}), {r['attention_calls']} fused "
            f"attention calls ({r['attention_max_abs_err']:.2e} vs "
            f"attention_plain), two calls {r['two_calls_ms']:.3f} ms (host "
            f"clock), mean |train - eval| {r['mean_abs_change_vs_eval']:.3e}"
            f", launches {r['launches']}"
            for route, r in train_mode["routes"].items()))
    start = time.perf_counter()
    cca = run_cca(dev, work, checkpoint)
    log(f"[cca] {time.perf_counter() - start:.1f} s, {card}: "
        f"{CCA_COMPONENTS} components over {cca['frames']} frames of "
        f"{cca['files']} files (the default epoch's checkpoint against a "
        f"seed-1 one of its flags): fit {cca['fit_s_card']:.3f} s on the "
        f"card, {cca['fit_s_cpu']:.3f} s in float64 on the CPU (host "
        f"clock); fields card vs cpu {cca['card_vs_cpu_fields_rel']:.2e} of "
        f"their largest (held to {CCA_TOL}), projected features "
        f"{cca['card_vs_cpu_projected_max_abs']:.2e}; the CLI on the card "
        f"{cca['cli_s']:.3f} s (its pickle vs the card fit "
        f"{cca['cli_vs_card_fit_rel']:.2e}), launches "
        f"{cca['cli_launches']}; FeatureModule(cca_projection=...) on the "
        f"card {cca['projection_max_abs_err']:.2e} from the pickle's numpy "
        f"transform")
    start = time.perf_counter()
    buckets = run_buckets(dev, work, checkpoint)
    log(f"[buckets] {time.perf_counter() - start:.1f} s, {card}: "
        f"build_feature_files over {buckets['files']} ragged files of 2-4 s: "
        + "; ".join(
            f"{name} {r['batches']} batches, launches {r['launches']}, "
            f"{r['seconds']:.3f} s, card vs cpu {r['card_vs_cpu_max_abs']:.2e}"
            for name, r in (("exact", buckets["exact"]),
                            (f"bucket_frames {BUCKET_FRAMES}",
                             buckets["bucketed"])))
        + f"; bucketed vs exact {buckets['body_max_abs_vs_exact']:.2e} "
        f"before the last 4 frames, {buckets['tail_max_abs_vs_exact']:.2e} "
        f"in them")
    start = time.perf_counter()
    criteria = check_clustering_criteria(dev)
    log(f"[clustering criteria] {time.perf_counter() - start:.1f} s, "
        f"{card}: DEC update card vs cpu "
        f"{criteria['dec_update_max_abs_err']:.2e} (centroids moved "
        f"{criteria['dec_centroids_moved']:.2e}; "
        f"{criteria['dec_update_s']['card']:.3f} s on the card, "
        f"{criteria['dec_update_s']['cpu']:.3f} s on the CPU), "
        f"DeepClustering loss {criteria['deep_clustering_loss']:.6f}, card "
        f"vs cpu {criteria['deep_clustering_max_abs_err']:.2e}")
    return {"train_mode": train_mode, "cca": cca, "buckets": buckets,
            "clustering_criteria": criteria}


def feature_extras_launches(extras: dict) -> dict:
    """Each kernel's launches over phase 13's main paths: the two
    `train_mode` routes' calls, the CCA CLI and the bucketed pass."""
    total = {}
    for launches in ([r["launches"] for r in
                      extras["train_mode"]["routes"].values()]
                     + [extras["cca"]["cli_launches"],
                        extras["buckets"]["bucketed"]["launches"]]):
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    return total


# ---------------------------------------------------------------------------
# Phase 14: data-parallel training (`--distributed`, two ranks sharing the
# card, `--global_negatives` and its gathered-pool InfoNCE kernels)
# ---------------------------------------------------------------------------

GATHERED = ("infonce_fwd_gathered", "infonce_bwd_gathered")
DP_RANKS = 2
# the gathered pool of two ranks at the recipe: 8 local windows' 12 x 116
# predictions against 2 x 8 x 128 rows of 256
GATHERED_SHAPE = (8, 12, 116, 128, 256, DP_RANKS * 8 * 128)
# steps of the two ranks against the single process's at batch 16
DP_STEPS = 2
# the two ranks' epoch: 4 speakers x 3 files x 26 s of WAV, files 0-1 of
# each speaker train and file 2 validates (`--pathTrain`, `--pathVal`), so
# that each rank's share of the files (two speakers) holds the same
# windows: 8 full batches of 8 and 2 short ones a rank (`samespeaker`),
# the short ones as weighted rounds at the epoch's end
DP_DB = "dp_db"
DP_SECONDS = 26.0
# A rank: `chip_smoke.dp_rank(rank, work, port)` in a fresh process, its
# result saved to argv[2]; `WORLD_SIZE`, `RANK`, `LOCAL_RANK`,
# `MASTER_ADDR`, `MASTER_PORT` and `CPC2_DIST_BACKEND` in its environment.
# The ranks start while the NCCL epochs run and wait for DP_GO (in the
# work directory) before their first kernel.
DP_GO = "dp_go"
DP_RUNNER = (
    "import sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import torch\n"
    "import chip_smoke\n"
    "out = chip_smoke.dp_rank(int(sys.argv[3]), sys.argv[4], "
    "int(sys.argv[5]))\n"
    "torch.save(out, sys.argv[2])\n")


def dp_trainer(dev, inputs: dict, mode: str, dp):
    """A trainer at the recipe from `inputs`' weights, dropout off: as a
    rank of `dp` (`--global_negatives` in `global` mode), or without `dp`
    the single process at batch 16 (`--neg_pool_group 8` in `group`
    mode)."""
    from cpc2_torch.config import parse_args
    from cpc2_torch.feature_loader import build_model
    from cpc2_torch.train import get_criterion
    from cpc2_torch.training import Trainer, make_optimizer
    flags = ["--pathDB", ".", "--random_seed", "0"]
    if dp is not None and mode == "global":
        flags.append("--global_negatives")
    if dp is None:
        flags += ["--batchSizeGPU", "16"] + (
            ["--neg_pool_group", "8"] if mode == "group" else [])
    args = parse_args(flags)
    model = build_model(args).to(dev)
    crit = get_criterion(args).to(dev)
    model.load_state_dict(inputs["model"])
    crit.load_state_dict(inputs["criterion"])
    for mod in crit.modules():      # dropout off, as `_check_step`
        if hasattr(mod, "rate"):
            mod.rate = 0.0
        if hasattr(mod, "dropout") and isinstance(mod.dropout, float):
            mod.dropout = 0.0
    named = (list(model.named_parameters(prefix="model"))
             + list(crit.named_parameters(prefix="criterion")))
    params = [p for _n, p in named]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    trainer = Trainer(model, crit, make_optimizer(args, params,
                                                  capturable=True), gen,
                      dp=dp, global_negatives=args.global_negatives)
    return trainer, named


def dp_steps(dev, inputs: dict, precision: str, mode: str, dp) -> dict:
    """DP_STEPS steps of `dp_trainer` on `inputs`' batches of 16 (a rank's
    rows) with its negatives (a rank's own, or all of them in global rows):
    each step's losses, the first step's gradients (over the ranks), the
    parameters after, the kernels' launches and the steps' ms (events)."""
    from cpc2_torch.ops import _build
    from cpc2_torch.training import precision as library_precision
    with library_precision(precision):
        trainer, named = dp_trainer(dev, inputs, mode, dp)
        _build.reset_launches()
        losses, grads, ms = [], None, []
        for i in range(DP_STEPS):
            x = inputs["batch"][i].to(dev)
            neg = inputs["neg"][mode][i]
            if dp is not None:
                # a rank's own rows; in `group` mode its own pool's
                x, neg = dp.rows(x), neg[dp.rank]
                if mode == "group":
                    neg = neg - dp.rank * (GATHERED_SHAPE[5] // DP_RANKS)
            else:
                neg = neg.reshape(-1, *neg.shape[2:])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out, _accs = trainer.train_step(x, neg.to(dev))
            end.record()
            torch.cuda.synchronize(dev)
            ms.append(start.elapsed_time(end))
            losses.append(out.cpu())
            if grads is None:
                grads = [p.grad.detach().cpu().clone() for _n, p in named]
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    return {"losses": losses, "grads": grads,
            "names": [n for n, _p in named],
            "params": [p.detach().cpu().clone() for _n, p in named],
            "launches": launches, "ms": ms}


def dp_alone(dev, inputs: dict, dp) -> dict:
    """A one host's short batch on the card (`train_tails.TailRunner`):
    the `global` mode trainer of `dp` in `fp32`, the device chain's
    `bandreject` on both views drawn from a generator of the rank's own
    (as `train.py` seeds it), takes a step on its rows of the first batch
    of 16, one on its first 3 windows whole (the tail runner's
    generators, no gathered pool) and one on its rows again; then the
    ranks' replicas are compared (`check_replicas`). Returns the tail
    step's losses, each tensor's float64 sum and the kernels' launches."""
    from cpc2_torch.data.augment_device import make_device_augment
    from cpc2_torch.ops import _build
    from cpc2_torch.parallel import rank_seed
    from cpc2_torch.train_tails import TailRunner, route
    from cpc2_torch.training import precision as library_precision
    batch = inputs["batch"][0].to(dev)
    if route(3, batch.shape[0], dp) != "alone":
        raise AssertionError("[dp alone] 3 windows do not run alone")
    with library_precision("fp32"):
        trainer, _named = dp_trainer(dev, inputs, "global", dp)
        trainer.device_augment = (make_device_augment(["bandreject"]),
                                  True, True, False)
        trainer.augment_generator = torch.Generator(device=dev)
        trainer.augment_generator.manual_seed(rank_seed(5, dp.rank))
        tails = TailRunner(dev, rank_seed(0, dp.world))
        _build.reset_launches()
        trainer.train_step(dp.rows(batch))
        losses, _accs = tails.train(trainer, batch[:3])
        trainer.train_step(dp.rows(batch))
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        dp.check_replicas(trainer.model, trainer.criterion)
    return {"tail_losses": losses.cpu(), "launches": launches,
            "sums": [float(t.double().sum()) for m in (trainer.model,
                                                       trainer.criterion)
                     for t in m.state_dict().values()]}


def dp_rank(rank: int, work: str, port: int) -> dict:
    """One of the DP_RANKS ranks on cuda:0 over `gloo`, once DP_GO exists:
    first a check that `gloo` takes CUDA tensors in `all_reduce` and
    `broadcast`, then `dp_steps` in each precision and mode and
    `dp_alone` in a process group of its own (port `port`), then one epoch of the CLI with
    `--distributed --global_negatives` (`dp_epoch_argv`) in the
    environment's layout; rank 0 then checks and times the gathered-pool
    kernels alone (`check_gathered_kernels`), the other rank gone."""
    import torch.distributed as dist
    from cpc2_torch.ops import _build
    from cpc2_torch.parallel import DataParallel, init_process_group
    from cpc2_torch.train import main as train_main
    dev = torch.device("cuda", 0)
    out = {}
    go = os.path.join(work, DP_GO)
    deadline = time.perf_counter() + 300
    while not os.path.exists(go):
        if time.perf_counter() > deadline:
            raise AssertionError(f"rank {rank}: no {DP_GO} in 300 s")
        time.sleep(0.05)
    init_process_group(rank, DP_RANKS, dev, f"tcp://127.0.0.1:{port}")
    try:
        dp = DataParallel(rank, DP_RANKS, dev)
        t = torch.full((5,), float(rank + 1), device=dev)
        dp.all_reduce(t)
        b = torch.full((3,), float(rank + 7), device=dev)
        dist.broadcast(b, src=0)
        if dp.backend != "gloo" or not bool((t == 3).all()) or \
                not bool((b == 7).all()):
            raise AssertionError(f"rank {rank}: {dp.backend} on CUDA "
                                 f"tensors gave {t.tolist()}, {b.tolist()}")
        out["collectives"] = dp.backend
        inputs = torch.load(os.path.join(work, "dp_inputs.pt"),
                            weights_only=True)
        for prec in ("fp32", "bf16mix"):
            for mode in ("group", "global"):
                out[f"{prec} {mode}"] = dp_steps(dev, inputs, prec, mode, dp)
        out["alone"] = dp_alone(dev, inputs, dp)
    finally:
        dist.destroy_process_group()
    _build.reset_launches()
    record = train_main(dp_epoch_argv(work))
    out["epoch"] = {
        "launches": {k: n for k, n in _build.LAUNCHES.items() if n},
        **{k: record.get(k) for k in (
            "step_losses", "median_step_ms", "val_steps", "ranks",
            "backend", "audio_hours_per_hour")},
        "steps": len(record["step_ms"]), "logs": record["logs"]}
    if rank == 0:
        out["kernels"] = check_gathered_kernels(dev)
    return out


def dp_epoch_argv(work: str) -> list:
    return train_argv(work, os.path.join(work, "ck_dp2"), "--distributed",
                      "--global_negatives", "--file_extension", ".wav",
                      "--pathTrain", os.path.join(work, "dp_train.txt"),
                      "--pathVal", os.path.join(work, "dp_val.txt"),
                      db=DP_DB)


def dp_inputs(work: str) -> dict:
    """The ranks' weights (the recipe from seed 0), DP_STEPS batches of 16
    windows and their negatives: in `group` mode (DP_RANKS, 8, N, W) each
    rank's in its own 1,024 rows, in `global` mode over all 2,048; the
    single process takes them in global rows. Saved for the ranks."""
    from cpc2_torch.config import parse_args
    from cpc2_torch.feature_loader import build_model
    from cpc2_torch.train import get_criterion
    args = parse_args(["--pathDB", ".", "--random_seed", "0"])
    torch.manual_seed(0)
    model, crit = build_model(args), get_criterion(args)
    rs = np.random.RandomState(14)
    b, _k, w, n, _d, p = GATHERED_SHAPE
    rows = p // DP_RANKS
    batch = [torch.from_numpy(0.1 * rs.randn(DP_RANKS * b, 2, 1, 20480)
                              .astype(np.float32)) for _ in range(DP_STEPS)]
    local = [rs.randint(0, rows, (DP_RANKS, b, n, w)) for _ in range(DP_STEPS)]
    neg = {"group": [torch.from_numpy((x + (np.arange(DP_RANKS) * rows)
                                       [:, None, None, None]).astype(
                                           np.int32)) for x in local],
           "global": [torch.from_numpy(rs.randint(0, p, (DP_RANKS, b, n, w))
                                       .astype(np.int32))
                      for _ in range(DP_STEPS)]}
    inputs = {"model": model.state_dict(), "criterion": crit.state_dict(),
              "batch": batch, "neg": neg}
    torch.save(inputs, os.path.join(work, "dp_inputs.pt"))
    return inputs


def write_dp_corpus(work: str) -> None:
    """DP_DB and its split lists."""
    written = write_corpus(os.path.join(work, DP_DB), ext=".wav",
                           n_files=3, seconds=DP_SECONDS, seed=14)
    names = sorted(os.path.splitext(os.path.basename(p))[0]
                   for p in written)
    for split, keep in (("train", lambda s: not s.endswith("2")),
                        ("val", lambda s: s.endswith("2"))):
        with open(os.path.join(work, f"dp_{split}.txt"), "w") as fh:
            fh.write("\n".join(s for s in names if keep(s)) + "\n")


def hold_dp_steps(name: str, ranks: list, one: dict, precision: str) -> dict:
    """The ranks' `dp_steps` against the single process's: every step's
    losses and the first step's gradients (fp32: 1e-3 of each tensor's
    largest; bf16mix: PERF.md section 2's step rules), the ranks bit for
    bit equal. Returns the worst errors."""
    a, b = ranks
    for x, y in zip(a["losses"] + a["params"], b["losses"] + b["params"]):
        if not torch.equal(x, y):
            raise AssertionError(f"[dp steps {name}] the two ranks differ")
    if precision == "fp32":
        loss_err = compare(f"[dp steps {name}] losses", a["losses"],
                           one["losses"], rtol=1e-3)
        grad_err = compare(f"[dp steps {name}] gradients", a["grads"],
                           one["grads"], rtol=1e-3)
        return {"losses_max_abs": loss_err, "grads_max_abs": grad_err}
    loss_err = compare(f"[dp steps {name}] losses", a["losses"],
                       one["losses"], rtol=FUSED_LOSS_RTOL)
    worst = 0.0
    for gname, g, want in zip(a["names"], a["grads"], one["grads"]):
        rel = norm_rel(g, want)
        tol = (FFN_LIN1_GRAD_NORM_TOL if ".ffnetwork.lin1." in gname
               else FUSED_GRAD_NORM_TOL)
        if rel > tol:
            raise AssertionError(f"[dp steps {name}] gradient {gname}: "
                                 f"{rel:.3e} (2-norm, relative)")
        worst = max(worst, rel)
    return {"losses_max_abs": loss_err, "grads_worst_rel_2norm": worst}


def check_gathered_kernels(dev) -> dict:
    """The InfoNCE kernels at GATHERED_SHAPE, indices over the whole pool
    as `--global_negatives` draws them: forward, dpreds and dz against
    `negative_scores_plain` (ATOL + RTOL of the largest), the backward bit
    for bit across two calls, one call counted once under GATHERED and
    launching one `gathered_fwd`, one `gathered_bwd` and one `dz_sum`;
    device times beside the plain version's, the library route's and the
    bound as `check_infonce` reckons it. Returns the kernels' entries."""
    from cpc2_torch.losses import sample_negative_indices
    from cpc2_torch.ops import _build
    from cpc2_torch.ops.infonce import (infonce_plan, negative_scores,
                                        negative_scores_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    b, k, w, n, d, p = GATHERED_SHAPE
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = infonce_plan(b, k, w, n, d, p, sms)
    inputs = [torch.randn(b, k, w, d, device=dev, generator=gen),
              torch.randn(p, d, device=dev, generator=gen)]
    idx = sample_negative_indices(gen, b, 128, n, w, dev,
                                  pool_batch=DP_RANKS * b).transpose(
                                      1, 2).contiguous()
    if int(idx.max()) < p // 2:
        raise AssertionError("the draw kept to the local rows")
    cot = [torch.randn(b, k, w, n, device=dev, generator=gen)]

    def kernel(preds, z):
        return negative_scores(preds, z, idx, ranks=DP_RANKS)

    def plain(preds, z):
        return negative_scores_plain(preds, z, idx)
    _build.reset_launches()
    out_k, grad_k, bwd_k = grads_of(kernel, inputs, cot)
    launched = {name: c for name, c in _build.LAUNCHES.items() if c}
    if launched != {GATHERED[0]: 1, GATHERED[1]: 1}:
        raise AssertionError(f"gathered infonce: launches {launched}")
    out_p, grad_p, bwd_p = grads_of(plain, inputs, cot)
    err_f = compare("gathered infonce forward", out_k, out_p)
    err_b = compare("gathered infonce backward", grad_k, grad_p)
    if not all(torch.equal(x, y) for x, y in zip(bwd_k(), grad_k)):
        raise AssertionError("gathered infonce backward: two calls differ")
    with torch.no_grad():
        fwd_split, fwd_counts = kernel_counts(lambda: kernel(*inputs),
                                              "gathered_fwd")
        plain_fwd = device_ms(lambda: plain(*inputs))
        route_fwd = device_ms(lambda: infonce_route(*inputs, idx))
        route_out = infonce_route(*inputs, idx)

        def route_bwd():
            return infonce_route_bwd(cot[0], *inputs, idx)
        route_bwd_ms = device_ms(route_bwd)
        route_grad = route_bwd()
    compare("gathered infonce route forward", [route_out], out_k)
    compare("gathered infonce route backward", route_grad, grad_k)
    bwd_split, bwd_counts = kernel_counts(bwd_k, "dz_sum")
    for what, counts, names in (("forward", fwd_counts, ["gathered_fwd"]),
                                ("backward", bwd_counts,
                                 ["gathered_bwd", "dz_sum"])):
        one_launch_each(f"gathered infonce {what}", counts, names)
    plain_bwd = device_ms(bwd_p)
    events = {GATHERED[0]: cuda_ms(lambda: kernel(*inputs)),
              GATHERED[1]: cuda_ms(bwd_k)}
    dots = 2 * b * k * w * n * d
    src, rep = "cpc2_torch/csrc/infonce.cu", "cpc2_tpu/ops/infonce_pallas.py"
    entries = [
        kernel_entry(GATHERED[0], src, rep + ":107", err_f,
                     sum(fwd_split.values()), plain_fwd, None,
                     nbytes(*inputs, idx) + nbytes(*out_k), dots,
                     TF32X3_FLOP_PER_S),
        kernel_entry(GATHERED[1], src, rep + ":170", err_b,
                     sum(bwd_split.values()), plain_bwd, None,
                     nbytes(*cot, *inputs, idx) + nbytes(*grad_k), dots)]
    return {"kernels": entries, "plan": plan._asdict(),
            "route_ms": {GATHERED[0]: route_fwd, GATHERED[1]: route_bwd_ms},
            "events_ms": events, "bwd_split": bwd_split,
            "kernels_a_call": {"fwd": fwd_counts, "bwd": bwd_counts}}


def same_checkpoint(path_a: str, path_b: str) -> None:
    """Every tensor of two checkpoints bit for bit equal, but the ranks'
    generator states that a run under ranks adds (its rank 0's must be the
    generator's state)."""
    a, b = (_flat(torch.load(p, weights_only=True)) for p in (path_a, path_b))
    ranks = [k for k in a if k.startswith("optimizer.rank_generator_states")]
    if ranks and not torch.equal(a[ranks[0]], a["optimizer.generator_state"]):
        raise AssertionError("rank 0's saved generator state is not the "
                             "generator's")
    a = {k: v for k, v in a.items() if k not in ranks}
    if set(a) != set(b):
        raise AssertionError(f"checkpoint keys differ: {set(a) ^ set(b)}")
    differ = [k for k in sorted(a) if not torch.equal(a[k], b[k])]
    if differ:
        raise AssertionError(f"{path_a} vs {path_b}: {differ[:5]} differ")


def run_nccl_rank(dev, work: str, tag: str, flags, reference: dict) -> dict:
    """One epoch of the CLI with `--distributed` as the one rank of a NCCL
    group (WORLD_SIZE=1, RANK=0, LOCAL_RANK=0 and a port of its own) with
    `flags`, held bit for bit to `reference`, the same seeded epoch without
    `--distributed`: every step's losses, the checkpoint, and every
    kernel's launches exactly."""
    from cpc2_torch.ops import _build
    from cpc2_torch.parallel import free_port
    from cpc2_torch.train import main
    env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    ck = os.path.join(work, f"ck_nccl_{tag}")
    os.environ.update(env)
    try:
        _build.reset_launches()
        record = main(train_argv(work, ck, "--distributed", *flags))
        launches = dict(_build.LAUNCHES)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if (record["ranks"], record["backend"]) != (1, "nccl"):
        raise AssertionError(f"[nccl {tag}] ran {record['ranks']} ranks "
                             f"over {record['backend']}")
    if record["step_losses"] != reference["step_losses"]:
        raise AssertionError(f"[nccl {tag}] the step losses differ from "
                             f"the run without --distributed")
    same_checkpoint(os.path.join(ck, "checkpoint_0.pt"),
                    reference["checkpoint"])
    held_launches(f"[nccl {tag}]", {k: n for k, n in launches.items() if n},
                  {k: n for k, n in reference["launches"].items() if n})
    return {"median_step_ms": record["median_step_ms"],
            "reference_median_step_ms": reference["median_step_ms"],
            "steps": len(record["step_ms"]),
            "dispatch": record["dispatch"],
            "launches": {k: n for k, n in launches.items() if n}}


def run_data_parallel(dev, work: str, card: str, records: dict) -> dict:
    """Phase 14: `[dp nccl default]` and `[dp nccl dispatch]`
    (`run_nccl_rank` against the default and the N = 4 epochs);
    `[dp gloo collectives]`, `[dp steps <precision> <mode>]` (two `gloo`
    ranks on cuda:0, `dp_rank`, against the single process at batch 16,
    `hold_dp_steps`), `[dp alone]` (a short batch run whole on both,
    `dp_alone`), `[dp epoch]` (their CLI epoch with `--distributed
    --global_negatives`, GATHERED launched on each rank) and `[dp
    kernels]` (`check_gathered_kernels` on rank 0 after it). The ranks
    start first and wait for DP_GO, which the NCCL epochs' end writes."""
    from cpc2_torch.ops import _build
    from cpc2_torch.parallel import free_port
    out = {}
    start = time.perf_counter()
    write_dp_corpus(work)
    inputs = dp_inputs(work)
    ports = [free_port(), free_port()]
    path = [os.path.join(work, f"dp_rank{r}.pt") for r in range(DP_RANKS)]
    procs = []
    for rank in range(DP_RANKS):
        env = dict(os.environ, WORLD_SIZE=str(DP_RANKS), RANK=str(rank),
                   LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(ports[0]), CPC2_DIST_BACKEND="gloo")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", DP_RUNNER, ROOT, path[rank], str(rank),
             work, str(ports[1])], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    one = {}
    try:
        for tag, flags, ref in (("default", [], records["default"]),
                                ("dispatch", DISPATCH_FLAGS,
                                 records["dispatch"])):
            t = time.perf_counter()
            r = out[f"nccl_{tag}"] = run_nccl_rank(dev, work, tag, flags,
                                                   ref)
            log(f"[dp nccl {tag}] {time.perf_counter() - t:.1f} s, {card}: "
                f"--distributed as one NCCL rank {' '.join(flags)}, "
                f"{r['steps']} steps ({r['dispatch']}): losses, checkpoint "
                f"and launches bit for bit the run without --distributed; "
                f"median {r['median_step_ms']:.3f} ms/step against "
                f"{r['reference_median_step_ms']:.3f} without")
        with open(os.path.join(work, DP_GO), "w"):
            pass
        for prec in ("fp32", "bf16mix"):
            for mode in ("group", "global"):
                one[f"{prec} {mode}"] = dp_steps(dev, inputs, prec, mode,
                                                 None)
        outs = [p.communicate(timeout=420) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (_o, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"[dp rank {rank}] exit {p.returncode}: "
                                 f"{err[-3000:]}")
    ranks = [torch.load(x, weights_only=False) for x in path]
    log(f"[dp gloo collectives] {DP_RANKS} ranks on cuda:0: "
        f"{ranks[0]['collectives']} all_reduce and broadcast of CUDA "
        f"tensors as expected")
    out["steps"] = {}
    for name, ref in one.items():
        prec, mode = name.split()
        got = [r[name] for r in ranks]
        held = hold_dp_steps(name, got, ref, prec)
        want = GATHERED if mode == "global" else ("infonce_fwd",
                                                  "infonce_bwd")
        for r in got:
            check_launched(f"[dp steps {name}]", dict.fromkeys(
                _build.KERNELS, 0) | r["launches"],
                want + LSTM_RESIDENT + (FP32_FFN if prec == "fp32"
                                        else BF16_FFN))
            if any(r["launches"].get(k, 0) != DP_STEPS for k in want):
                raise AssertionError(f"[dp steps {name}] launches "
                                     f"{r['launches']}")
        out["steps"][name] = dict(held, rank_ms=got[0]["ms"],
                                  one_process_ms=ref["ms"],
                                  launches=got[0]["launches"])
        log(f"[dp steps {name}] {card}: {DP_RANKS} gloo ranks on cuda:0 x "
            f"8 windows vs one process at batch 16 "
            f"({'--neg_pool_group 8' if mode == 'group' else 'the whole pool'}"
            f"), {DP_STEPS} steps, the same weights and negatives: "
            + ", ".join(f"{k} {v:.2e}" for k, v in held.items())
            + f"; ranks bit for bit; a rank's step "
            + ", ".join(f"{t:.1f}" for t in got[0]["ms"]) + " ms, the one "
            "process's " + ", ".join(f"{t:.1f}" for t in ref["ms"])
            + f" ms (events); launches a rank {got[0]['launches']}")
    alone = [r["alone"] for r in ranks]
    tail = alone[0]["tail_losses"]
    if alone[0]["sums"] != alone[1]["sums"] or not torch.equal(
            tail, alone[1]["tail_losses"]) or not bool(
                torch.isfinite(tail).all()):
        raise AssertionError(f"[dp alone] the ranks differ after a short "
                             f"batch run whole: {alone}")
    for rank, a in enumerate(alone):
        # the tail's 3 windows score over their own pool, the rows' steps
        # over the gathered one
        for name in ("infonce_fwd", "infonce_bwd"):
            if a["launches"].get(name) != 1 or a["launches"].get(
                    f"{name}_gathered") != 2:
                raise AssertionError(f"[dp alone] rank {rank} launches "
                                     f"{a['launches']}")
    out["alone"] = {"tail_losses": tail.tolist(),
                    "launches": alone[0]["launches"]}
    log(f"[dp alone] {card}: a short batch of 3 windows run whole on both "
        f"gloo ranks (`TailRunner`, device augmentation from its own "
        f"generator, no gathered pool) between two steps on the ranks' "
        f"rows of 16: replicas equal, the tail's losses "
        f"{[round(v, 6) for v in tail.flatten().tolist()]}; launches a "
        f"rank {alone[0]['launches']}")
    epochs = [r["epoch"] for r in ranks]
    for rank, e in enumerate(epochs):
        check_launched(f"[dp epoch] rank {rank}", dict.fromkeys(
            _build.KERNELS, 0) | e["launches"],
            GATHERED + LSTM_RESIDENT + BF16_FFN)
        losses = np.asarray(e["step_losses"], dtype=np.float64)
        if not np.isfinite(losses).all() or e["ranks"] != DP_RANKS:
            raise AssertionError(f"[dp epoch] rank {rank}: {e['ranks']} "
                                 f"ranks, losses {losses}")
    if epochs[0]["step_losses"] != epochs[1]["step_losses"]:
        raise AssertionError("[dp epoch] the ranks' losses differ")
    saved = torch.load(os.path.join(work, "ck_dp2", "checkpoint_0.pt"),
                       weights_only=True)
    if len(saved["optimizer"]["rank_generator_states"]) != DP_RANKS:
        raise AssertionError("[dp epoch] the checkpoint lacks the ranks' "
                             "generators")
    out["epoch"] = epochs[0]
    log(f"[dp epoch] {time.perf_counter() - start:.1f} s for the ranks "
        f"(the NCCL epochs, the steps, this epoch and the kernels' check), "
        f"{card}: --distributed --global_negatives on {DP_DB} "
        f"({DP_RANKS} gloo ranks on cuda:0, each its share of the files), "
        f"{epochs[0]['steps']} + {epochs[0]['val_steps']} steps a rank, "
        f"median {epochs[0]['median_step_ms']:.3f} ms/step; rank 0's "
        f"launches {epochs[0]['launches']}, rank 1's {epochs[1]['launches']}")
    kern = out["kernels"] = ranks[0]["kernels"]
    log(f"[dp kernels] {card} (rank 0's process after the epoch, the other "
        f"rank gone): at {GATHERED_SHAPE} " + "; ".join(
            f"{k['name']} err {k['max_abs_err']:.2e}, {k['ms']:.4f} ms, "
            f"plain {k['plain_ms']:.4f} ms, library route "
            f"{kern['route_ms'][k['name']]:.4f} ms, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}), events "
            f"{kern['events_ms'][k['name']]:.4f} ms" for k in kern["kernels"])
        + f"; the backward by kernel " + ", ".join(
            f"{n[:30]} {v:.4f}" for n, v in kern["bwd_split"].items())
        + f"; plan {plan_summary(kern['plan'])}; kernels a call "
        f"{kern['kernels_a_call']}")
    return out


def plan_summary(plan: dict) -> str:
    return (f"{plan['row_tiles']} dz tiles of {plan['pt']} rows x "
            f"{plan['col_slices']} slices, {plan['splits']} splits of "
            f"{plan['group_units']} units")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from cpc2_torch.ops import _build

    t0 = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    start = time.perf_counter()
    _build.build(force=True)
    log(f"[build] {time.perf_counter() - start:.1f} s -> {_build.LIBRARY}")
    log((_build.BUILD_DIR / "build.log").read_text())
    log(f"[sass] {check_sass(_build)}")

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kernels, yardsticks, events, details = [], {}, {}, {}
    with fused_switches(False):
        for check in (check_lstm, check_ffn, check_infonce, check_dtw,
                      check_attention, check_encoder):
            start = time.perf_counter()
            result = check(dev, gen)
            if isinstance(result, tuple):
                result, yard, *timed = result
                yardsticks.update(yard)
                if timed:
                    events.update(timed[0])
                if len(timed) > 1:
                    details.update(timed[1])
            kernels += result
            log(f"[{check.__name__}] {time.perf_counter() - start:.1f} s")
    for k in kernels:
        yard = yardsticks.get(k["name"])
        log(f"  {k['name']:14s} err {k['max_abs_err']:.2e}  kernel "
            f"{k['ms']:.4f} ms  plain {k['plain_ms']:.4f} ms  library "
            f"{k['library_ms']} ms  bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']})"
            + (f"  default route {yard:.4f} ms" if yard else "")
            + (f"  events {events[k['name']]:.4f} ms" if k["name"] in events
               else ""))

    step_err = {}
    for prec, fused, width in STEP_RUNS:
        start = time.perf_counter()
        name = (f"{prec}{' fused' if fused else ''}"
                f"{' wide' if width > 64 else ''}")
        step_err[name], launches = check_step(dev, prec, fused, width)
        log(f"[check_step {name}] max abs err {step_err[name]:.2e}, "
            f"{time.perf_counter() - start:.1f} s, launches "
            f"{ {k: n for k, n in launches.items() if n} }")

    start = time.perf_counter()
    determinism = step_determinism(dev)
    log(f"[determinism] {time.perf_counter() - start:.1f} s: the default "
        f"step at the recipe, {determinism['passes']} passes on the same "
        f"weights, batch and draws: of the losses and "
        f"{determinism['gradients']} gradients these differ (max abs): "
        f"{determinism['differing'] or 'none'}")
    start = time.perf_counter()
    determinism_ctc = step_determinism(dev, ctc=True)
    log(f"[determinism] {time.perf_counter() - start:.1f} s: a "
        f"--supervised --pathPhone --CTC step at the CLI defaults (a "
        f"report: torch's CUDA ctc_loss backward adds with atomics), "
        f"{determinism_ctc['passes']} passes on the same weights, batch "
        f"and labels: of the losses and {determinism_ctc['gradients']} "
        f"gradients these differ (max abs): "
        f"{determinism_ctc['differing'] or 'none'}")

    records = {}
    with tempfile.TemporaryDirectory() as work:
        start = time.perf_counter()
        corpus = check_corpus(work)
        log(f"[corpus] {time.perf_counter() - start:.1f} s: {corpus['files']} "
            f"files, {corpus['seconds_of_audio']:.0f} s of audio, FLAC "
            f"{corpus['bytes_flac']} bytes, WAV {corpus['bytes_wav']} bytes; "
            f"every FLAC file decodes bit for bit to its samples; loaded "
            f"(AudioBatchData, 2 threads, host clock) FLAC in "
            f"{corpus['load_s_flac']:.3f} s, WAV in "
            f"{corpus['load_s_wav']:.3f} s, the same samples")
        sounds = write_sounds(work)
        noise = noise_dataset(sounds)
        try:
            start = time.perf_counter()
            augment = check_augment(dev, sounds, noise)
            log(f"[augment] {time.perf_counter() - start:.1f} s: every "
                f"device augmentation held card vs cpu and card vs host; "
                f"the augmented epochs' chain {list(AUGMENT_TYPES)} on "
                f"both views of a batch of 8 x 20,480 (draws included): "
                f"{augment['chain_ms_per_step']:.3f} ms a step on the card")
            from cpc2_torch.data.augment_device import make_device_augment
            chain = make_device_augment(AUGMENT_TYPES, noise_dataset=noise,
                                        ir_paths=sounds["irs"])
            start = time.perf_counter()
            determinism_aug = step_determinism(
                dev, device_augment=(chain, True, True, False))
            augment_s = time.perf_counter() - start
            # [dispatch]: graph replays against eager steps
            start = time.perf_counter()
            adam_err = check_capturable_adam(dev)
            adam_routes = time_adam_routes(dev)
            log(f"[dispatch] fused capturable Adam vs optax's formula over "
                f"5 steps: {adam_err:.2e} of the largest update (tolerance "
                f"1e-4); one step of the recipe's "
                f"{adam_routes['parameters']} parameters, device ms and "
                f"launches: " + ", ".join(
                    f"{route} {adam_routes[route]['ms']:.4f} ms "
                    f"{adam_routes[route]['launches']:.1f}"
                    for route in ("plain", "capturable", "fused")))
            corpus_d, offsets_d = dispatch_corpus(dev)
            dispatch = {}
            for setup in DISPATCH_SETUPS:
                r = dispatch[setup[0]] = check_dispatch_setup(
                    dev, setup, corpus_d, offsets_d, chain)
                log(f"[dispatch {setup[0]}] {card}: 3 groups of "
                    f"{DISPATCH_N} steps as graph replays (the third at "
                    f"half the rate: {r['captures']} captures) vs "
                    f"{3 * DISPATCH_N} eager steps: " + (
                        f"bit for bit ({r['tensors']} tensors: losses, "
                        f"parameters, Adam's moments and counts, both "
                        f"generators)" if r["bit_for_bit"] else
                        f"these differ (max abs, held to "
                        f"{DISPATCH_LOSS_ATOL} / {DISPATCH_PARAM_ATOL}): "
                        f"{r['differing']}")
                    + f"; launches a replay {r['launches_per_replay']} "
                    f"(= {DISPATCH_N} x an eager step's); a group "
                    + ", ".join(f"{t:.3f}" for t in r["group_ms_graph"])
                    + " ms replayed, " + ", ".join(
                        f"{t:.3f}" for t in r["group_ms_eager"])
                    + f" ms eager (host clock to a synchronise); peak "
                    f"memory {r['peak_bytes_graph']} bytes with the graph, "
                    f"{r['peak_bytes_eager']} eager")
            del corpus_d
            dispatch_s = time.perf_counter() - start
        finally:
            noise.close()
        log(f"[determinism] {augment_s:.1f} s: the "
            f"default step with {list(AUGMENT_TYPES)} on the device, "
            f"{determinism_aug['passes']} passes on the same weights, "
            f"batch and draws: of the losses and "
            f"{determinism_aug['gradients']} gradients these differ (max "
            f"abs): {determinism_aug['differing'] or 'none'}")
        for mode in EPOCHS:
            start = time.perf_counter()
            records[mode] = run_training(dev, work, mode)
            log(f"[train {mode}] {time.perf_counter() - start:.1f} s, "
                f"launches {records[mode]['launches']}")
        log("[epochs] median ms/step: " + ", ".join(
            f"{mode} {rec['median_step_ms']:.3f}"
            for mode, rec in records.items())
            + " (fused: CPC2_FUSED_ATTENTION=1 CPC2_FUSED_ENCODER=1; fp32: "
            "--precision fp32; wide: " + " ".join(WIDE) + "; profiled: "
            "--profile_dir, steps 5-14 traced; augmented_*: "
            f"{' '.join(AUGMENT_TYPES)} on both views, on train_db_part)")
        held = {"dispatch": hold_dispatch_epochs(
                    records["dispatch"], records["default"], "dispatch"),
                "dispatch_augmented": hold_dispatch_epochs(
                    records["dispatch_augmented"],
                    records["device_augmented"], "dispatch_augmented"),
                "dispatch_schedule": hold_dispatch_epochs(
                    records["dispatch_schedule"], records["schedule"],
                    "dispatch_schedule", n_epochs=2)}
        if records["dispatch_schedule"]["graph_captures"] < 2:
            raise AssertionError("dispatch_schedule: the learning-rate "
                                 "halving captured no second graph")
        log(f"[dispatch epochs] {card}: the CLI at N = {DISPATCH_N} with "
            f"--corpus_on_device vs N = 1 from host batches, largest "
            f"difference of the epoch means (held bit for bit): "
            + "; ".join(
                f"{mode} vs {ref} ({records[mode]['graph_captures']} "
                f"captures, {len(records[mode]['dispatch_ms'])} dispatches "
                f"for {len(records[mode]['step_ms'])} steps, "
                f"{records[mode]['median_step_ms']:.3f} vs "
                f"{records[ref]['median_step_ms']:.3f} ms/step) " + ", ".join(
                    f"{k} {v:.2e}" for k, v in held[mode].items())
                for mode, ref in (("dispatch", "default"),
                                  ("dispatch_augmented", "device_augmented"),
                                  ("dispatch_schedule", "schedule")))
            + f" ({dispatch_s:.1f} s for the graph checks)")
        log("[augmented epochs] median ms/step, median wait for a batch, "
            "median host ms a batch on the loader's thread, audio-hours "
            "per hour by the median step and over the steps and waits: "
            + "; ".join(
                f"{mode} ({len(rec['step_ms'])} steps) "
                f"{rec['median_step_ms']:.3f} ms/step, wait "
                f"{rec['median_wait_ms']:.3f} ms, host "
                f"{rec['median_load_ms']:.3f} ms, "
                f"{rec['audio_hours_per_hour']:.1f} h/h, with the waits "
                f"{rec['audio_hours_per_hour_with_waits']:.1f} h/h"
                for mode, rec in records.items()
                if mode.startswith("augmented") or mode == "default")
            + " (default: no augmentation, --host_prefetch 2; "
            "augmented_host: --host_prefetch 2; augmented_host_noprefetch: "
            "--host_prefetch 0; augmented_device: --augment_on_device)")
        trace = check_trace(work)
        log(f"[profile] steps 5-14 of the profiled epoch: window "
            f"{trace['window_ms']:.3f} ms, device busy "
            f"{trace['device_busy_ms']:.3f} ms, host's share "
            f"{100 * trace['host_share']:.1f}%, "
            f"{trace['kernel_launches']} kernel launches; the ten largest "
            f"device entries (ms, launches): " + "; ".join(
                f"{name[:100]} {ms:.3f} x{n}" for name, ms, n in trace["top"]))
        start = time.perf_counter()
        resume = run_resume(work)
        log(f"[resume] {time.perf_counter() - start:.1f} s: checkpoint_1.pt "
            f"of 2 epochs vs 1 + a resume to 2: "
            + ("bit for bit equal" if resume["bit_for_bit"] else
               f"not bit for bit: {resume['n_differing']} of "
               f"{resume['tensors']} tensors differ (max abs "
               f"{resume['differing']}), at most "
               f"{resume['max_rel_2norm']:.3e} in the 2-norm "
               f"{resume['largest_rel_2norm']}")
            + f"; the two runs' checkpoint_0.pt: "
            f"{resume['epoch0_n_differing']} tensors differ "
            f"{resume['epoch0_differing']}; the whole run's own first epoch "
            f"resumed to two: " + (
                "bit for bit equal" if resume["same_start_bit_for_bit"]
                else f"differs in {resume['same_start_differing']}"))
        start = time.perf_counter()
        resume_d = run_resume(work, "_dispatch", "ck_dispatch",
                              DISPATCH_FLAGS)
        log(f"[resume N={DISPATCH_N}] {time.perf_counter() - start:.1f} s: "
            f"the graph route with --corpus_on_device, checkpoint_1.pt of 2 "
            f"epochs vs 1 + a resume to 2: "
            + ("bit for bit equal" if resume_d["bit_for_bit"] else
               f"not bit for bit: {resume_d['n_differing']} of "
               f"{resume_d['tensors']} tensors differ (max abs "
               f"{resume_d['differing']}), at most "
               f"{resume_d['max_rel_2norm']:.3e} in the 2-norm")
            + "; the whole run's own first epoch resumed to two: " + (
                "bit for bit equal" if resume_d["same_start_bit_for_bit"]
                else f"differs in {resume_d['same_start_differing']}"))
        start = time.perf_counter()
        timings = time_dispatch(work)
        unprofiled = {t["label"]: t["median_step_ms"] for t in timings
                      if not t["profiled"]}
        log(f"[dispatch timings] {time.perf_counter() - start:.1f} s, "
            f"{card}: the default training on timing_db in a fresh "
            f"process each, in this order (two epochs; the last one "
            f"epoch under a device-only profiler): " + "; ".join(
                f"{t['label']}{' (profiled)' if t['profiled'] else ''}: "
                f"median {t['median_step_ms']:.3f} ms/step" + (
                    "" if t["profiled"] else
                    f" (the second epoch's mean "
                    f"{t['second_epoch_mean_ms']:.3f})") + ", median "
                f"{t['median_dispatch_ms']:.3f} ms to dispatch "
                f"({t['dispatch']}, {len(t['dispatch_ms'])} dispatches of "
                f"{len(t['step_ms'])} steps), peak memory "
                f"{t['peak_memory_bytes']} bytes" + (
                    f", device busy {100 * t['busy_share']:.1f}% from the "
                    f"first kernel to the last ({t['trace_busy_ms']:.3f} of "
                    f"{t['trace_window_ms']:.3f} ms, {t['trace_kernels']} "
                    f"kernels), {t['device_ms_per_step']:.3f} device ms a "
                    f"step, {100 * t['device_ms_per_step'] / unprofiled[
                        t['label']]:.1f}% of the unprofiled run's median "
                    f"step"
                    if t["profiled"] else "")
                for t in timings))
        record = records["default"]
        start = time.perf_counter()
        abx = run_abx(dev, work, record["checkpoint"])
        log(f"[abx] {time.perf_counter() - start:.1f} s, scores "
            f"{abx['scores']}, {abx['files']} files: features "
            f"{abx['features_s']:.3f} s, scoring {abx['scoring_s']:.3f} s "
            f"in {abx['flushes']} flushes, launches {abx['launches']}, "
            f"DTW {abx['dtw_device_ms']:.3f} ms in {abx['dtw_calls']} calls "
            f"({100 * abx['dtw_share_of_scoring']:.1f}% of scoring), "
            f"card-vs-cpu features {abx['feature_max_abs_err']:.2e}")
        start = time.perf_counter()
        concat = run_concat(dev, record["checkpoint"],
                            records["wide"]["checkpoint"], sorted(glob.glob(
                                os.path.join(work, "phones", "*",
                                             "*.wav")))[:4])
        log(f"[concat] {time.perf_counter() - start:.1f} s: channels "
            f"{concat['widths']} of the default and wide models, "
            f"{concat['files']} files, {concat['dims']} dims, features "
            f"{concat['features_s']:.3f} s, equal to each model's own "
            f"channel by channel, card vs cpu "
            f"{concat['max_abs_err_vs_cpu']:.2e}, launches "
            f"{concat['launches']}")

        # phase 7: the supervised criteria, steps and epochs, and the probe
        phase7 = time.perf_counter()
        start = time.perf_counter()
        sup_criteria = check_supervised_criteria(dev)
        log(f"[supervised criteria] {time.perf_counter() - start:.1f} s, "
            f"card vs cpu at B {SUP_B}, T {SUP_T}, H {SUP_H} (CTC to "
            f"{CTC_RTOL} of the largest value, the rest {RTOL}), max abs "
            f"err and forward + backward ms by events: " + ", ".join(
                f"{name} {r['max_abs_err']:.2e} {r['ms']:.4f} ms"
                for name, r in sup_criteria.items()))
        no_grad = check_lstm_no_grad(dev)
        log(f"[supervised lstm] fused_lstm at (8, 128, 256) without "
            f"gradients (a frozen probe's features) launches lstm_fwd "
            f"only and keeps {no_grad['bytes_kept_no_grad']} bytes on the "
            f"card (its outputs); with gradients "
            f"{no_grad['bytes_kept_grad']} bytes until the backward")
        sup_steps = {}
        for kind in SUPERVISED_STEPS:
            start = time.perf_counter()
            err, launches = check_supervised_step(dev, kind)
            sup_steps[kind] = err
            log(f"[supervised step {kind}] card vs cpu at width 64 "
                f"(fp32), max abs err {err:.2e}, "
                f"{time.perf_counter() - start:.1f} s, launches "
                f"{ {k: n for k, n in launches.items() if n} }")
        start = time.perf_counter()
        supervised = {mode: run_supervised(dev, work, mode)
                      for mode in SUPERVISED_STEPS}
        supervised_s = time.perf_counter() - start
        log(f"[supervised] {supervised_s:.1f} s, {card}: one epoch each at "
            f"the CLI defaults with --supervised (speaker: the FLAC corpus; "
            f"phone, ctc: the phone corpus with --pathPhone): " + "; ".join(
                f"{mode} ({r['steps']} steps) {r['median_step_ms']:.3f} "
                f"ms/step, {r['audio_hours_per_hour']:.1f} audio-hours per "
                f"hour, loss {r['loss_train']:.4f} train / "
                f"{r['loss_val']:.4f} val, accuracy {r['acc_train']:.4f} "
                f"train / {r['acc_val']:.4f} val, launches {r['launches']}"
                for mode, r in supervised.items()))
        start = time.perf_counter()
        probes = {probe: run_probe(dev, work, record["checkpoint"], probe)
                  for probe in PROBES}
        probes_s = time.perf_counter() - start
        log(f"[probe] {probes_s:.1f} s, {card}: linear_separability on the "
            f"default epoch's checkpoint, one epoch each (speaker: the FLAC "
            f"corpus; phone, phone_unfrozen (--unfrozen), ctc (--CTC): the "
            f"phone corpus): " + "; ".join(
                f"{probe} ({r['steps']} steps) {r['median_step_ms']:.3f} "
                f"ms/step, best accuracy {r['best_acc']:.4f}, launches "
                f"{r['launches']}" for probe, r in probes.items()))
        log(f"[phase 7] {time.perf_counter() - phase7:.1f} s, the whole "
            f"run so far {time.perf_counter() - t0:.1f} s of the 1,200 s "
            f"limit")

        # phase 8: the discrete-unit path
        phase8 = time.perf_counter()
        units = run_units(dev, work, record["checkpoint"],
                          os.path.join(work, "phones"),
                          os.path.join(work, "phones.item"))
        log_units(units, card)
        log(f"[phase 8] {time.perf_counter() - phase8:.1f} s, the whole "
            f"run so far {time.perf_counter() - t0:.1f} s of the 1,200 s "
            f"limit")

        # phase 9: Common Voices CTC and PER, the hub entry, the host DTW
        phase9 = time.perf_counter()
        common_voices = run_common_voices(dev, work, record["checkpoint"],
                                          card)
        log(f"[phase 9] {time.perf_counter() - phase9:.1f} s, the whole "
            f"run so far {time.perf_counter() - t0:.1f} s of the 1,200 s "
            f"limit")

        # phase 10: the model and criterion modes
        phase10 = time.perf_counter()
        variants = run_variants(dev, work, card)
        log(f"[phase 10] {time.perf_counter() - phase10:.1f} s, the whole "
            f"run so far {time.perf_counter() - t0:.1f} s of the 1,200 s "
            f"limit")

        # phase 11: --precision bf16 and --adam_mu_dtype bf16
        phase11 = time.perf_counter()
        bf16 = run_bf16(dev, work, card, record)
        log(f"[phase 11] {time.perf_counter() - phase11:.1f} s, the whole "
            f"run so far {time.perf_counter() - t0:.1f} s of the 1,200 s "
            f"limit")

        # phase 12: grouped negative pools, batch 64 in groups of 8
        phase12 = time.perf_counter()
        neg_pool = run_neg_pool(dev, work, card, record)
        log(f"[phase 12] {time.perf_counter() - phase12:.1f} s, the whole "
            f"run so far {time.perf_counter() - t0:.1f} s of the 1,200 s "
            f"limit")

        # phase 13: train_mode features, the CCA, bucket_frames and the
        # clustering criteria
        phase13 = time.perf_counter()
        extras = run_feature_extras(dev, work, card, record["checkpoint"])
        log(f"[phase 13] {time.perf_counter() - phase13:.1f} s, the whole "
            f"run so far {time.perf_counter() - t0:.1f} s of the 1,200 s "
            f"limit")

        # phase 14: data-parallel training: one NCCL rank, two gloo ranks
        # on cuda:0, the gathered-pool InfoNCE kernels
        phase14 = time.perf_counter()
        data_parallel = run_data_parallel(dev, work, card, records)
        log(f"[phase 14] {time.perf_counter() - phase14:.1f} s, the whole "
            f"run so far {time.perf_counter() - t0:.1f} s of the 1,200 s "
            f"limit")
    # phase 11's kernels, each with its launches on its own bf16 epoch
    bf16_path = {"ffn_fwd_bf16io": "bf16", "ffn_bwd_bf16io": "bf16",
                 "attention_fwd_bf16io": "bf16_fused",
                 "attention_bwd_bf16io": "bf16_fused",
                 "adam_bf16_moment": "bf16_mu"}
    for k in bf16["kernels"]:
        k["launches"] = bf16["records"][bf16_path[k["name"]]]["launches"][
            k["name"]]
    # each kernel's launches on its own path
    for k in kernels:
        if k["name"] in bf16_path:
            continue
        path = (abx if k["name"] == "dtw" else records["fused"]
                if k["name"] in FUSED_KERNELS else records["fp32"]
                if k["name"] in FP32_FFN else records["wide"]
                if k["name"] in LSTM_GRID else record)
        k["launches"] = path["launches"][k["name"]]
    for key, by_kernel in (("launches_discrete_units", unit_launches(units)),
                           ("launches_common_voices",
                            cv_launches(common_voices)),
                           ("launches_variants",
                            variant_launches_by_kernel(variants)),
                           ("launches_feature_extras",
                            feature_extras_launches(extras))):
        for k in kernels:
            if k["name"] in by_kernel:
                k[key] = by_kernel[k["name"]]

    def epoch(rec):
        return {"steps": len(rec["step_ms"]),
                "median_step_ms": rec["median_step_ms"],
                "median_wait_ms": rec["median_wait_ms"],
                "median_load_ms": rec["median_load_ms"],
                "audio_hours_per_hour": rec["audio_hours_per_hour"],
                "audio_hours_per_hour_with_waits": rec[
                    "audio_hours_per_hour_with_waits"],
                "step_ms_quartiles": statistics.quantiles(rec["step_ms"],
                                                          n=4)}
    kernels += bf16["kernels"]
    # phase 12's grouped plan, with its launches on the batch-64 epoch
    for k in neg_pool["kernels"]:
        k["launches"] = neg_pool["epoch"]["launches"][k["name"]]
    kernels += neg_pool["kernels"]
    # phase 14's gathered pool, with its launches on rank 0 of the
    # two-rank `--global_negatives` epoch
    for k in data_parallel["kernels"]["kernels"]:
        k["launches"] = data_parallel["epoch"]["launches"].get(k["name"], 0)
    kernels += data_parallel["kernels"]["kernels"]
    summary = {
        "kernels": kernels,
        "slice": dict(epoch(record), step_parity_max_abs_err=step_err[
            "bf16mix"]),
        "slice_fused": dict(epoch(records["fused"]),
                            step_parity_max_abs_err=step_err["bf16mix fused"]),
        "slice_fp32": dict(epoch(records["fp32"]),
                           step_parity_max_abs_err=step_err["fp32"]),
        "slice_wide": dict(epoch(records["wide"]),
                           step_parity_max_abs_err=step_err["bf16mix wide"]),
        "slice_profiled": epoch(records["profiled"]),
        **{f"slice_{mode}": epoch(records[mode]) for mode in EPOCHS
           if mode.startswith("augmented")},
        "augment": augment,
        "step_determinism_augmented": determinism_aug,
        "corpus": corpus,
        "profile": trace,
        "resume": resume,
        "dispatch": {"graph_vs_eager": dispatch,
                     "capturable_adam_rel_err": adam_err,
                     "adam_routes": adam_routes,
                     "epochs_vs_single_step": held,
                     **{f"slice_{mode}": epoch(records[mode]) for mode in
                        ("dispatch", "device_augmented",
                         "dispatch_augmented", "dispatch_schedule",
                         "schedule")},
                     "resume": resume_d,
                     "timings": [{k: v for k, v in t.items()
                                  if k not in ("step_ms", "dispatch_ms")}
                                 for t in timings]},
        "step_determinism": determinism,
        "concat": concat,
        "step_determinism_ctc": determinism_ctc,
        "supervised_criteria": sup_criteria,
        "supervised_lstm_no_grad": no_grad,
        "supervised_step_max_abs_err": sup_steps,
        "supervised": supervised,
        "probe": probes,
        "units": units,
        "common_voices": common_voices,
        "variants": {
            "kernels_at_new_shapes": variants["kernels"],
            "steps": variants["steps"],
            "epochs": {g: dict(epoch(r), val_steps=r["val_steps"],
                               launches=r["launches"])
                       for g, r in variants["epochs"].items()},
            "dispatch": variants["dispatch"], "abx": variants["abx"],
            "step_determinism_lfb": variants["determinism_lfb"]},
        "bf16": {k: v for k, v in bf16.items()
                 if k not in ("kernels", "records")},
        "neg_pool": {k: v for k, v in neg_pool.items() if k != "kernels"},
        "feature_extras": extras,
        "data_parallel": {
            **{k: v for k, v in data_parallel.items() if k != "kernels"},
            "kernels": {k: v for k, v in data_parallel["kernels"].items()
                        if k != "kernels"}},
        "default_route_ms": yardsticks,
        "events_ms": events,
        "lstm": details,
        "abx": {k: abx[k] for k in ("scores", "launches", "features_s",
                                    "scoring_s", "flushes", "dtw_pairs",
                                    "dtw_device_ms", "dtw_share_of_scoring",
                                    "kernel_vs_plain_scores",
                                    "feature_max_abs_err", "files")},
    }
    if not all(math.isfinite(v) for k in kernels
               for v in (k["ms"], k["plain_ms"], k["bound_ms"])):
        raise AssertionError("non-finite timing")
    log(f"[total] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
