"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run with a nonzero exit:

1. print the card's name and power limit (`nvidia-smi`);
2. build the CUDA kernels from `cpc2_torch/csrc` (`cpc2_torch/ops/_build.py`);
3. hold each kernel against its plain PyTorch version at the recipe's
   shapes (B = 8, T = 128, H = 256, K = 12, W = 116, N = 128, D = 256,
   P = 1,024, FFN 256 -> 2048 -> 256 on 928 rows), forward and backward,
   the FFN at dropout 0 and 0.1 with the same seed, and the DTW kernel at
   one ABX flush (18,432 pairs of 32 x 32 frames), a ragged 16 x 64, a
   multi-strip 64 x 64 and its 2,048 x 2,048 limit, where it must be
   bit-identical; then time the kernel, the plain version and, where one
   PyTorch call computes the same function, that call;
4. hold one whole training step on the card (kernels) against the same step
   on the CPU (plain versions) at a small width, same weights, same
   negatives, dropout off;
5. write a synthetic 16 kHz wav corpus in LibriSpeech layout and run
   `cpc2_torch.train.main` at the CLI defaults on it for one epoch
   (batch 8 x 20,480 samples, 256-d, LSTM, 12 transformer heads, 128
   negatives) with `--pathCheckpoint`, with every kernel's launch count set
   to 0 just before and read just after: the LSTM, FFN and InfoNCE kernels
   must have launched, the losses must be finite, the parameters must live
   on the card and the checkpoint files must exist;
6. write a phone corpus with its `.item` file (4 speakers x 8 files x 24
   tokens) and run `cpc2_torch.eval.eval_ABX.main from_checkpoint` on the
   checkpoint of phase 5 at its defaults, the counts again set to 0 just
   before and read just after: the DTW and LSTM forward kernels must have
   launched and both scores must lie in [0, 1]; then score the same
   features on the card with the kernel and with the plain DTW (identical
   scores), and hold two files' features card against CPU;
7. print one `kernels` JSON line and, last, the `ok` line.

It exits nonzero, printing no result, when no CUDA card is available or
when the `cpc2_torch` package is not beside it.
"""

from __future__ import annotations

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

# NVIDIA H100 SXM data sheet: HBM3 rate and fp32 (non-tensor-core) peak.
# The hand-written kernels compute in fp32 on the FMA units.
MEMORY_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

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
    calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float):
    """Least time for the work: bytes over the memory rate or operations
    over the fp32 peak, whichever is larger, and which one it is."""
    t_bytes = n_bytes / MEMORY_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
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
                 n_bytes, flops):
    bound, by = bound_ms(n_bytes, flops)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms}


def check_lstm(dev, gen):
    from cpc2_torch.ops.lstm import fused_lstm, lstm_plain
    b, t, h = 8, 128, 256
    inputs = [torch.randn(b, t, 4 * h, device=dev, generator=gen),
              torch.randn(b, h, device=dev, generator=gen),
              torch.randn(b, h, device=dev, generator=gen),
              torch.randn(4 * h, h, device=dev, generator=gen) / 16,
              torch.randn(4 * h, device=dev, generator=gen) / 16]
    cot = [torch.randn(b, t, h, device=dev, generator=gen),
           torch.randn(b, h, device=dev, generator=gen),
           torch.randn(b, h, device=dev, generator=gen)]
    out_k, grad_k, bwd_k = grads_of(fused_lstm, inputs, cot)
    out_p, grad_p, bwd_p = grads_of(lstm_plain, inputs, cot)
    err_f = compare("lstm forward", out_k, out_p)
    err_b = compare("lstm backward", grad_k, grad_p)

    # cuDNN's LSTM computes the same recurrence when its input is gi and
    # its input weight the identity: the library yardstick.
    cudnn = torch.nn.LSTM(4 * h, h, batch_first=True).to(dev)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(torch.eye(4 * h, device=dev))
        cudnn.bias_ih_l0.zero_()
        cudnn.weight_hh_l0.copy_(inputs[3])
        cudnn.bias_hh_l0.copy_(inputs[4])
    cudnn.weight_ih_l0.requires_grad_(False)
    cudnn.bias_ih_l0.requires_grad_(False)

    def lib_fwd():
        return cudnn(inputs[0], (inputs[1][None], inputs[2][None]))

    x_lib = inputs[0].detach().requires_grad_(True)
    h_lib = inputs[1][None].detach().requires_grad_(True)
    c_lib = inputs[2][None].detach().requires_grad_(True)
    ys_lib, (hl_lib, cl_lib) = cudnn(x_lib, (h_lib, c_lib))
    lib_params = [x_lib, h_lib, c_lib, cudnn.weight_hh_l0, cudnn.bias_hh_l0]

    def lib_bwd():
        return torch.autograd.grad((ys_lib, hl_lib, cl_lib), lib_params,
                                   (cot[0], cot[1][None], cot[2][None]),
                                   retain_graph=True)

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: fused_lstm(*inputs))
        plain_fwd_ms = cuda_ms(lambda: lstm_plain(*inputs), iters=5)
        lib_fwd_ms = cuda_ms(lib_fwd)
    bwd_ms = cuda_ms(bwd_k)
    plain_bwd_ms = cuda_ms(bwd_p, iters=5)
    lib_bwd_ms = cuda_ms(lib_bwd)

    gi, h0, c0, w_hh, b_hh = inputs
    mm = 2 * b * t * 4 * h * h
    # outputs: ys, h_last, c_last, and the cell states and gates it saves
    fwd_bytes = nbytes(*inputs) + nbytes(*out_k) + nbytes(out_k[0], gi)
    bwd_bytes = (nbytes(w_hh, h0, c0) + nbytes(*cot) + nbytes(out_k[0]) * 2
                 + nbytes(gi) + nbytes(*grad_k))
    src, rep = "cpc2_torch/csrc/lstm.cu", "cpc2_tpu/ops/lstm_pallas.py"
    return [
        kernel_entry("lstm_fwd", src, rep + ":166", err_f, fwd_ms,
                     plain_fwd_ms, lib_fwd_ms, fwd_bytes, mm),
        kernel_entry("lstm_bwd", src, rep + ":206", err_b, bwd_ms,
                     plain_bwd_ms, lib_bwd_ms, bwd_bytes, 2 * mm)]


def check_ffn(dev, gen):
    from cpc2_torch.ops.ffn import ffn_plain, fused_ffn
    m, din, dff, dout = 8 * 116, 256, 2048, 256
    inputs = [torch.randn(m, din, device=dev, generator=gen),
              torch.randn(dff, din, device=dev, generator=gen) / 16,
              torch.randn(dff, device=dev, generator=gen) / 16,
              torch.randn(dout, dff, device=dev, generator=gen) / 45,
              torch.randn(dout, device=dev, generator=gen) / 45]
    seed = torch.tensor([12345], device=dev, dtype=torch.int32)
    cot = [torch.randn(m, dout, device=dev, generator=gen)]
    errs = []
    for rate in (0.0, 0.1):
        def kern(*a):
            return fused_ffn(*a, seed, rate)

        def plain(*a):
            return ffn_plain(*a, seed, rate)
        out_k, grad_k, bwd_k = grads_of(kern, inputs, cot)
        out_p, grad_p, bwd_p = grads_of(plain, inputs, cot)
        errs.append((compare(f"ffn forward rate {rate}", out_k, out_p),
                     compare(f"ffn backward rate {rate}", grad_k, grad_p)))
    # the mask kept the expected share of the hidden
    from cpc2_torch.ops.ffn import keep_mask
    kept = keep_mask(seed, m, dff, 0.1).float().mean().item()
    if abs(kept - 0.9) > 0.005:
        raise AssertionError(f"ffn dropout kept {kept:.4f} of the hidden")
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: kern(*inputs))
        plain_fwd_ms = cuda_ms(lambda: plain(*inputs))
    bwd_ms = cuda_ms(bwd_k)
    plain_bwd_ms = cuda_ms(bwd_p)
    gemm = 2 * m * din * dff
    src, rep = "cpc2_torch/csrc/ffn.cu", "cpc2_tpu/ops/ffn_pallas.py"
    return [
        kernel_entry("ffn_fwd", src, rep + ":193",
                     max(e[0] for e in errs), fwd_ms, plain_fwd_ms, None,
                     nbytes(*inputs) + nbytes(*out_k), 2 * gemm),
        kernel_entry("ffn_bwd", src, rep + ":217",
                     max(e[1] for e in errs), bwd_ms, plain_bwd_ms, None,
                     nbytes(*inputs[:4], *cot) + nbytes(*grad_k), 5 * gemm)]


def check_infonce(dev, gen):
    from cpc2_torch.ops.infonce import negative_scores, negative_scores_plain
    b, k, w, n, d, p = 8, 12, 116, 128, 256, 1024
    inputs = [torch.randn(b, k, w, d, device=dev, generator=gen),
              torch.randn(p, d, device=dev, generator=gen)]
    # repeated rows on purpose: half the draws come from 16 pool rows
    idx = torch.randint(0, p, (b, w, n), device=dev, generator=gen,
                        dtype=torch.int32)
    idx[..., ::2] = idx[..., ::2] % 16
    cot = [torch.randn(b, k, w, n, device=dev, generator=gen)]

    def kern(preds, z):
        return negative_scores(preds, z, idx)

    def plain(preds, z):
        return negative_scores_plain(preds, z, idx)
    out_k, grad_k, bwd_k = grads_of(kern, inputs, cot)
    out_p, grad_p, bwd_p = grads_of(plain, inputs, cot)
    err_f = compare("infonce forward", out_k, out_p)
    err_b = compare("infonce backward", grad_k, grad_p)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: kern(*inputs))
        plain_fwd_ms = cuda_ms(lambda: plain(*inputs))
    bwd_ms = cuda_ms(bwd_k)
    plain_bwd_ms = cuda_ms(bwd_p)
    dots = 2 * b * k * w * n * d
    src, rep = "cpc2_torch/csrc/infonce.cu", "cpc2_tpu/ops/infonce_pallas.py"
    return [
        kernel_entry("infonce_fwd", src, rep + ":107", err_f, fwd_ms,
                     plain_fwd_ms, None,
                     nbytes(*inputs, idx) + nbytes(*out_k), dots),
        kernel_entry("infonce_bwd", src, rep + ":170", err_b, bwd_ms,
                     plain_bwd_ms, None,
                     nbytes(*cot, *inputs, idx) + nbytes(*grad_k), 2 * dots)]


def check_dtw(dev, gen):
    """The DTW kernel against its plain version: bit-identical (max abs
    error 0) at one ABX flush, a ragged shape, a multi-strip shape and the
    kernel's limit; timed at the flush. Its bound counts the cells this
    run's lengths need: 4 bytes read and about 20 operations each."""
    from cpc2_torch.ops.dtw import MAX_LEN, dtw_normalized, \
        dtw_normalized_plain

    def inputs(p, s1, s2):
        dist = torch.rand(p, s1, s2, device=dev, generator=gen)
        n1 = torch.randint(1, s1 + 1, (p,), device=dev, generator=gen,
                           dtype=torch.int32)
        n2 = torch.randint(1, s2 + 1, (p,), device=dev, generator=gen,
                           dtype=torch.int32)
        n1[0] = n2[0] = 1
        n1[1], n2[1] = s1, s2
        return dist, n1, n2

    flush = inputs(32 * 24 * 24, 32, 32)
    err = 0.0
    for args in (flush, inputs(4096, 16, 64), inputs(1024, 64, 64),
                 inputs(4, MAX_LEN, MAX_LEN)):
        got = dtw_normalized(*args)
        want = dtw_normalized_plain(*args)
        if not torch.isfinite(got).all():
            raise AssertionError(f"dtw {tuple(args[0].shape)}: non-finite")
        err = max(err, (got.double() - want.double()).abs().max().item())
    if err != 0.0:
        raise AssertionError(f"dtw: kernel differs from plain, max abs err "
                             f"{err:.3e}")
    ms = cuda_ms(lambda: dtw_normalized(*flush))
    plain_ms = cuda_ms(lambda: dtw_normalized_plain(*flush), iters=3,
                       warmup=1)
    dist, n1, n2 = flush
    cells = (n1.double() * n2.double()).sum().item()
    return [kernel_entry("dtw", "cpc2_torch/csrc/dtw.cu",
                         "cpc2_tpu/ops/dtw_pallas.py:163", err, ms, plain_ms,
                         None, 4 * cells + nbytes(n1, n2) + 4 * n1.numel(),
                         20 * cells)]


def check_step(dev) -> float:
    """One training step on the card against the same step on the CPU at a
    small width, same weights and negatives, dropout off: the per-head
    losses and every gradient. The tolerance is 1e-3 of each tensor's
    largest value: the whole network's sums run in other orders on the two
    devices (cuDNN's convolutions among them). Parameters after the Adam
    step are not compared: where a gradient is near zero its first step is
    +-lr times the sign of a rounding error."""
    from cpc2_torch.config import parse_args
    from cpc2_torch.feature_loader import build_model
    from cpc2_torch.train import get_criterion
    from cpc2_torch.training import Trainer, make_optimizer
    args = parse_args(["--pathDB", ".", "--file_extension", ".wav",
                       "--hiddenEncoder", "64", "--hiddenGar", "64",
                       "--nPredicts", "3", "--negativeSamplingExt", "16",
                       "--sizeWindow", "3840", "--random_seed", "0"])
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
        params = list(model.parameters()) + list(crit.parameters())
        trainer = Trainer(model, crit, make_optimizer(args, params))
        losses, _accs = trainer.train_step(batch.to(device), neg.to(device))
        results.append([losses.cpu()] + [p.grad.cpu() for p in params])
    return compare("training step (card vs cpu)", results[1], results[0],
                   rtol=1e-3)


def write_corpus(root: str, n_speakers: int = 4, n_files: int = 3,
                 seconds: float = 24.0, seed: int = 0) -> None:
    """LibriSpeech layout: <speaker>/<chapter>/<speaker>-<chapter>-<n>.wav,
    16 kHz PCM16, each file a speaker-specific tone mix plus noise."""
    from cpc2_torch.data.audio_io import save_wav
    rs = np.random.RandomState(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    for s in range(n_speakers):
        spk, chap = str(1000 + s), str(100 + s)
        folder = os.path.join(root, spk, chap)
        os.makedirs(folder)
        f0 = 90.0 + 37.0 * s
        for i in range(n_files):
            x = (0.2 * np.sin(2 * np.pi * f0 * t * (1 + 0.01 * i))
                 + 0.1 * np.sin(2 * np.pi * 3.1 * f0 * t)
                 + 0.05 * rs.randn(n))
            save_wav(os.path.join(folder, f"{spk}-{chap}-{i:04d}.wav"),
                     x.astype(np.float32), 16000)


TRAINING_KERNELS = ("lstm_fwd", "lstm_bwd", "ffn_fwd", "ffn_bwd",
                    "infonce_fwd", "infonce_bwd")
ABX_KERNELS = ("dtw", "lstm_fwd")


def check_launched(path: str, launches: dict, kernels) -> None:
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: "
                             f"{missing}")


def run_training(dev, work: str) -> dict:
    """One epoch at the CLI defaults with `--pathCheckpoint <work>/ck`."""
    from cpc2_torch.ops import _build
    from cpc2_torch.train import main
    root = os.path.join(work, "train_db")
    ck = os.path.join(work, "ck")
    write_corpus(root)
    _build.reset_launches()
    record = main(["--pathDB", root, "--file_extension", ".wav",
                   "--nEpoch", "1", "--random_seed", "0",
                   "--n_process_loader", "2", "--logging_step", "10",
                   "--pathCheckpoint", ck])
    launches = dict(_build.LAUNCHES)
    check_launched("training", launches, TRAINING_KERNELS)
    for name in ("checkpoint_0.pt", "checkpoint_args.json",
                 "checkpoint_logs.json"):
        if not os.path.exists(os.path.join(ck, name)):
            raise AssertionError(f"the trainer wrote no {name}")
    logs = record["logs"]
    for key in ("locLoss_train", "locAcc_train", "locLoss_val"):
        values = np.asarray(logs[key], dtype=np.float64)
        if values.shape != (1, 12) or not np.isfinite(values).all():
            raise AssertionError(f"{key}: {values}")
    if len(record["step_ms"]) < 5:
        raise AssertionError(f"only {len(record['step_ms'])} steps ran")
    if set(record["param_devices"]) != {str(dev)}:
        raise AssertionError(f"parameters on {record['param_devices']}")
    record["launches"] = launches
    record["checkpoint"] = os.path.join(ck, "checkpoint_0.pt")
    return record


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
    length. Returns the `.item` path."""
    from cpc2_torch.data.audio_io import save_wav
    sr, sil = 16000, 0.12
    lines = ["#file onset offset #phone prev-phone next-phone speaker"]
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
            wav, t = [], 0.0
            for tok, dur in tokens:
                n = int(round(dur * sr))
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
    item = os.path.join(os.path.dirname(root), "phones.item")
    with open(item, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return item


def run_abx(dev, work: str, checkpoint: str) -> dict:
    """`eval_ABX from_checkpoint` on the card at its defaults, then the
    scoring held against itself with the plain DTW on the same features,
    and two files' features card against CPU."""
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
    err = compare("features (card vs cpu)",
                  [torch.from_numpy(card[p]) for p in paths[:2]],
                  [torch.from_numpy(build_feature(cpu, p)) for p in paths[:2]],
                  rtol=1e-3)
    return {"scores": scores, "launches": launches, "features_s":
            run["features_s"], "scoring_s": run["scoring_s"],
            "flushes": run["flushes"], "dtw_pairs": run["dtw_pairs"],
            "kernel_vs_plain_scores": kernel_scores,
            "feature_max_abs_err": err,
            "files": len(paths), "dtw_calls": len(events),
            "dtw_device_ms": dtw_ms,
            "dtw_share_of_scoring": dtw_ms / 1e3 / timed_scoring_s}


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

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kernels = []
    for check in (check_lstm, check_ffn, check_infonce, check_dtw):
        start = time.perf_counter()
        kernels += check(dev, gen)
        log(f"[{check.__name__}] {time.perf_counter() - start:.1f} s")
    for k in kernels:
        log(f"  {k['name']:12s} err {k['max_abs_err']:.2e}  kernel "
            f"{k['ms']:.4f} ms  plain {k['plain_ms']:.4f} ms  library "
            f"{k['library_ms']} ms  bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']})")

    start = time.perf_counter()
    step_err = check_step(dev)
    log(f"[check_step] max abs err {step_err:.2e}, "
        f"{time.perf_counter() - start:.1f} s")

    with tempfile.TemporaryDirectory() as work:
        start = time.perf_counter()
        record = run_training(dev, work)
        log(f"[train] {time.perf_counter() - start:.1f} s, "
            f"launches {record['launches']}")
        start = time.perf_counter()
        abx = run_abx(dev, work, record["checkpoint"])
        log(f"[abx] {time.perf_counter() - start:.1f} s, scores "
            f"{abx['scores']}, {abx['files']} files: features "
            f"{abx['features_s']:.3f} s, scoring {abx['scoring_s']:.3f} s "
            f"in {abx['flushes']} flushes, launches {abx['launches']}, "
            f"DTW {abx['dtw_device_ms']:.3f} ms in {abx['dtw_calls']} calls "
            f"({100 * abx['dtw_share_of_scoring']:.1f}% of scoring), "
            f"card-vs-cpu features {abx['feature_max_abs_err']:.2e}")
    # each kernel's launches on its own path
    for k in kernels:
        k["launches"] = (abx if k["name"] == "dtw"
                         else record)["launches"][k["name"]]
    step_ms = record["step_ms"]
    summary = {
        "kernels": kernels,
        "slice": {"steps": len(step_ms),
                  "median_step_ms": record["median_step_ms"],
                  "audio_hours_per_hour": record["audio_hours_per_hour"],
                  "step_ms_quartiles": statistics.quantiles(step_ms, n=4),
                  "step_parity_max_abs_err": step_err},
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
