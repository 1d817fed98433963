"""Hand-written kernels alone at the recipe, by device time.

    python -m cpc2_torch.time_kernels \
        {attention,attention_bf16io,dtw,encoder,ffn_bf16io,infonce,lstm} \
        [--iters N]

Draws one call's inputs of the recipe from seed 0 on the card, then
profiles `--iters` forward calls and `--iters` backward calls of the
kernels' wrapper with `torch.profiler`, and prints the device ms per call
of each, split by kernel (the encoder's by part: layers 2-5's products,
the norms, the sums of partials, layer 1: `profile_step.encoder_part`),
as text and as one JSON line:

* `attention`: one head call (64 units of 116 steps, dk = 32: batch 8 x 8
  blocks of the sequence, `Krelpos` at 0.2 of a normal draw, dropout 0.1)
  of `fused_relpos_attention`, the forward without gradients and the
  backward by `torch.autograd.grad` on a kept graph, with CUDA-event ms
  per call beside (host included) and the same work through the module's
  shift-trick route (`ScaledDotProductAttention`, the port's default path);
* `attention_bf16io`: the same with bf16 q, k, v and cotangent (the heads
  under `--precision bf16`): the bf16-in/bf16-out kernels, beside the
  module's torch route on the same bf16 inputs; this and `attention`, and
  `ffn_bf16io`, print each kernel's launches a call beside its time, and
  the route's time beside the call's;
* `dtw`: `dtw_normalized` (forward only) at DTW_SHAPES: (a) one ABX
  flush of 18,432 pairs of 32 x 32 frames, lengths uniform in [1, 32];
  (b) a real flush's layout, 32 groups of 24 x rows by 24 a/b rows, 32 x
  16 frames, x lengths in [17, 32], a/b lengths in [9, 16], the last
  quarter of each group's rows dummies of length 1 as `_pad_group` leaves
  them; (c) 1,024 pairs of 64 x 64; (d) 256 pairs of 128 x 128 and 64 of
  512 x 512; (e) 4 pairs of 2,048 x 2,048, (c)-(e) at full length. Each
  with device ms by kernel, CUDA-event ms (host included), launches a
  call by counter, and its bound: 4 bytes a cell the lengths need plus
  the lengths and the output over the memory rate, or 20 operations a
  cell over the fp32 rate, the larger. At (a) and (b) also the device
  ms of `torch.argsort` of the pairs' lengths, what ordering the pairs
  by length would add to a call;
* `encoder`: the recipe's encoder (`CPCEncoder(256)`, norm affines moved
  off 1 and 0) on 16 x 20,480 samples through `fused_encoder` with
  gradients kept (as in training), beside the module's cuDNN route under
  TF32;
* `ffn_bf16io`: `fused_ffn` on a bf16 x at the recipe (928 x 256 -> 2048
  -> 256, dropout 0.1, one head's call under `--precision bf16`), the
  forward without gradients and the backward on a kept graph, CUDA-event
  ms beside, and the same products as bf16 `torch.matmul` with the
  epilogues as torch ops (the library route, forward and backward);
* `infonce`: `negative_scores` on preds (8, 12, 116, 256), a pool of
  1,024 rows of 256 and 128 negatives a position from the trainer's own
  `sample_negative_indices`;
* `lstm`: `fused_lstm` (the route `lstm_plan` picks) at (B, T, H) = (8,
  128, 512), then (8, 128, 256) and (8, 128, 1024), the backward with its
  dW_hh product and db_hh sum, beside cuDNN's `nn.LSTM` with an identity
  input weight (which adds the input projection, 2 B T (4H)^2 FLOPs, to
  the same recurrence), TF32 off; with each shape's kernel launches per
  call, the profiler's count of each kernel, and device ms per time step.

Run it from the root of each of two checkouts in one call on the card to
compare them (with this file copied into the older one). It needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from .profile_step import device_kernels, device_us, encoder_part, \
    encoder_parts

WARMUP = 3
# profiles taken of one timing before it fails (see `device_split`)
PROFILE_ATTEMPTS = 6


class ProfilerLostKernels(RuntimeError):
    """Every profile of a `device_split` lost more than half the calls'
    kernels."""


def device_split(fn, iters: int = 20, warmup: int = WARMUP,
                 counts: bool = False, expect: str = ""):
    """Device ms per call of `fn` by kernel name, by `torch.profiler`, over
    `iters` calls after `warmup` calls; with `counts`, also how many of
    each kernel the profile holds. Every call launches the same kernels,
    so a profile in which a kernel's count is not a multiple of `iters`,
    or (with `expect`) which holds no kernel whose name contains `expect`,
    lost events: it is taken again, up to PROFILE_ATTEMPTS profiles in all,
    and the last one is kept if it holds the expected kernel and at least
    half the calls' kernels. (Profiles have held 19 of 20 launches of the
    LSTM's cluster and grid kernels, and one of the grid kernels read half
    its time then; one held 3 of 20 InfoNCE forwards; three in a row lost
    LSTM launches on an H100 80GB HBM3; some lost every launch of the
    LSTM's backward walk while its other kernels' counts stayed whole,
    which only `expect` sees.)"""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # device activity only: the host's events are not read here, and
    # aggregating them (`key_averages`) cost seconds a profile
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(PROFILE_ATTEMPTS):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        # a profile that holds no device kernel at all lost them all
        seen = any(expect in e.key for e in kernels)
        whole = seen and all(e.count % iters == 0 for e in kernels)
        if whole or (seen and attempt == PROFILE_ATTEMPTS - 1 and
                     2 * sum(e.count for e in kernels) >= iters):
            split = {e.key: device_us(e) / 1e3 / iters for e in kernels}
            return (split, {e.key: e.count for e in kernels}) if counts \
                else split
    raise ProfilerLostKernels(f"the profiler caught fewer device kernels "
                              f"than half of {iters} calls"
                              + (f", or no {expect}" if expect else "")
                              + f", {PROFILE_ATTEMPTS} times")


def event_ms(fn, iters: int = 20, warmup: int = WARMUP) -> float:
    """Mean ms per call of `fn` on the card, by CUDA events over `iters`
    back-to-back calls after `warmup` calls (the host's path included)."""
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


def encoder_inputs(dev, gen, n: int, t: int, c: int):
    """`CPCEncoder(c)` from torch's seed 0 with its norm affines moved off
    1 and 0, its 20 parameters (conv weights, conv biases, norm weights,
    norm biases), an input (n, t) and a cotangent (n, t // 160, c), all
    drawn from `gen` on `dev`."""
    from .models.encoder import CPCEncoder
    torch.manual_seed(0)
    module = CPCEncoder(c).to(dev)
    with torch.no_grad():
        for i in range(5):
            norm = getattr(module, f"batchNorm{i}")
            norm.weight.add_(0.1 * torch.randn(norm.weight.shape, device=dev,
                                               generator=gen))
            norm.bias.add_(0.1 * torch.randn(norm.bias.shape, device=dev,
                                             generator=gen))
    params = [getattr(getattr(module, f"{name}{i}"), attr)
              for name, attr in (("conv", "weight"), ("conv", "bias"),
                                 ("batchNorm", "weight"),
                                 ("batchNorm", "bias"))
              for i in range(5)]
    x = 0.1 * torch.randn(n, t, device=dev, generator=gen)
    cot = torch.randn(n, t // 160, c, device=dev, generator=gen)
    return module, params, x, cot


def per_call(counts: dict, iters: int) -> dict:
    """A profile's kernel counts as launches a call."""
    return {key: n / iters for key, n in counts.items()}


def time_attention(dev, gen, iters: int,
                   dtype: torch.dtype = torch.float32) -> dict:
    from .models.transformer import ScaledDotProductAttention
    from .ops.attention import fused_relpos_attention
    n, s, dk, rate = 64, 116, 32, 0.1
    leaves = [torch.randn(n, s, dk, device=dev, generator=gen).to(
        dtype).requires_grad_(True) for _ in range(3)]
    krel = (0.2 * torch.randn(dk, s, device=dev, generator=gen)
            ).requires_grad_(True)
    leaves.append(krel)
    seed = torch.tensor([12345], device=dev, dtype=torch.int32)
    cot = torch.randn(n, s, dk, device=dev, generator=gen).to(dtype)

    def fwd():
        return fused_relpos_attention(*leaves, seed, rate)
    out = fwd()

    def bwd():
        return torch.autograd.grad(out, leaves, cot, retain_graph=True)
    with torch.no_grad():
        f_split, f_counts = device_split(fwd, iters, counts=True)
        f_events = event_ms(fwd, iters)
    b_split, b_counts = device_split(bwd, iters, counts=True)
    b_events = event_ms(bwd, iters)

    module = ScaledDotProductAttention(s, dk, rate, relpos=True).to(dev)
    with torch.no_grad():
        module.Krelpos.copy_(krel)
    qkv = leaves[:3]
    out_m = module(*qkv, gen)
    with torch.no_grad():
        r_fwd = sum(device_split(lambda: module(*qkv, gen),
                                 iters).values())
    r_bwd = sum(device_split(lambda: torch.autograd.grad(
        out_m, qkv + [module.Krelpos], cot, retain_graph=True),
        iters).values())
    return {"fwd": f_split, "bwd": b_split,
            "fwd_launches": per_call(f_counts, iters),
            "bwd_launches": per_call(b_counts, iters),
            "attention_fwd_events_ms": f_events,
            "attention_bwd_events_ms": b_events,
            "route_fwd_ms": r_fwd, "route_bwd_ms": r_bwd}


def time_attention_bf16io(dev, gen, iters: int) -> dict:
    return time_attention(dev, gen, iters, torch.bfloat16)


def time_ffn_bf16io(dev, gen, iters: int) -> dict:
    from .ops.ffn import fused_ffn, keep_mask
    m, din, dff, dout, rate = 8 * 116, 256, 2048, 256, 0.1
    x = torch.randn(m, din, device=dev, generator=gen).to(
        torch.bfloat16).requires_grad_(True)
    ws = [(torch.randn(*shape, device=dev, generator=gen) / scale
           ).requires_grad_(True)
          for shape, scale in (((dff, din), 16), ((dff,), 16),
                               ((dout, dff), 45), ((dout,), 45))]
    seed = torch.tensor([12345], device=dev, dtype=torch.int32)
    cot = torch.randn(m, dout, device=dev, generator=gen).to(torch.bfloat16)
    leaves = [x] + ws

    def fwd():
        return fused_ffn(*leaves, seed, rate, True)
    out = fwd()

    def bwd():
        return torch.autograd.grad(out, leaves, cot, retain_graph=True)
    with torch.no_grad():
        f_split, f_counts = device_split(fwd, iters, counts=True)
        f_events = event_ms(fwd, iters)
    b_split, b_counts = device_split(bwd, iters, counts=True)
    b_events = event_ms(bwd, iters)

    # the library route: the products as bf16 `torch.matmul`, the bias,
    # ReLU, dropout and their gradients as torch ops
    keep = keep_mask(seed, m, dff, rate) / (1.0 - rate)
    w1b, w2b = ws[0].detach().to(torch.bfloat16), ws[2].detach().to(
        torch.bfloat16)
    xd = x.detach()

    def route_fwd():
        h = (torch.relu((xd @ w1b.t()).float() + ws[1].detach()) * keep).to(
            torch.bfloat16)
        return ((h @ w2b.t()).float() + ws[3].detach()).to(torch.bfloat16), h

    with torch.no_grad():
        _y, h = route_fwd()

        def route_bwd():
            dh = ((cot @ w2b).float() * ((h > 0) * keep)).to(torch.bfloat16)
            return (dh @ w1b, dh.t() @ xd, dh.float().sum(0), cot.t() @ h,
                    cot.float().sum(0))
        r_fwd = sum(device_split(route_fwd, iters).values())
        r_bwd = sum(device_split(route_bwd, iters).values())
    return {"fwd": f_split, "bwd": b_split,
            "fwd_launches": per_call(f_counts, iters),
            "bwd_launches": per_call(b_counts, iters),
            "ffn_fwd_bf16io_events_ms": f_events,
            "ffn_bwd_bf16io_events_ms": b_events,
            "route_fwd_ms": r_fwd, "route_bwd_ms": r_bwd}


def time_encoder(dev, gen, iters: int) -> dict:
    from .ops.encoder import fused_encoder
    module, params, x, cot = encoder_inputs(dev, gen, 16, 20480, 256)
    x.requires_grad_(True)
    groups = [params[0:5], params[5:10], params[10:15], params[15:20]]
    out = fused_encoder(x, *groups)
    fwd = device_split(lambda: fused_encoder(x, *groups), iters)
    bwd = device_split(lambda: torch.autograd.grad(
        out, [x] + params, cot, retain_graph=True), iters)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        out_m = module(x)
        route_fwd = device_split(lambda: module(x), iters)
        route_bwd = device_split(lambda: torch.autograd.grad(
            out_m, [x] + params, cot, retain_graph=True), iters)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return {"fwd": fwd, "bwd": bwd,
            "encoder_fwd_by_part": encoder_parts(fwd),
            "encoder_bwd_by_part": encoder_parts(bwd),
            "cudnn_tf32_fwd_ms": sum(route_fwd.values()),
            "cudnn_tf32_bwd_ms": sum(route_bwd.values())}


def time_infonce(dev, gen, iters: int) -> dict:
    from .losses import sample_negative_indices
    from .ops.infonce import negative_scores
    b, k, w, n, d, p = 8, 12, 116, 128, 256, 1024
    preds = torch.randn(b, k, w, d, device=dev, generator=gen,
                        requires_grad=True)
    z = torch.randn(p, d, device=dev, generator=gen, requires_grad=True)
    idx = sample_negative_indices(gen, b, p // b, n, w, dev).transpose(
        1, 2).contiguous()
    g = torch.randn(b, k, w, n, device=dev, generator=gen)
    out = negative_scores(preds, z, idx)
    with torch.no_grad():
        fwd = device_split(lambda: negative_scores(preds, z, idx), iters)
    bwd = device_split(lambda: torch.autograd.grad(out, (preds, z), g,
                                                   retain_graph=True), iters)
    return {"fwd": fwd, "bwd": bwd}


# (B, T, H) of the `lstm` timer: a 512-wide model's training batch first
LSTM_SHAPES = ((8, 128, 512), (8, 128, 256), (8, 128, 1024))


def lstm_inputs(dev, gen, b: int, t: int, h: int):
    """`fused_lstm`'s five inputs (gi, h0, c0, w_hh, b_hh) and the three
    cotangents (ys, h_last, c_last), drawn from `gen` on `dev`."""
    return ([torch.randn(b, t, 4 * h, device=dev, generator=gen),
             torch.randn(b, h, device=dev, generator=gen),
             torch.randn(b, h, device=dev, generator=gen),
             torch.randn(4 * h, h, device=dev, generator=gen) / 16,
             torch.randn(4 * h, device=dev, generator=gen) / 16],
            [torch.randn(b, t, h, device=dev, generator=gen),
             torch.randn(b, h, device=dev, generator=gen),
             torch.randn(b, h, device=dev, generator=gen)])


def cudnn_lstm(inputs, cot):
    """cuDNN's `nn.LSTM` computing the same recurrence: its input is gi and
    its input weight the identity. Returns (forward, backward) callables;
    the backward takes the gradients of gi, h0, c0, W_hh and b_hh."""
    gi, h0, c0, w_hh, b_hh = (x.detach() for x in inputs)
    h = h0.shape[-1]
    lstm = torch.nn.LSTM(4 * h, h, batch_first=True).to(gi.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(4 * h, device=gi.device))
        lstm.bias_ih_l0.zero_()
        lstm.weight_hh_l0.copy_(w_hh)
        lstm.bias_hh_l0.copy_(b_hh)
    lstm.weight_ih_l0.requires_grad_(False)
    lstm.bias_ih_l0.requires_grad_(False)
    x = gi.clone().requires_grad_(True)
    hc = [h0[None].clone().requires_grad_(True),
          c0[None].clone().requires_grad_(True)]
    ys, (h_last, c_last) = lstm(x, tuple(hc))
    leaves = [x, *hc, lstm.weight_hh_l0, lstm.bias_hh_l0]

    def fwd():
        return lstm(x, tuple(hc))

    def bwd():
        return torch.autograd.grad((ys, h_last, c_last), leaves,
                                   (cot[0], cot[1][None], cot[2][None]),
                                   retain_graph=True)
    return fwd, bwd


def time_lstm(dev, gen, iters: int) -> dict:
    from .ops import _build
    from .ops.lstm import fused_lstm
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {}
    try:
        for b, t, h in LSTM_SHAPES:
            inputs, cot = lstm_inputs(dev, gen, b, t, h)
            leaves = [x.requires_grad_(True) for x in inputs]
            outs = fused_lstm(*leaves)

            def fwd():
                with torch.no_grad():
                    return fused_lstm(*leaves)

            def bwd():
                return torch.autograd.grad(outs, leaves, cot,
                                           retain_graph=True)
            launches = []
            for fn in (fwd, bwd):
                _build.reset_launches()
                fn()
                launches.append({k: n for k, n in _build.LAUNCHES.items()
                                 if n})
            f_split, f_count = device_split(fwd, iters, counts=True,
                                            expect="lstm_fwd")
            b_split, b_count = device_split(bwd, iters, counts=True,
                                            expect="lstm_bwd")
            lib_fwd, lib_bwd = cudnn_lstm(inputs, cot)
            with torch.no_grad():
                lib_f = sum(device_split(lib_fwd, iters).values())
            lib_b = sum(device_split(lib_bwd, iters).values())
            fwd_ms, bwd_ms = sum(f_split.values()), sum(b_split.values())
            result[f"({b},{t},{h})"] = {
                "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                "fwd_ms_per_time_step": fwd_ms / t,
                "bwd_ms_per_time_step": bwd_ms / t,
                "fwd_by_kernel": f_split, "bwd_by_kernel": b_split,
                "fwd_kernel_count": f_count, "bwd_kernel_count": b_count,
                "fwd_launches_per_call": launches[0],
                "bwd_launches_per_call": launches[1],
                "cudnn_fwd_ms": lib_f, "cudnn_bwd_ms": lib_b}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    first = result[f"({','.join(map(str, LSTM_SHAPES[0]))})"]
    return {"fwd": first["fwd_by_kernel"], "bwd": first["bwd_by_kernel"],
            "shapes": result}


# The card's memory rate and fp32 peak (NVIDIA H100 SXM data sheet), for
# the DTW shapes' bounds.
MEMORY_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# (name, pairs, S1, S2) of the `dtw` timer; `flush_layout` draws (b)
DTW_SHAPES = (("a", 18432, 32, 32), ("b", 18432, 32, 16),
              ("c", 1024, 64, 64), ("d", 256, 128, 128), ("d", 64, 512, 512),
              ("e", 4, 2048, 2048))


def flush_layout(dev, gen, groups: int = 32, nx: int = 24, nr: int = 24,
                 s1: int = 32, s2: int = 16):
    """The lengths of one real ABX flush's pairs, as `_score_groups` lays
    them out: (group, x row, a/b row), x lengths in [s1 / 2 + 1, s1], a/b
    lengths in [s2 / 2 + 1, s2], the last quarter of each group's rows
    dummies of length 1."""
    lx = torch.randint(s1 // 2 + 1, s1 + 1, (groups, nx), device=dev,
                       generator=gen, dtype=torch.int32)
    lr = torch.randint(s2 // 2 + 1, s2 + 1, (groups, nr), device=dev,
                       generator=gen, dtype=torch.int32)
    lx[:, nx - nx // 4:] = 1
    lr[:, nr - nr // 4:] = 1
    n1 = lx[:, :, None].expand(groups, nx, nr).reshape(-1)
    n2 = lr[:, None, :].expand(groups, nx, nr).reshape(-1)
    return n1.contiguous(), n2.contiguous()


def dtw_inputs(dev, gen, name: str, p: int, s1: int, s2: int):
    """(dist, n1, n2) of one DTW_SHAPES entry, drawn from `gen`: dist
    uniform in [0, 1)."""
    dist = torch.rand(p, s1, s2, device=dev, generator=gen)
    if name == "a":
        n1, n2 = (torch.randint(1, s + 1, (p,), device=dev, generator=gen,
                                dtype=torch.int32) for s in (s1, s2))
    elif name == "b":
        n1, n2 = flush_layout(dev, gen, s1=s1, s2=s2)
    else:
        n1 = torch.full((p,), s1, device=dev, dtype=torch.int32)
        n2 = torch.full((p,), s2, device=dev, dtype=torch.int32)
    return dist, n1, n2


def dtw_bound_ms(n1, n2) -> tuple:
    """The least time of a DTW call: the cells its lengths need, 4 bytes
    read and 20 operations each, plus the lengths read and the output
    written; bytes over the memory rate or operations over the fp32 peak,
    the larger, and which one it is."""
    cells = (n1.double() * n2.double()).sum().item()
    t_bytes = (4 * cells + 12 * n1.numel()) / MEMORY_BYTES_PER_S * 1e3
    t_ops = 20 * cells / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_dtw(dev, gen, iters: int) -> dict:
    from .ops import _build
    from .ops.dtw import dtw_normalized
    result = {}
    for name, p, s1, s2 in DTW_SHAPES:
        args = dtw_inputs(dev, gen, name, p, s1, s2)
        _build.reset_launches()
        dtw_normalized(*args)
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        split = device_split(lambda: dtw_normalized(*args), iters)
        bound, by = dtw_bound_ms(args[1], args[2])
        entry = {"ms": sum(split.values()), "by_kernel": split,
                 "events_ms": event_ms(lambda: dtw_normalized(*args), iters),
                 "launches_per_call": launches, "bound_ms": bound,
                 "bound_by": by}
        if name in ("a", "b"):
            key = args[1] * (s2 + 1) + args[2]
            entry["argsort_ms"] = sum(device_split(
                lambda: torch.argsort(key), iters).values())
        result[f"({name}) {p} x {s1} x {s2}"] = entry
    first = next(iter(result.values()))
    return {"fwd": first["by_kernel"], "bwd": {}, "shapes": result}


TIMERS = {"attention": time_attention,
          "attention_bf16io": time_attention_bf16io, "dtw": time_dtw,
          "encoder": time_encoder, "ffn_bf16io": time_ffn_bf16io,
          "infonce": time_infonce, "lstm": time_lstm}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("kernels", choices=sorted(TIMERS))
    parser.add_argument("--iters", type=int, default=50)
    opts = parser.parse_args(argv)
    # the modules' own routes are the yardsticks: never the opt-in kernels
    for switch in ("CPC2_FUSED_ATTENTION", "CPC2_FUSED_ENCODER"):
        os.environ.pop(switch, None)
    from .ops import _build
    _build.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    result = TIMERS[opts.kernels](dev, gen, opts.iters)
    fwd, bwd = result.pop("fwd"), result.pop("bwd")
    name = opts.kernels
    times = {f"{name}_{what}_{key}": value
             for what, split in (("fwd", fwd), ("bwd", bwd)) if split
             for key, value in (("ms", sum(split.values())),
                                ("by_kernel", split))}
    result = {"card": torch.cuda.get_device_name(0), **times, **result}
    for shape, r in result.get("shapes", {}).items():
        if name == "dtw":
            print(f"dtw at {shape}: {r['ms']:.4f} ms device "
                  f"{ {k[:40]: round(v, 4) for k, v in r['by_kernel'].items()} }, "
                  f"events {r['events_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
                  f"ms ({r['bound_by']}), launches a call "
                  f"{r['launches_per_call']}"
                  + (f", argsort {r['argsort_ms']:.4f} ms"
                     if "argsort_ms" in r else ""))
            continue
        print(f"{name} at {shape}: fwd {r['fwd_ms']:.4f} ms "
              f"({r['fwd_ms_per_time_step'] * 1e3:.3f} us a time step), bwd "
              f"{r['bwd_ms']:.4f} ms ({r['bwd_ms_per_time_step'] * 1e3:.3f} "
              f"us), cuDNN {r['cudnn_fwd_ms']:.4f} / {r['cudnn_bwd_ms']:.4f} "
              f"ms; launches a call {r['fwd_launches_per_call']} / "
              f"{r['bwd_launches_per_call']}; kernels in the profile of "
              f"{opts.iters} calls {r['fwd_kernel_count']} / "
              f"{r['bwd_kernel_count']}")
    for what, tag, split in (("forward", "fwd", fwd),
                             ("backward", "bwd", bwd)):
        if not split:
            continue
        launches = result.get(f"{tag}_launches", {})
        print(f"{name} {what}: {sum(split.values()):.4f} ms per call"
              + (f", route {result[f'route_{tag}_ms']:.4f} ms"
                 if f"route_{tag}_ms" in result else ""))
        for key, ms in sorted(split.items(), key=lambda kv: -kv[1]):
            part = (encoder_part(key) or "other") if name == "encoder" else ""
            count = (f"{launches[key]:g} a call" if key in launches
                     else "")
            print(f"  {ms:9.4f}  {part:9s} {count:10s} {key[:90]}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
