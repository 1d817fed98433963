"""Hand-written kernels alone at the recipe, by device time.

    python -m cpc2_torch.time_kernels {attention,encoder,infonce} [--iters N]

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
* `encoder`: the recipe's encoder (`CPCEncoder(256)`, norm affines moved
  off 1 and 0) on 16 x 20,480 samples through `fused_encoder` with
  gradients kept (as in training), beside the module's cuDNN route under
  TF32;
* `infonce`: `negative_scores` on preds (8, 12, 116, 256), a pool of
  1,024 rows of 256 and 128 negatives a position from the trainer's own
  `sample_negative_indices`.

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


def device_split(fn, iters: int = 20, warmup: int = WARMUP) -> dict:
    """Device ms per call of `fn` by kernel name, by `torch.profiler`, over
    `iters` calls after `warmup` calls. Every call launches at least one
    kernel, so a profile that holds fewer kernels than half the calls lost
    events (one held 3 of 20): it is taken again, at most twice. (Of the
    LSTM's cluster kernels it holds 19 of 20 launches in most profiles.)"""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _attempt in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        if 2 * sum(e.count for e in kernels) >= iters:
            return {e.key: device_us(e) / 1e3 / iters for e in kernels}
    raise AssertionError(f"the profiler caught fewer device kernels than "
                         f"half of {iters} calls, three times")


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


def time_attention(dev, gen, iters: int) -> dict:
    from .models.transformer import ScaledDotProductAttention
    from .ops.attention import fused_relpos_attention
    n, s, dk, rate = 64, 116, 32, 0.1
    leaves = [torch.randn(n, s, dk, device=dev, generator=gen,
                          requires_grad=True) for _ in range(3)]
    krel = (0.2 * torch.randn(dk, s, device=dev, generator=gen)
            ).requires_grad_(True)
    leaves.append(krel)
    seed = torch.tensor([12345], device=dev, dtype=torch.int32)
    cot = torch.randn(n, s, dk, device=dev, generator=gen)

    def fwd():
        return fused_relpos_attention(*leaves, seed, rate)
    out = fwd()

    def bwd():
        return torch.autograd.grad(out, leaves, cot, retain_graph=True)
    with torch.no_grad():
        f_split = device_split(fwd, iters)
        f_events = event_ms(fwd, iters)
    b_split = device_split(bwd, iters)
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
            "attention_fwd_events_ms": f_events,
            "attention_bwd_events_ms": b_events,
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


TIMERS = {"attention": time_attention, "encoder": time_encoder,
          "infonce": time_infonce}


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
    result = {"card": torch.cuda.get_device_name(0),
              f"{name}_fwd_ms": sum(fwd.values()),
              f"{name}_bwd_ms": sum(bwd.values()),
              f"{name}_fwd_by_kernel": fwd, f"{name}_bwd_by_kernel": bwd,
              **result}
    for what, split in (("forward", fwd), ("backward", bwd)):
        print(f"{name} {what}: {sum(split.values()):.4f} ms per call")
        for key, ms in sorted(split.items(), key=lambda kv: -kv[1]):
            part = (encoder_part(key) or "other") if name == "encoder" else ""
            print(f"  {ms:9.4f}  {part:9s} {key[:90]}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
