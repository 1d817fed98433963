"""Where a training step's time goes on the card.

    python -m cpc2_torch.profile_step [--steps 10] [--trace out.json] \
        [--precision bf16mix|fp32|bf16] [--adam_mu_dtype fp32|bf16] \
        [--hiddenEncoder 256] [--hiddenGar 256] [--batchSizeGPU 8] \
        [--neg_pool_group 0]

`--batchSizeGPU 64 --neg_pool_group 8` profiles the batch-64 step whose
negatives are drawn in groups of 8 (the InfoNCE kernels' grouped plan).
`--hiddenEncoder 512 --hiddenGar 512` profiles a 512-wide model's step,
whose LSTM takes the grid route (`ops/lstm.py:lstm_plan`). With
CPC2_FUSED_ATTENTION=1 and CPC2_FUSED_ENCODER=1 in the environment it
profiles the step through the opt-in attention and encoder kernels.
`--precision bf16` profiles the heads in bf16 activations (the FFN's and,
opt-in, the attention's bf16-in/bf16-out kernels, counted in their
groups), `--adam_mu_dtype bf16` the bf16-moment Adam kernel.

Builds the recipe model and criterion (the trainer's defaults: batch 8 x
20,480 samples, 256-d encoder and LSTM, 12 transformer heads, 128
negatives) from a seed, feeds random batches made with numpy, and after
warm-up steps:

* times `--steps` steps on the host clock, each ending in a device
  synchronise (ms/step), and the same steps split into forward, backward
  and optimizer phases, each ending in a synchronise;
* profiles the same number of steps with `torch.profiler` and prints the
  device time per step, its share of the wall time, the share of the
  port's hand-written kernels, of the FFN's kernels (the bf16 route's, or
  under `--precision fp32` the fp32 route's), of the LSTM's kernels, of
  InfoNCE's, of the opt-in attention's and of the opt-in encoder's (by
  part: layers 2-5's products, norms, sums, layer 1), of the bf16-moment
  Adam's, the device kernel
  launches per step, the launches per step of each of the port's kernel
  wrappers, and the kernels that take the most device time.

It needs a CUDA card. `trace_summary` reads such a trace, or one that
`python -m cpc2_torch.train --profile_dir` writes.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from .config import parse_args
from .feature_loader import build_model
from .ops import _build
from .train import get_criterion
from .training import Trainer, make_optimizer, resolve_device, set_precision

WARMUP_STEPS = 3
TOP_KERNELS = 15
# Name fragments of the port's kernels in `csrc/*.cu`: the FFN's bf16 route
# (`--precision bf16mix`) and its fp32 route (`--precision fp32`; the
# partials' sum is shared, and only one route runs in a step), the LSTM's
# walks (every kernel of `csrc/lstm.cu` is named `lstm_*`, in this tree and
# in older ones) with its dW_hh product (`gemm_kernel`) and db_hh sum
# (`colsum_kernel`), then the rest.
FFN_KERNELS = ("ffn_wgmma_gemm", "ffn_cast_bf16", "ffn_sum_partials")
FFN_FP32_KERNELS = ("ffn_tf32x3_gemm", "ffn_split_tf32", "ffn_sum_partials")
LSTM_KERNELS = ("lstm_", "gemm_kernel", "colsum_kernel")
INFONCE_KERNELS = ("gathered_fwd", "gathered_bwd", "dz_sum")
# The opt-in encoder's kernels (`csrc/encoder.cu`): layers 2-5's products
# (`conv_wgmma_gemm`), the norms, the sums of partials and layer 1's SIMT
# kernels (`conv_gemm`, `conv_wgrad`, `input_taps`, `input_overlap`).
ENCODER_KERNELS = ("conv_wgmma_gemm", "norm_fwd", "norm_bwd", "sum_rows",
                   "conv_gemm", "conv_wgrad", "input_taps", "input_overlap")
# The opt-in attention's kernels (`csrc/attention.cu`): the forward, the
# backward and its sum of the units' dKrelpos partials (the fragments also
# match the older scalar kernels' names, for runs of an older tree).
ATTENTION_KERNELS = ("attention_fwd", "attention_bwd", "relpos_grad_sum")
# `--adam_mu_dtype bf16`'s update (`csrc/adam.cu`)
ADAM_KERNELS = ("adam_bf16_moment",)
PORT_KERNELS = FFN_KERNELS + FFN_FP32_KERNELS + LSTM_KERNELS + (
    INFONCE_KERNELS) + ATTENTION_KERNELS + ENCODER_KERNELS + ADAM_KERNELS


def encoder_parts(split: dict) -> dict:
    """Device ms by kernel name (`split`) summed by `encoder_part`, the
    kernels of no part under `other`."""
    out = {}
    for name, ms in split.items():
        part = encoder_part(name) or "other"
        out[part] = out.get(part, 0.0) + ms
    return out


def encoder_part(name: str):
    """Which part of the encoder a kernel of `csrc/encoder.cu` is: layers
    2-5's `products`, the `norms`, the `sums` of partials or `layer 1`; None
    for any other kernel. The SIMT products that layers 2-5 ran on before
    (`conv_gemm` and `conv_wgrad` on bf16 inputs, with the forward's norm
    fused) count as products."""
    if "conv_wgmma_gemm" in name or any(
            f"{k}<__nv_bfloat16" in name for k in ("conv_gemm", "conv_wgrad")):
        return "products"
    if "norm_fwd" in name or "norm_bwd" in name:
        return "norms"
    if "sum_rows" in name:
        return "sums"
    if any(k in name for k in ENCODER_KERNELS):
        return "layer 1"
    return None


def device_us(event) -> float:
    """The event's own device time in µs."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def device_kernels(prof) -> list:
    """The profile's device kernels: not the user annotations (e.g. the
    optimizer's step range) that the profiler also puts on the device
    timeline."""
    return [e for e in prof.key_averages() if device_us(e) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.key]


def trace_summary(path: str, top: int = 10) -> dict:
    """What a Chrome trace of `torch.profiler` shows: its window, from its
    first event's start to its last one's end; the device's busy time in
    it, the union of its kernels' intervals; the host's share of the
    window, the time no kernel ran; and the `top` kernels by device time,
    each as (name, ms, launches)."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path}: no timed events")
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    start = min(e["ts"] for e in events)
    window = max(e["ts"] + e["dur"] for e in events) - start
    busy, reach = 0.0, -float("inf")
    by_name: dict = {}
    for e in kernels:
        end = e["ts"] + e["dur"]
        busy += max(0.0, end - max(e["ts"], reach))
        reach = max(reach, end)
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
            "host_share": 1.0 - busy / window if window > 0 else 1.0,
            "kernel_launches": len(kernels),
            "top": [(name, ms, n) for name, (ms, n) in ranked]}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--trace", type=str, default=None,
                        help="write a Chrome trace of the profiled steps")
    parser.add_argument("--precision", type=str, default="bf16mix",
                        choices=["fp32", "bf16mix", "bf16"])
    parser.add_argument("--adam_mu_dtype", type=str, default="fp32",
                        choices=["fp32", "bf16"])
    parser.add_argument("--hiddenEncoder", type=int, default=256)
    parser.add_argument("--hiddenGar", type=int, default=256)
    parser.add_argument("--batchSizeGPU", type=int, default=8)
    parser.add_argument("--neg_pool_group", type=int, default=0)
    opts = parser.parse_args(argv)

    args = parse_args(["--pathDB", ".", "--file_extension", ".wav",
                       "--random_seed", "0", "--precision", opts.precision,
                       "--adam_mu_dtype", opts.adam_mu_dtype,
                       "--hiddenEncoder", str(opts.hiddenEncoder),
                       "--hiddenGar", str(opts.hiddenGar),
                       "--batchSizeGPU", str(opts.batchSizeGPU),
                       "--neg_pool_group", str(opts.neg_pool_group)])
    device = resolve_device("cuda")
    set_precision(args.precision)
    torch.manual_seed(0)
    model = build_model(args).to(device)
    criterion = get_criterion(args).to(device)
    params = list(model.parameters()) + list(criterion.parameters())
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    trainer = Trainer(model, criterion, make_optimizer(args, params),
                      generator)
    rs = np.random.RandomState(0)
    batches = [torch.from_numpy(
        rs.randn(args.batchSizeGPU, 2, 1, args.sizeWindow).astype(
            np.float32)).to(device) for _ in range(4)]

    def step(i):
        trainer.train_step(batches[i % len(batches)])

    for i in range(WARMUP_STEPS):
        step(i)
    torch.cuda.synchronize()
    wall_ms = []
    for i in range(opts.steps):
        start = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        wall_ms.append(1000.0 * (time.perf_counter() - start))

    phases = {"forward": [], "backward": [], "optimizer": []}
    for i in range(opts.steps):
        model.train()
        criterion.train()
        trainer.optimizer.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        losses, _accs = trainer._forward(batches[i % len(batches)], None,
                                         False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.sum().backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.optimizer.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name, ms in zip(phases, (t1 - t0, t2 - t1, t3 - t2)):
            phases[name].append(1000.0 * ms)

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    _build.reset_launches()
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        for i in range(opts.steps):
            step(i)
        torch.cuda.synchronize()
        profiled_ms = 1000.0 * (time.perf_counter() - start) / opts.steps
    launches = {k: n / opts.steps for k, n in _build.LAUNCHES.items() if n}
    if opts.trace:
        prof.export_chrome_trace(opts.trace)

    kernels = device_kernels(prof)
    device_ms = sum(device_us(e) for e in kernels) / 1000.0 / opts.steps
    ffn_route = "fp32" if opts.precision == "fp32" else "bf16"
    port_ms, ffn_ms, lstm_ms, infonce_ms, attention_ms, adam_ms = (
        sum(device_us(e) for e in kernels if any(k in e.key for k in names))
        / 1000.0 / opts.steps
        for names in (PORT_KERNELS, FFN_FP32_KERNELS if ffn_route == "fp32"
                      else FFN_KERNELS, LSTM_KERNELS, INFONCE_KERNELS,
                      ATTENTION_KERNELS, ADAM_KERNELS))
    encoder_ms = encoder_parts(
        {e.key: device_us(e) / 1000.0 / opts.steps for e in kernels})
    encoder_ms.pop("other", None)
    device_launches = sum(e.count for e in kernels) / opts.steps
    median = statistics.median(wall_ms)
    print(f"card: {torch.cuda.get_device_name(0)}; --hiddenEncoder "
          f"{args.hiddenEncoder} --hiddenGar {args.hiddenGar} --precision "
          f"{args.precision} --adam_mu_dtype {args.adam_mu_dtype}")
    print(f"wall: median {median:.3f} ms/step over {opts.steps} steps "
          f"(min {min(wall_ms):.3f}, max {max(wall_ms):.3f}); "
          f"{args.batchSizeGPU * args.sizeWindow / 16000 / (median / 1e3):.1f}"
          f" audio-hours per hour")
    print("phases (median ms, each ending in a synchronise): " + ", ".join(
        f"{name} {statistics.median(ms):.3f}" for name, ms in phases.items()))
    print(f"profiled: {profiled_ms:.3f} ms/step wall, {device_ms:.3f} ms/step "
          f"of device kernels ({100.0 * device_ms / profiled_ms:.1f}% of the "
          f"profiled step, {100.0 * device_ms / median:.1f}% of the "
          f"unprofiled median), of which the port's kernels "
          f"{port_ms:.3f} ms, the FFN's {ffn_route} kernels {ffn_ms:.3f} ms, "
          f"the LSTM's {lstm_ms:.3f} ms (its walks, dW_hh and db_hh sums), "
          f"InfoNCE's {infonce_ms:.3f} ms, the attention's "
          f"{attention_ms:.3f} ms, the encoder's "
          f"{sum(encoder_ms.values()):.3f} ms ("
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(encoder_ms.items()))
          + f"), the bf16-moment Adam's {adam_ms:.3f} ms; "
          f"{device_launches:g} device kernel launches per step")
    print("the port's kernel wrappers, launches/step: " + ", ".join(
        f"{k} {n:g}" for k, n in launches.items()))
    print(f"{'device ms/step':>15} {'calls/step':>11}  kernel")
    for e in sorted(kernels, key=device_us, reverse=True)[:TOP_KERNELS]:
        print(f"{device_us(e) / 1000.0 / opts.steps:15.4f} "
              f"{e.count / opts.steps:11.1f}  {e.key[:100]}")
    return {"median_step_ms": median, "device_ms": device_ms,
            "port_kernel_ms": port_ms, f"ffn_{ffn_route}_kernel_ms": ffn_ms,
            "lstm_kernel_ms": lstm_ms, "infonce_kernel_ms": infonce_ms,
            "attention_kernel_ms": attention_ms,
            "adam_bf16_kernel_ms": adam_ms,
            "encoder_kernel_ms": encoder_ms,
            "device_launches_per_step": device_launches,
            "profiled_step_ms": profiled_ms,
            "launches_per_step": launches,
            "phase_ms": {k: statistics.median(v) for k, v in phases.items()}}


if __name__ == "__main__":
    main(sys.argv[1:])
