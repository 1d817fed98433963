"""Where a training step's time goes on the card.

    python -m cpc2_torch.profile_step [--steps 10] [--trace out.json]

Builds the recipe model and criterion (the trainer's defaults: batch 8 x
20,480 samples, 256-d encoder and LSTM, 12 transformer heads, 128
negatives) from a seed, feeds random batches made with numpy, and after
warm-up steps:

* times `--steps` steps on the host clock, each ending in a device
  synchronise (ms/step), and the same steps split into forward, backward
  and optimizer phases, each ending in a synchronise;
* profiles the same number of steps with `torch.profiler` and prints the
  device time per step, its share of the wall time, the share of the
  port's hand-written kernels, and the kernels that take the most device
  time.

It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from .config import parse_args
from .feature_loader import build_model
from .train import get_criterion
from .training import Trainer, make_optimizer, resolve_device, set_precision

WARMUP_STEPS = 3
TOP_KERNELS = 15
# Name fragments of the port's kernels in `csrc/*.cu`.
PORT_KERNELS = ("lstm_fwd_step", "lstm_bwd_step", "gemm_kernel",
                "colsum_kernel", "neg_scores_fwd", "neg_scores_bwd")


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--trace", type=str, default=None,
                        help="write a Chrome trace of the profiled steps")
    parser.add_argument("--precision", type=str, default="bf16mix")
    opts = parser.parse_args(argv)

    args = parse_args(["--pathDB", ".", "--file_extension", ".wav",
                       "--random_seed", "0", "--precision", opts.precision])
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
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        for i in range(opts.steps):
            step(i)
        torch.cuda.synchronize()
        profiled_ms = 1000.0 * (time.perf_counter() - start) / opts.steps
    if opts.trace:
        prof.export_chrome_trace(opts.trace)

    # device kernels only: not the user annotations (e.g. the optimizer's
    # step range) that the profiler also puts on the device timeline
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and "#" not in e.key]
    device_ms = sum(_device_us(e) for e in kernels) / 1000.0 / opts.steps
    port_ms = sum(_device_us(e) for e in kernels
                  if any(k in e.key for k in PORT_KERNELS)) / 1000.0 \
        / opts.steps
    median = statistics.median(wall_ms)
    print(f"card: {torch.cuda.get_device_name(0)}")
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
          f"{port_ms:.3f} ms")
    print(f"{'device ms/step':>15} {'calls/step':>11}  kernel")
    for e in sorted(kernels, key=_device_us, reverse=True)[:TOP_KERNELS]:
        print(f"{_device_us(e) / 1000.0 / opts.steps:15.4f} "
              f"{e.count / opts.steps:11.1f}  {e.key[:100]}")
    return {"median_step_ms": median, "device_ms": device_ms,
            "port_kernel_ms": port_ms, "profiled_step_ms": profiled_ms,
            "phase_ms": {k: statistics.median(v) for k, v in phases.items()}}


if __name__ == "__main__":
    main(sys.argv[1:])
