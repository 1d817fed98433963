"""What a data-parallel rank adds to a training step on the card: the
recipe's step (`chip_smoke.dispatch_trainer`, batch 8 x 20,480, bf16mix)
as the one rank of a NCCL group against the same step without ranks, in
turns of 10 steps, host clock to a synchronise; then the rank's
reductions alone (the gradients' flat all-reduce, the BatchNorm
statistics, the metrics), and one gradient reduction under the profiler.

    python3 scripts/dp_rank_overhead.py [--turns 4]

Prints the card's name and power limit, the gradient buffers' sizes,
each side's median and quartiles in ms, each reduction's median ms, and
the profiler's table of the gradient reduction. Exits 1 without a CUDA
card.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def timed(fn, n: int) -> list:
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1000.0 * (time.perf_counter() - start))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--turns", type=int, default=4)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("dp_rank_overhead: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from cpc2_torch.parallel import (DataParallel, free_port,
                                     init_process_group)
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    init_process_group(0, 1, dev, f"tcp://127.0.0.1:{free_port()}")
    try:
        dp = DataParallel(0, 1, dev)
        _, plain = cs.dispatch_trainer(dev, 256)
        _, ranked = cs.dispatch_trainer(dev, 256)
        ranked.dp = dp
        ranked.grad_buffers = dp.bind_gradients(
            p for g in ranked.optimizer.param_groups for p in g["params"])
        print("gradient buffers: " + ", ".join(
            f"{flat.numel()} {flat.dtype} elements "
            f"({flat.numel() * flat.element_size()} bytes)"
            for flat in ranked.grad_buffers))
        batch = 0.1 * torch.randn(8, 2, 1, 20480, device=dev)
        for trainer in (plain, ranked):
            timed(lambda t=trainer: t.train_step(batch), 3)
        runs = {"without ranks": [], "one NCCL rank": []}
        for _ in range(args.turns):
            for name, trainer in (("without ranks", plain),
                                  ("one NCCL rank", ranked)):
                runs[name] += timed(lambda t=trainer: t.train_step(batch),
                                    10)
        for name, ms in runs.items():
            quartiles = [round(q, 3) for q in statistics.quantiles(ms, n=4)]
            print(f"{name}: median {statistics.median(ms):.3f} ms a step, "
                  f"quartiles {quartiles}")
        zeros = torch.zeros(1, 12, device=dev)
        for name, fn in (
                ("gradients", lambda: dp.reduce_gradients(
                    ranked.grad_buffers)),
                ("batch statistics", lambda: dp.reduce_batch_stats(
                    (ranked.model, ranked.criterion))),
                ("metrics", lambda: ranked._metrics(zeros, zeros, None))):
            timed(fn, 3)
            print(f"reduce {name}: median "
                  f"{statistics.median(timed(fn, 20)):.3f} ms (host clock "
                  f"to a synchronise)")
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            dp.reduce_gradients(ranked.grad_buffers)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cpu_time_total",
                                        row_limit=12))
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
