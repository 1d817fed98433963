"""InfoNCE's kernels alone at the recipe, by device time.

    python -m cpc2_torch.time_infonce [--iters 100]

Draws the recipe's inputs from seed 0 on the card (preds (8, 12, 116, 256),
a pool of 1,024 rows of 256, and 128 negatives a position from the
trainer's own `sample_negative_indices`), then profiles `--iters` forward
calls and `--iters` backward calls of `negative_scores` with
`torch.profiler` and prints the device ms per call of each, the backward's
split by kernel. Run it from the root of each of two checkouts in one call
on the card to compare them. It needs a CUDA card.
"""

from __future__ import annotations

import argparse

import torch

from .losses import sample_negative_indices
from .ops import _build
from .ops.infonce import negative_scores
from .profile_step import device_kernels, device_us

WARMUP = 3


def device_split(fn, iters: int) -> dict:
    """Device ms per call of `fn` by kernel name."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: device_us(e) / 1e3 / iters for e in device_kernels(prof)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=100)
    opts = parser.parse_args(argv)
    _build.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    b, k, w, n, d, p = 8, 12, 116, 128, 256, 1024
    preds = torch.randn(b, k, w, d, device=dev, generator=gen,
                        requires_grad=True)
    z = torch.randn(p, d, device=dev, generator=gen, requires_grad=True)
    idx = sample_negative_indices(gen, b, p // b, n, w, dev).transpose(
        1, 2).contiguous()
    g = torch.randn(b, k, w, n, device=dev, generator=gen)
    out = negative_scores(preds, z, idx)
    with torch.no_grad():
        fwd = sum(device_split(lambda: negative_scores(preds, z, idx),
                               opts.iters).values())
    bwd = device_split(lambda: torch.autograd.grad(out, (preds, z), g,
                                                   retain_graph=True),
                       opts.iters)
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"infonce_fwd {fwd:.4f} ms, infonce_bwd {sum(bwd.values()):.4f} "
          "ms of device time per call: "
          + ", ".join(f"{key[:40]} {ms:.4f}" for key, ms in bwd.items()))
    return {"infonce_fwd_ms": fwd, "infonce_bwd_ms": sum(bwd.values()),
            "infonce_bwd_split_ms": bwd}


if __name__ == "__main__":
    main()
