"""The opt-in encoder's kernels alone at the recipe, by device time.

    python -m cpc2_torch.time_encoder [--iters 20]

Builds the recipe's encoder (`CPCEncoder(256)`, norm affines moved off 1
and 0) and a 16 x 20,480-sample input from seed 0 on the card, then profiles
`--iters` forward calls of `fused_encoder` with gradients kept (as in
training) and `--iters` backward calls with `torch.profiler`, and prints the
device ms per call of each, split by part (layers 2-5's products, the norms,
the sums of partials, layer 1: `profile_step.encoder_part`), beside the same
work through the module's cuDNN route under TF32. Run it from the root of
each of two checkouts in one call on the card to compare them (with this
file and `profile_step.py` copied into the older one, which must have
`time_infonce.py`). It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from .models.encoder import CPCEncoder
from .ops import _build
from .ops.encoder import fused_encoder
from .profile_step import encoder_part, encoder_parts
from .time_infonce import device_split


def encoder_inputs(dev, gen, n: int, t: int, c: int):
    """`CPCEncoder(c)` from torch's seed 0 with its norm affines moved off
    1 and 0, its 20 parameters (conv weights, conv biases, norm weights,
    norm biases), an input (n, t) and a cotangent (n, t // 160, c), all
    drawn from `gen` on `dev`."""
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


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    opts = parser.parse_args(argv)
    # the module's own route is the yardstick: never the opt-in kernels
    os.environ.pop("CPC2_FUSED_ENCODER", None)
    _build.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    module, params, x, cot = encoder_inputs(dev, gen, 16, 20480, 256)
    x.requires_grad_(True)
    groups = [params[0:5], params[5:10], params[10:15], params[15:20]]

    out = fused_encoder(x, *groups)
    fwd = device_split(lambda: fused_encoder(x, *groups), opts.iters)
    bwd = device_split(lambda: torch.autograd.grad(
        out, [x] + params, cot, retain_graph=True), opts.iters)

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        out_m = module(x)
        route_fwd = device_split(lambda: module(x), opts.iters)
        route_bwd = device_split(lambda: torch.autograd.grad(
            out_m, [x] + params, cot, retain_graph=True), opts.iters)
    finally:
        torch.backends.cudnn.allow_tf32 = saved

    result = {"card": torch.cuda.get_device_name(0),
              "encoder_fwd_ms": sum(fwd.values()),
              "encoder_bwd_ms": sum(bwd.values()),
              "encoder_fwd_by_part": encoder_parts(fwd),
              "encoder_bwd_by_part": encoder_parts(bwd),
              "cudnn_tf32_fwd_ms": sum(route_fwd.values()),
              "cudnn_tf32_bwd_ms": sum(route_bwd.values())}
    for what, split in (("forward", fwd), ("backward", bwd)):
        print(f"encoder {what}: {sum(split.values()):.4f} ms per call")
        for name, ms in sorted(split.items(), key=lambda kv: -kv[1]):
            print(f"  {ms:9.4f}  {encoder_part(name) or 'other':9s} "
                  f"{name[:90]}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
