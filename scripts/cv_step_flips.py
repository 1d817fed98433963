"""Show what moves the unfrozen Common Voices step's gradients between the
card and the CPU: the encoder's ReLU decisions that one fp32 rounding
flips. For each seed, a randomly initialised recipe model (256 wide, the
LSTM context) and a batch of `chip_smoke.cv_step_batch` go through
`chip_smoke.cv_step` in unfrozen mode on the card.

    python3 scripts/cv_step_flips.py [--seeds 12]

Prints one JSON line a seed: by encoder layer the ReLU decisions that
differ card against CPU, the layer's card-vs-CPU spread and the largest
|input| among the flipped units on each side (all over the layer's largest
|input|); the gradients further than CTC_RTOL from the CPU's fp32 step
(`past_fp32`, over each tensor's largest); and the error against the
float64 step with the card's decisions that the check holds, or the
check's message where it failed. Exits 1 where any seed failed the check,
and without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--trained_batches", type=int, default=16)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("cv_step_flips: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from cpc2_torch.feature_loader import build_model, load_model
    dev = torch.device("cuda", 0)
    failed = 0

    def step(row, model, batch_seed):
        nonlocal failed
        row["batch_seed"] = batch_seed
        try:
            r = cs.cv_step(dev, model, 256, "unfrozen",
                           cs.cv_step_batch(batch_seed))
            row.update(flips=r["flips"], past_fp32=r["past_fp32"],
                       grad_max_abs_err=r["grad_max_abs_err"],
                       loss_err=r["loss_err"], loss=r["loss"])
        except AssertionError as err:
            failed += 1
            row["failed"] = str(err)
        print(json.dumps(row), flush=True)

    for seed in range(args.seeds):
        torch.manual_seed(seed)
        step({"model": f"random seed {seed}"},
             build_model(cs.variant_args([])), 11 + seed)
    if args.trained_batches:
        with tempfile.TemporaryDirectory() as work:
            cs.check_corpus(work)
            checkpoint = cs.run_training(dev, work)["checkpoint"]
            model, _hidden_gar, _ = load_model([checkpoint])
            for k in range(args.trained_batches):
                step({"model": "default epoch"}, model, 11 + k)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
