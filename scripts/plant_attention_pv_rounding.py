"""Show that `chip_smoke.py`'s hold of the attention's bf16-io kernels
rejects a backward that rounds p~ to bf16 where it recomputes it. The TPU
kernel recomputes p~ unrounded (`cpc2_tpu/ops/attention_pallas.py:124-128`),
so the rounding is straight-through; rounding it again moves dv by about a
bf16 rounding of each probability.

    python3 scripts/plant_attention_pv_rounding.py

Copies `chip_smoke.py` and `cpc2_torch/` into a temporary directory, rounds
there the p~ that `keep_dp` of `cpc2_torch/csrc/attention.cuh` stores for
dv = p~^T g (both the narrow and the wide backward take it from there),
builds that copy's kernels with `nvcc` and runs its
`chip_smoke.check_bf16_attention` on the card. Prints the check's message
and exits 0 when it fails on dv, as it must, else 1. Needs a CUDA card; the
repository itself is not changed.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STORE = "pd[rr * p.lds + c] = keep ? pr[e] * a.keep_scale : 0.f;"
PLANTED = ("pd[rr * p.lds + c] = keep ? __bfloat162float(__float2bfloat16_rn("
           "pr[e] * a.keep_scale)) : 0.f;")


def plant(copy: Path) -> None:
    shutil.copytree(ROOT / "cpc2_torch", copy / "cpc2_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", copy / "chip_smoke.py")
    source = copy / "cpc2_torch" / "csrc" / "attention.cuh"
    text = source.read_text()
    if text.count(STORE) != 1:
        raise SystemExit(f"{source.name}: the store of p~ for dv was not "
                         f"found once")
    source.write_text(text.replace(STORE, PLANTED))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp)
        plant(copy)
        sys.path.insert(0, str(copy))
        import chip_smoke
        from cpc2_torch.ops import _build
        if not _build.LIBRARY.is_relative_to(copy):
            raise SystemExit("the copy's kernels would not be the ones run")
        _build.library()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev)
        gen.manual_seed(31)
        try:
            with chip_smoke.fused_switches(False):
                chip_smoke.check_bf16_attention(dev, gen)
        except AssertionError as err:
            print(f"planted p~ rounding in the backward: the check fails: "
                  f"{err}")
            return 0 if " dv: " in str(err) else 1
    print("planted p~ rounding in the backward: the check passed it")
    return 1


if __name__ == "__main__":
    sys.exit(main())
