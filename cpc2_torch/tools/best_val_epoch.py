"""Best-epoch selector (counterpart of `cpc2_tpu/tools/best_val_epoch.py`,
reference `utils/best_val_epoch.py`): reads a training run's
`checkpoint_logs.json` and picks the saved epoch with the highest mean
validation accuracy. Host code, the same flags.

Run: `python -m cpc2_torch.tools.best_val_epoch --model_path <run_dir>`
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np


def find_best_epoch(model_path, min_epoch=None, max_epoch=None):
    checkpoint_logs = os.path.join(model_path, "checkpoint_logs.json")
    if not os.path.isfile(checkpoint_logs):
        raise ValueError(f"{checkpoint_logs} is missing — this directory "
                         f"does not look like a finished training run")
    with open(checkpoint_logs, 'rb') as fin:
        logs = json.load(fin)

    cp_idxs = glob.glob(os.path.join(model_path, "checkpoint*.pt"))
    cp_idxs = sorted(int(os.path.basename(e).replace('checkpoint_', '')
                         .replace('.pt', '')) for e in cp_idxs
                     if os.path.basename(e).replace('checkpoint_', '')
                     .replace('.pt', '').isdigit())
    if min_epoch is not None:
        cp_idxs = [e for e in cp_idxs if e >= min_epoch]
    if max_epoch is not None:
        cp_idxs = [e for e in cp_idxs if e <= max_epoch]
    if len(cp_idxs) == 0:
        raise ValueError(f"No saved checkpoint_<n>.pt in {model_path} "
                         f"within [--min, --max] to choose from")
    acc_val = np.asarray(logs['locAcc_val'], dtype=object)
    acc_val = np.asarray([np.mean(np.asarray(a, dtype=np.float64))
                          for a in acc_val])
    cp_idxs = [e for e in cp_idxs if e < len(acc_val)]
    sel = acc_val[cp_idxs]
    opt_idx = int(np.argmax(sel))
    opt_epoch = cp_idxs[opt_idx]
    return opt_epoch, float(sel[opt_idx])


def main(argv):
    parser = argparse.ArgumentParser(
        description='Returns the best epoch, selected on the validation '
                    'accuracy.')
    parser.add_argument('--model_path', type=str, required=True)
    parser.add_argument('--min', type=int, default=None)
    parser.add_argument('--max', type=int, default=None)
    args = parser.parse_args(argv)

    if not os.path.isdir(args.model_path):
        raise ValueError(f"{args.model_path} is not a directory")
    opt_epoch, acc = find_best_epoch(args.model_path, args.min, args.max)
    print(f"Best epoch: {opt_epoch} (mean validation accuracy {acc:f})")
    return opt_epoch


if __name__ == "__main__":
    main(sys.argv[1:])
