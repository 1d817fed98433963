"""Checkpoints in the reference's layout (counterpart of
`cpc2_tpu/io/checkpoint.py` and the whole-checkpoint IO of
`cpc2_tpu/io/torch_ckpt.py`, reference `cpc/feature_loader.py:150-199,
296-304`).

A run directory holds `checkpoint_<epoch>.pt` torch pickles of
`{gEncoder, cpcCriterion, optimizer, best}` beside `checkpoint_args.json`
and `checkpoint_logs.json`; auto-resume picks the highest-numbered
checkpoint. The port's modules carry the reference's parameter names, so
`gEncoder` is `CPCModel.state_dict()` and `cpcCriterion` the criterion's,
and the JAX package's checkpoints load unchanged.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import get_default_cpc_config


def save_logs(data: Dict[str, Any], path_logs: str) -> None:
    with open(path_logs, 'w') as f:
        json.dump(data, f, indent=2)


def save_args(args: argparse.Namespace, path_args: str) -> None:
    with open(path_args, 'w') as f:
        json.dump(vars(args), f, indent=2)


def load_args(args: argparse.Namespace, loc_args: argparse.Namespace,
              forbidden_attr=None) -> None:
    """Copy `loc_args` onto `args` in place, but for `forbidden_attr`
    (reference `feature_loader.py:150-156`)."""
    for k, v in vars(loc_args).items():
        if forbidden_attr is None or k not in forbidden_attr:
            setattr(args, k, v)


loadArgs = load_args


def get_checkpoint_data(path_dir: str
                        ) -> Optional[Tuple[str, Dict, argparse.Namespace]]:
    """The newest checkpoint of a run directory (reference
    `feature_loader.py:176-199`): (its absolute path, the logs, the run's
    args merged into the default architecture flags), or None."""
    if not os.path.isdir(path_dir):
        return None
    checkpoints = [x for x in os.listdir(path_dir)
                   if os.path.splitext(x)[1] == '.pt'
                   and os.path.splitext(x[11:])[0].isdigit()]
    if not checkpoints:
        print("No checkpoints found at " + path_dir)
        return None
    checkpoints.sort(key=lambda x: int(os.path.splitext(x[11:])[0]))
    data = os.path.join(path_dir, checkpoints[-1])
    with open(os.path.join(path_dir, 'checkpoint_logs.json'), 'rb') as f:
        logs = json.load(f)
    with open(os.path.join(path_dir, 'checkpoint_args.json'), 'rb') as f:
        args = argparse.Namespace(**json.load(f))
    default_args = get_default_cpc_config()
    load_args(default_args, args)
    return os.path.abspath(data), logs, default_args


getCheckpointData = get_checkpoint_data


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location='cpu', weights_only=False)


def to_cpu(obj):
    """`obj` with every tensor in it copied to the CPU, so that a
    checkpoint loads on a machine without a card."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj


def save_checkpoint(model_state: Dict[str, Any],
                    criterion_state: Dict[str, Any], optimizer_state: Any,
                    best_state: Optional[Dict[str, Any]],
                    path_checkpoint: str) -> None:
    """The reference's layout: {gEncoder, cpcCriterion, optimizer, best},
    every tensor on the CPU."""
    torch.save(to_cpu({"gEncoder": model_state,
                       "cpcCriterion": criterion_state,
                       "optimizer": optimizer_state,
                       "best": best_state}), path_checkpoint)
