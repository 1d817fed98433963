"""Weights of the JAX package, as state dicts of this package's modules.

The JAX package names its flax scopes after the reference's torch modules,
so a param path maps to a state-dict key by joining it with dots, with
three rules:

* the K prediction heads are stacked on a leading axis under one
  `predictors` scope; they become the per-head keys `predictors.{k}.*`;
* a BatchNorm's `bn/scale` and `bn/bias` become `weight` and `bias`, and
  its `bn/mean` and `bn/var` statistics `running_mean` and `running_var`;
* ChannelNorm's affine params (`normMode layerNorm`) are `(C,)` in flax and
  `(1, C, 1)` here, as in the reference's checkpoints.

This module takes plain nested dicts of numpy arrays and imports nothing of
the JAX package.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_CHANNEL_NORM = re.compile(r"^batchNorm\d+$")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _tensor(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=np.float32))


def state_dict_from_jax(params: Mapping, batch_stats: Optional[Mapping] = None,
                        norm_mode: str = "layerNorm"
                        ) -> Dict[str, torch.Tensor]:
    """The state dict of the port module whose JAX counterpart holds the
    flax param tree `params` (the model's or the criterion's), under the
    reference's key names. `batch_stats` is the model's BatchNorm
    collection (`normMode batchNorm`); `norm_mode` is the encoder's."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        if "predictors" in path:
            i = path.index("predictors")
            stacked = np.asarray(value)
            for k in range(stacked.shape[0]):
                key = ".".join(path[:i] + ("predictors", str(k)) + path[i + 1:])
                out[key] = _tensor(stacked[k])
            continue
        if len(path) >= 2 and path[-2] == "bn":
            leaf = "weight" if path[-1] == "scale" else "bias"
            out[".".join(path[:-2] + (leaf,))] = _tensor(value)
            continue
        tensor = _tensor(value)
        if (norm_mode == "layerNorm" and len(path) >= 2
                and path[-1] in ("weight", "bias") and tensor.dim() == 1
                and _CHANNEL_NORM.match(path[-2])):
            tensor = tensor.reshape(1, -1, 1)
        out[".".join(path)] = tensor
    for path, value in _leaves(batch_stats or {}):
        leaf = "running_mean" if path[-1] == "mean" else "running_var"
        out[".".join(path[:-2] + (leaf,))] = _tensor(value)
        out[".".join(path[:-2] + ("num_batches_tracked",))] = \
            torch.tensor(0, dtype=torch.int64)
    return out
