"""Weights of the JAX package, as state dicts of this package's modules.

The JAX package names its flax scopes after the reference's torch modules,
so a param path maps to a state-dict key by joining it with dots, with
these rules (`cpc2_tpu/io/torch_ckpt.py:196-290`):

* the K prediction heads are stacked on a leading axis under one
  `predictors` scope; they become the per-head keys `predictors.{k}.*`
  (the multi-head trunk's single `predictor` scope is not stacked);
* the reference's equalized layers wrap theirs in `.module`: the `ffd`
  heads' `predictors.{k}.lin1.module.weight` and the `conv4/8/12` heads'
  `predictors.{k}.module.module.weight`, which flax keeps as
  `predictors/lin1/weight` and `predictors/weight` (rank 4 stacked; the
  linear head's is rank 3 and has no bias);
* a bidirectional GRU's backward direction is the flax scope `<name>_bwd`
  with leaves `*_reverse`; torch keeps them in `<name>` beside the forward
  direction's;
* the layers of a torch `Sequential` are flax scopes `<name>_{i}`
  (`PhoneCriterionClassifier_{i}` for `--nLevelsPhone > 1`); they become
  `<name>.{i}.*`;
* a BatchNorm's `bn/scale` and `bn/bias` become `weight` and `bias`, and
  its `bn/mean` and `bn/var` statistics `running_mean` and `running_var`;
* ChannelNorm's affine params (`normMode layerNorm`) are `(C,)` in flax and
  `(1, C, 1)` here, as in the reference's checkpoints.

This module takes plain nested dicts of numpy arrays and imports nothing of
the JAX package. `jax_param_order` runs the rules the other way: from port
modules to the JAX param tree's leaves, in the order JAX flattens them.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_CHANNEL_NORM = re.compile(r"^batchNorm\d+$")
# Sequential containers whose layers flax names `<name>_{i}`
# (`cpc2_tpu/io/torch_ckpt.py:_LIST_CONTAINERS`, less the prediction heads,
# which are stacked, and the concatenated models, which the JAX package does
# not train)
_LIST_SCOPE = re.compile(r"^(PhoneCriterionClassifier)_(\d+)$")
# the equalized layers' `.module` wrappers (`criterion.py:FFNetwork`,
# `ShiftedConv`), and a bidirectional GRU's backward scope
_WRAPPER = "module"
_BWD = "_bwd"
_REVERSE = "_reverse"


def _split_list_scopes(path: Tuple[str, ...]) -> Tuple[str, ...]:
    out: List[str] = []
    for part in path:
        m = _LIST_SCOPE.match(part)
        out += [m.group(1), m.group(2)] if m else [part]
    return tuple(out)


def _join_list_scopes(parts: List[str]) -> List[str]:
    out: List[str] = []
    for part in parts:
        if part.isdigit() and out and _LIST_SCOPE.match(f"{out[-1]}_{part}"):
            out[-1] = f"{out[-1]}_{part}"
        else:
            out.append(part)
    return out


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
        path = _split_list_scopes(path)
        if (len(path) >= 2 and path[-2].endswith(_BWD)
                and path[-1].endswith(_REVERSE)):
            path = path[:-2] + (path[-2][:-len(_BWD)], path[-1])
        if "predictors" in path:
            i = path.index("predictors")
            stacked = np.asarray(value)
            inner = _unwrap_head(path[i + 1:], stacked.ndim)
            for k in range(stacked.shape[0]):
                key = ".".join(path[:i] + ("predictors", str(k)) + inner)
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


def _unwrap_head(inner: Tuple[str, ...], ndim: int) -> Tuple[str, ...]:
    """A stacked head's path below `predictors`, with the reference's
    `.module` wrappers of the `ffd` and `conv` heads put back."""
    if len(inner) == 2 and inner[0] in ("lin1", "lin2"):
        return (inner[0], _WRAPPER, inner[1])
    if inner == ("bias",) or (inner == ("weight",) and ndim == 4):
        return (_WRAPPER, _WRAPPER) + inner
    return inner


def _jax_path(module: nn.Module, key: str) -> Tuple[Tuple[str, ...],
                                                   Optional[int]]:
    """The flax param path of `module`'s parameter `key`, and the head it
    is when it is one of the stacked prediction heads' (else None)."""
    parts = key.split(".")
    owner = module.get_submodule(".".join(parts[:-1]))
    head = None
    if "predictors" in parts[:-2] and parts[parts.index("predictors") + 1
                                           ].isdigit():
        i = parts.index("predictors")
        head = int(parts[i + 1])
        parts = parts[:i + 1] + parts[i + 2:]
    if isinstance(owner, nn.modules.batchnorm._BatchNorm):
        parts = parts[:-1] + ["bn", "scale" if parts[-1] == "weight"
                              else "bias"]
    parts = [p for p in parts if p != _WRAPPER]
    if parts[-1].endswith(_REVERSE):
        parts[-2] += _BWD
    return tuple(_join_list_scopes(parts)), head


def jax_param_order(modules: Mapping[str, nn.Module]
                    ) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    """The leaves of the flax param tree `{name: params of module}`, in
    `jax.tree_util.tree_leaves` order (dict keys sorted at every level, so
    in the order of their paths), each as (path, flax shape). Only
    parameters are leaves: BatchNorm statistics are flax `batch_stats`."""
    heads: Dict[Tuple[str, ...], set] = {}
    shapes: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
    for name, module in modules.items():
        for key, param in module.named_parameters():
            path, head = _jax_path(module, key)
            path = (name,) + path
            shape = tuple(param.shape)
            if (len(shape) == 3 and shape[0] == shape[2] == 1
                    and _CHANNEL_NORM.match(path[-2])):
                shape = (shape[1],)       # ChannelNorm's (1, C, 1)
            shapes[path] = shape
            heads.setdefault(path, set()).add(head)
    return [(path, shapes[path] if heads[path] == {None}
             else (len(heads[path]),) + shapes[path])
            for path in sorted(shapes)]
