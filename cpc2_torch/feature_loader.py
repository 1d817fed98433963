"""Model factories, checkpoint loading and feature extraction (counterpart
of `cpc2_tpu/feature_loader.py`, reference `cpc/feature_loader.py`).

`load_model` builds a `CPCModel` from a checkpoint's saved flags and loads
its `gEncoder` state dict, which the port's modules take unchanged whether
the port or the JAX package wrote it. `FeatureModule` turns audio into the
context network's (or the encoder's) features on the model's device,
under `torch.no_grad()` and in full fp32. `build_feature` extracts one
file in chunks; `build_feature_files` batches files of equal length and
carries the context network's state across their chunks.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .config import CONCATENATION, check_model_ported
from .data.audio_io import load_audio
from .io.checkpoint import (get_checkpoint_data, load_args,
                            load_torch_checkpoint)
from .models import (CPCAR, CPCEncoder, CPCModel, NoAr,
                     build_transformer_ar)
from .models.encoder import DOWNSAMPLING
from .training import full_fp32

_CCA = "CCA projection"
_TRAIN_MODE = "train_mode features"


def get_encoder(args: argparse.Namespace) -> nn.Module:
    """The learned conv encoder; the MFCC and LFB front-ends are not ported
    (the flag parser refuses them)."""
    return CPCEncoder(size_hidden=args.hiddenEncoder, norm_mode=args.normMode)


def get_ar(args: argparse.Namespace) -> nn.Module:
    """The context network. Like the reference, the transformer AR sets
    `args.hiddenGar = args.hiddenEncoder` in place."""
    if args.arMode == 'transformer':
        ar = build_transformer_ar(args.hiddenEncoder, args.hiddenGar,
                                  args.nLevelsGRU,
                                  args.sizeWindow // DOWNSAMPLING,
                                  args.abspos)
        args.hiddenGar = args.hiddenEncoder
        return ar
    if args.arMode == 'no_ar':
        return NoAr()
    return CPCAR(dim_encoded=args.hiddenEncoder, dim_output=args.hiddenGar,
                 keep_hidden=args.samplingType == "sequential",
                 n_levels=args.nLevelsGRU, mode=args.arMode)


def build_model(args: argparse.Namespace) -> CPCModel:
    return CPCModel(gEncoder=get_encoder(args), gAR=get_ar(args))


def load_state(module: nn.Module, state: Dict[str, torch.Tensor],
               what: str) -> None:
    """Load `state` into `module`: every parameter must be there; keys the
    module does not have (constants the JAX package saves, a mask
    embedding) are reported and skipped."""
    result = module.load_state_dict(state, strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{what}: the checkpoint lacks {missing}")
    if result.unexpected_keys:
        print(f"  ({what}: skipped {len(result.unexpected_keys)} keys: "
              f"{result.unexpected_keys[:5]})")


def load_model(path_checkpoints: Sequence[str], loadStateDict: bool = True,
               updateConfig: Optional[argparse.Namespace] = None
               ) -> Tuple[CPCModel, int, int]:
    """Reference `loadModel` (`feature_loader.py:238-283`) for one
    checkpoint: build the model from the checkpoint's saved flags, or from
    those of the checkpoint its run was loaded from, and load its state.
    Returns (model on the CPU, hiddenGar, hiddenEncoder)."""
    if not path_checkpoints:
        raise ValueError("load_model needs one checkpoint path: its saved "
                         "flags define the architecture to build")
    if len(path_checkpoints) > 1:
        raise NotImplementedError(
            f"loading {len(path_checkpoints)} checkpoints as one "
            f"concatenated model is not ported to cpc2_torch (ROADMAP.md "
            f"item: {CONCATENATION})")
    path = path_checkpoints[0]
    print(f"Loading checkpoint {path}")
    cdata = get_checkpoint_data(os.path.dirname(path))
    if cdata is None:
        raise FileNotFoundError(f"no checkpoint run directory at "
                                f"{os.path.dirname(path)}")
    loc_args = cdata[2]
    loaded = getattr(loc_args, 'load', None)
    do_load = loaded is not None and (
        len(loaded) > 1
        or os.path.dirname(loaded[0]) != os.path.dirname(path))
    if updateConfig is not None and not do_load:
        print("Updating the configuration file with")
        print(json.dumps(vars(updateConfig), indent=4, sort_keys=True))
        load_args(loc_args, updateConfig)
    if do_load:
        model, hidden_gar, hidden_encoder = load_model(
            loaded, loadStateDict=False, updateConfig=updateConfig)
    else:
        check_model_ported(loc_args)
        model = build_model(loc_args)
        hidden_gar, hidden_encoder = loc_args.hiddenGar, loc_args.hiddenEncoder
    if loadStateDict:
        print(f"Loading the state dict at {path}")
        load_state(model, load_torch_checkpoint(path)["gEncoder"], "gEncoder")
    return model, hidden_gar, hidden_encoder


loadModel = load_model


class FeatureModule:
    """Feature maker over a `CPCModel`: the context network's output, or
    the encoder's with `get_encoded`, optionally flattened (`collapse`) or
    normalised along time (`seqNorm`). With `keep_hidden` the context
    network's state carries from one call to the next until
    `reset_hidden`. It runs on the model's device, in evaluation mode,
    without gradients and in full fp32."""

    def __init__(self, model: CPCModel, get_encoded: bool,
                 collapse: bool = False, cca_projection: Optional[str] = None,
                 keep_hidden: bool = False, seqNorm: bool = False,
                 train_mode: bool = False):
        if cca_projection:
            raise NotImplementedError(f"cca_projection: not ported to "
                                      f"cpc2_torch (ROADMAP.md item: {_CCA})")
        if train_mode:
            raise NotImplementedError(
                f"train_mode: not ported to cpc2_torch (ROADMAP.md item: "
                f"{_TRAIN_MODE})")
        self.model = model.eval()
        self.get_encoded = get_encoded
        self.collapse = collapse
        self.keep_hidden = keep_hidden
        self.seqNorm = seqNorm
        self.hidden = None
        self.device = next(model.parameters()).device

    def get_downsampling_factor(self) -> int:
        return DOWNSAMPLING

    getDownsamplingFactor = get_downsampling_factor

    def reset_hidden(self) -> None:
        self.hidden = None

    def __call__(self, data) -> torch.Tensor:
        """data: (audio (B, T), label); audio may also be (B, 1, T) or
        (B, 1, 1, T). Returns (B, frames, D) on the model's device."""
        batch_audio, _label = data
        x = torch.as_tensor(np.ascontiguousarray(batch_audio,
                                                 dtype=np.float32))
        x = x.reshape(x.shape[0], x.shape[-1]).to(self.device)
        with torch.no_grad(), full_fp32():
            c, e, h = self.model(x, self.hidden)
        if self.keep_hidden:
            self.hidden = h
        feats = e if self.get_encoded else c
        if self.seqNorm:
            feats = seqNormalization(feats)
        if self.collapse:
            feats = feats.reshape(-1, feats.shape[-1])
        return feats


def seqNormalization(out: torch.Tensor) -> torch.Tensor:
    """Normalise along time (reference `feature_loader.py:316-320`)."""
    mean = out.mean(dim=1, keepdim=True)
    var = out.var(dim=1, keepdim=True, unbiased=True)
    return (out - mean) / torch.sqrt(var + 1e-08)


def _downsampling(feature_maker) -> int:
    return (feature_maker.get_downsampling_factor()
            if hasattr(feature_maker, 'get_downsampling_factor')
            else DOWNSAMPLING)


def _chunked(feature_maker: Callable, audio: np.ndarray, maxSizeSeq: int,
             seqNorm: bool, strict: bool) -> torch.Tensor:
    """Features of `audio` (B, T) in chunks of `maxSizeSeq` samples, one
    call each, concatenated along time (reference
    `feature_loader.py:323-367`)."""
    size_seq = audio.shape[-1]
    chunks = []
    start = 0

    def run(piece):
        feats = feature_maker((piece, None))
        return seqNormalization(feats) if seqNorm else feats

    while start < size_seq:
        if strict and start + maxSizeSeq > size_seq:
            break
        chunks.append(run(audio[:, start:min(size_seq, start + maxSizeSeq)]))
        start += maxSizeSeq
    if strict and start < size_seq:
        delta = (size_seq - start) // _downsampling(feature_maker)
        chunks.append(run(audio[:, -maxSizeSeq:])[:, -delta:])
    return torch.cat(chunks, dim=1) if len(chunks) > 1 else chunks[0]


def build_feature(feature_maker: Callable, seq_path: str, strict: bool = False,
                  maxSizeSeq: int = 64000, seqNorm: bool = False
                  ) -> np.ndarray:
    """Whole-file features (1, frames, D) as numpy. As in the JAX package,
    the context network's state is reset at the start of every file, so a
    file's features depend on that file alone."""
    seq, _sr = load_audio(seq_path)
    if hasattr(feature_maker, 'reset_hidden'):
        feature_maker.reset_hidden()
    feats = _chunked(feature_maker, np.asarray(seq, np.float32)[None],
                     maxSizeSeq, seqNorm, strict)
    return feats.cpu().numpy()


buildFeature = build_feature


def build_feature_files(feature_maker: Callable, seq_paths,
                        maxSizeSeq: int = 64000, seqNorm: bool = False,
                        strict: bool = False, max_batch: int = 16
                        ) -> Dict[str, np.ndarray]:
    """Whole-corpus features, batched across files (counterpart of
    `cpc2_tpu/feature_loader.py:build_feature_files`).

    Files with the same number of samples have the same chunks, so up to
    `max_batch` of them run as one batch per chunk, the context network's
    state carried across a batch's chunks (its batch axis is the file
    axis); each file's features match `build_feature`'s. Files are
    decoded on a thread pool while earlier batches run, and every batch's
    features stay on the device until the end. Returns {path: (1, frames,
    D) numpy}."""

    def decode(path):
        return path, np.asarray(load_audio(path)[0], dtype=np.float32)

    pending = []       # (paths of the batch, device (B, frames, D))

    def run_batch(items):
        if hasattr(feature_maker, 'reset_hidden'):
            feature_maker.reset_hidden()
        stack = np.stack([seq for _, seq in items])
        pending.append(([p for p, _ in items],
                        _chunked(feature_maker, stack, maxSizeSeq, seqNorm,
                                 strict)))

    buckets = defaultdict(list)
    with ThreadPoolExecutor(max_workers=4) as pool:
        for path, seq in pool.map(decode, seq_paths):
            buckets[seq.shape[-1]].append((path, seq))
            if len(buckets[seq.shape[-1]]) >= max_batch:
                run_batch(buckets.pop(seq.shape[-1]))
    for items in buckets.values():
        run_batch(items)

    out = {}
    for paths, feats in pending:
        whole = feats.cpu().numpy()
        for j, path in enumerate(paths):
            out[path] = whole[j:j + 1]
    return out


buildFeature_files = build_feature_files
