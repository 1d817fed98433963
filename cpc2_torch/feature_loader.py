"""Model factories, checkpoint loading and feature extraction (counterpart
of `cpc2_tpu/feature_loader.py`, reference `cpc/feature_loader.py`).

`load_model` builds a `CPCModel` from a checkpoint's saved flags and loads
its `gEncoder` state dict, which the port's modules take unchanged whether
the port or the JAX package wrote it; several checkpoints make one
`ConcatenatedModel`. `FeatureModule` turns audio into the
context network's (or the encoder's) features on the model's device,
under `torch.no_grad()` and in full fp32, with the dropout on
(`train_mode`) or a CCA projection on top (`cca_projection`) if asked.
`build_feature` extracts one file in chunks; `build_feature_batch` runs a
file's chunks as one batch, with no state carried; `build_feature_files`
batches files of equal length (or of the same number of
`bucket_frames`-frame buckets) and carries the context network's state
across their chunks.
`ModelPhoneCombined`, `ModelClusterCombined` and `CPCModule` put a phone
classifier, a k-means quantizer or the CPC criterion's scores on top of a
feature maker.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .config import check_model_ported
from .data.audio_io import load_audio
from .io.checkpoint import (get_checkpoint_data, load_args,
                            load_torch_checkpoint)
from .models import (CPCAR, BiDIRARTangled, CPCBertModel, CPCEncoder,
                     CPCModel, ConcatenatedModel, LFBEncoder, MFCCEncoder,
                     NoAr, build_transformer_ar)
from .models.encoder import DOWNSAMPLING
from .models.layers import Dropout
from .models.transformer import FFNetwork, ScaledDotProductAttention
from .research.cca import load_cca
from .training import full_fp32

# the modules whose `training` flag turns their dropout on, and nothing else
_DROPOUT_MODULES = (Dropout, FFNetwork, ScaledDotProductAttention)


def get_encoder(args: argparse.Namespace) -> nn.Module:
    """`--encoder_type` (reference `feature_loader.py:202-212`): the MFCC or
    learned-filterbank front-end, else the conv encoder."""
    if args.encoder_type == 'mfcc':
        return MFCCEncoder(dim_encoded=args.hiddenEncoder)
    if args.encoder_type == 'lfb':
        return LFBEncoder(dim_encoded=args.hiddenEncoder)
    return CPCEncoder(size_hidden=args.hiddenEncoder, norm_mode=args.normMode)


def get_ar(args: argparse.Namespace) -> nn.Module:
    """The context network (reference `feature_loader.py:215-235`): the
    transformer, else with `--cpc_mode bert` the bidirectional GRU, else
    none or a recurrent one, time-reversed with `--cpc_mode reverse`. Like
    the reference, the transformer AR sets `args.hiddenGar =
    args.hiddenEncoder` in place."""
    if args.arMode == 'transformer':
        ar = build_transformer_ar(args.hiddenEncoder, args.hiddenGar,
                                  args.nLevelsGRU,
                                  args.sizeWindow // DOWNSAMPLING,
                                  args.abspos)
        args.hiddenGar = args.hiddenEncoder
        return ar
    if args.cpc_mode == 'bert':
        return BiDIRARTangled(dim_encoded=args.hiddenEncoder,
                              dim_output=args.hiddenGar,
                              n_levels=args.nLevelsGRU)
    if args.arMode == 'no_ar':
        return NoAr()
    return CPCAR(dim_encoded=args.hiddenEncoder, dim_output=args.hiddenGar,
                 keep_hidden=args.samplingType == "sequential",
                 n_levels=args.nLevelsGRU, mode=args.arMode,
                 reverse=args.cpc_mode == 'reverse')


def build_model(args: argparse.Namespace) -> CPCModel:
    """The model of the flags: a `CPCBertModel` under `--cpc_mode bert`,
    else a `CPCModel` (with `mask_emb` under `--mask_prob`)."""
    encoder, ar = get_encoder(args), get_ar(args)
    if args.cpc_mode == 'bert':
        return CPCBertModel(encoder, ar,
                            supervised=getattr(args, 'supervised', False))
    return CPCModel(encoder, ar, mask_prob=getattr(args, 'mask_prob', 0.0))


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
               ) -> Tuple[nn.Module, int, int]:
    """Reference `loadModel` (`feature_loader.py:238-283`): build each
    checkpoint's model from its saved flags, or from those of the
    checkpoints its run was loaded from, and load its state; several
    checkpoints make one `ConcatenatedModel`, whose widths add up.
    Returns (model on the CPU, hiddenGar, hiddenEncoder)."""
    if not path_checkpoints:
        raise ValueError("load_model needs at least one checkpoint path: "
                         "its saved flags define the architecture to build")
    models, hidden_gar, hidden_encoder = [], 0, 0
    for path in path_checkpoints:
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
            model, hg, he = load_model(loaded, loadStateDict=False,
                                       updateConfig=updateConfig)
        else:
            check_model_ported(loc_args)
            model = build_model(loc_args)
            hg, he = loc_args.hiddenGar, loc_args.hiddenEncoder
        if loadStateDict:
            print(f"Loading the state dict at {path}")
            load_state(model, load_torch_checkpoint(path)["gEncoder"],
                       "gEncoder")
        models.append(model)
        hidden_gar += hg
        hidden_encoder += he
    model = models[0] if len(models) == 1 else ConcatenatedModel(models)
    return model, hidden_gar, hidden_encoder


loadModel = load_model


class FeatureModule:
    """Feature maker over a `CPCModel` or a `ConcatenatedModel`: the context
    network's output, or
    the encoder's with `get_encoded`, optionally flattened (`collapse`) or
    normalised along time (`seqNorm`). With `keep_hidden` the context
    network's state carries from one call to the next until
    `reset_hidden`. It runs on the model's device, in evaluation mode,
    without gradients and in full fp32.

    `train_mode` keeps the dropout on while the features are made (the
    reference skips `featureMaker.eval()`): for the length of each call the
    dropout modules alone are put in training mode, and the masks (and the
    kernels' dropout seeds) come from one `torch.Generator` on the model's
    device seeded with `train_mode_seed`, so that each call draws anew and
    a second instance replays the stream. The JAX package cannot run it
    over a `batchNorm` encoder (its forward would have to update the
    running statistics), and neither does this one.

    `cca_projection` is the path of a pickled CCA, the port's own
    (`research/train_cca.py`) or scikit-learn's, read without scikit-learn;
    its X-side projection is applied to the features on the model's
    device."""

    def __init__(self, model: nn.Module, get_encoded: bool,
                 collapse: bool = False, cca_projection: Optional[str] = None,
                 keep_hidden: bool = False, seqNorm: bool = False,
                 train_mode: bool = False, train_mode_seed: int = 0):
        self.model = model.eval()
        self.get_encoded = get_encoded
        self.collapse = collapse
        self.keep_hidden = keep_hidden
        self.seqNorm = seqNorm
        self.hidden = None
        self.device = next(model.parameters()).device
        self.train_mode = train_mode
        self.generator = None
        if train_mode:
            if any(isinstance(m, nn.modules.batchnorm._BatchNorm)
                   for m in model.modules()):
                raise ValueError(
                    "train_mode with --normMode batchNorm: in training "
                    "mode the encoder's BatchNorm would update its running "
                    "statistics, which the JAX package's feature forward "
                    "refuses (flax: the batch_stats collection is "
                    "immutable); extract in evaluation mode or from a "
                    "model with another --normMode")
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(train_mode_seed)
        self.cca_projection = None
        if cca_projection:
            print("Loading canonical correlation analysis model.")
            self.cca_projection = load_cca(cca_projection).to(self.device)

    @property
    def out_feature_dim(self) -> int:
        return (self.model.dim_encoded if self.get_encoded
                else self.model.dim_context)

    def get_downsampling_factor(self) -> int:
        return DOWNSAMPLING

    getDownsamplingFactor = get_downsampling_factor

    def reset_hidden(self) -> None:
        self.hidden = None

    @contextlib.contextmanager
    def _dropout_on(self):
        """The dropout modules in training mode for the `with` block, then
        back as they were; nothing else of the model changes mode."""
        if not self.train_mode:
            yield
            return
        modules = [m for m in self.model.modules()
                   if isinstance(m, _DROPOUT_MODULES)]
        modes = [m.training for m in modules]
        try:
            for m in modules:
                m.training = True
            yield
        finally:
            for m, mode in zip(modules, modes):
                m.training = mode

    def __call__(self, data) -> torch.Tensor:
        """data: (audio (B, T), label); audio may also be (B, 1, T) or
        (B, V, 1, T), of which the first view (V = 2: a training batch's
        past) is taken, as numpy or a tensor. Returns (B, frames, D) on the
        model's device (D the CCA's components with a projection)."""
        batch_audio, _label = data
        x = _as_tensor(batch_audio).to(self.device, torch.float32)
        while x.ndim > 2:
            x = x[:, 0]
        with torch.no_grad(), full_fp32(), self._dropout_on():
            c, e, h = self.model(x, self.hidden, self.generator)
        if self.keep_hidden:
            self.hidden = h
        feats = e if self.get_encoded else c
        if self.seqNorm:
            feats = seqNormalization(feats)
        if self.collapse:
            feats = feats.reshape(-1, feats.shape[-1])
        if self.cca_projection is not None:
            feats = self.cca_projection(feats)
        return feats


def seqNormalization(out: torch.Tensor) -> torch.Tensor:
    """Normalise along time (reference `feature_loader.py:316-320`)."""
    mean = out.mean(dim=1, keepdim=True)
    var = out.var(dim=1, keepdim=True, unbiased=True)
    return (out - mean) / torch.sqrt(var + 1e-08)


def _as_tensor(x) -> torch.Tensor:
    """A feature maker's output as a tensor where it lies (numpy on the
    CPU)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _downsampling(feature_maker) -> int:
    return (feature_maker.get_downsampling_factor()
            if hasattr(feature_maker, 'get_downsampling_factor')
            else DOWNSAMPLING)


def _run(feature_maker: Callable, piece: np.ndarray,
         seqNorm: bool) -> torch.Tensor:
    feats = _as_tensor(feature_maker((piece, None)))
    return seqNormalization(feats) if seqNorm else feats


def _chunked(feature_maker: Callable, audio: np.ndarray, maxSizeSeq: int,
             seqNorm: bool, strict: bool) -> torch.Tensor:
    """Features of `audio` (B, T) in chunks of `maxSizeSeq` samples, one
    call each, concatenated along time (reference
    `feature_loader.py:323-367`)."""
    size_seq = audio.shape[-1]
    chunks = []
    start = 0
    while start < size_seq:
        if strict and start + maxSizeSeq > size_seq:
            break
        chunks.append(_run(feature_maker, audio[:, start:min(
            size_seq, start + maxSizeSeq)], seqNorm))
        start += maxSizeSeq
    if strict and start < size_seq:
        delta = (size_seq - start) // _downsampling(feature_maker)
        chunks.append(_run(feature_maker, audio[:, -maxSizeSeq:],
                           seqNorm)[:, -delta:])
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


def build_feature_batch(feature_maker: Callable, seq_path: str,
                        strict: bool = False, maxSizeSeq: int = 8000,
                        seqNorm: bool = False, batch_size: int = 8
                        ) -> np.ndarray:
    """Whole-file features (1, frames, D) as numpy, the file's whole chunks
    of `maxSizeSeq` samples run `batch_size` at a time as one batch, each
    chunk on its own (no state carried from one to the next), then the
    remainder (the last `maxSizeSeq` samples' final frames when `strict`)
    (reference `feature_loader.py:370-433`)."""
    seq, _sr = load_audio(seq_path)
    seq = np.asarray(seq, dtype=np.float32)
    size_seq = seq.shape[-1]
    n_chunks = size_seq // maxSizeSeq
    n_batches = -(-n_chunks // batch_size)
    out = []
    for batch_idx in range(n_batches):
        start = batch_idx * batch_size * maxSizeSeq
        end = min((batch_idx + 1) * batch_size * maxSizeSeq,
                  maxSizeSeq * n_chunks)
        feats = _run(feature_maker, seq[start:end].reshape(-1, maxSizeSeq),
                     seqNorm)
        # the chunks' frames one after the other along time
        out.append(feats.reshape(1, -1, feats.shape[-1]))
    remainder = size_seq % maxSizeSeq
    ds = _downsampling(feature_maker)
    if remainder >= ds:
        if strict:
            out.append(_run(feature_maker, seq[-maxSizeSeq:][None],
                            seqNorm)[:, -(remainder // ds):])
        else:
            out.append(_run(feature_maker, seq[-remainder:][None], seqNorm))
    return torch.cat(out, dim=1).cpu().numpy()


buildFeature_batch = build_feature_batch


def build_feature_files(feature_maker: Callable, seq_paths,
                        maxSizeSeq: int = 64000, seqNorm: bool = False,
                        strict: bool = False, max_batch: int = 16,
                        bucket_frames: int = 0) -> Dict[str, np.ndarray]:
    """Whole-corpus features, batched across files (counterpart of
    `cpc2_tpu/feature_loader.py:build_feature_files`).

    Files with the same number of samples have the same chunks, so up to
    `max_batch` of them run as one batch per chunk, the context network's
    state carried across a batch's chunks (its batch axis is the file
    axis); each file's features match `build_feature`'s. With
    `bucket_frames > 0` every file is zero-padded up to the next multiple
    of `bucket_frames` encoded frames, so that files of different lengths
    share batches, and its features are cut back to its own frame count
    (the padding reaches the last few frames through the encoder's edge,
    as in the JAX package). Files are decoded (and padded) on a thread
    pool while earlier batches run, and every batch's features stay on the
    device until the end. Returns {path: (1, frames, D) numpy}."""
    ds = _downsampling(feature_maker)

    def decode(path):
        seq = np.asarray(load_audio(path)[0], dtype=np.float32)
        frames = seq.shape[-1] // ds
        if bucket_frames > 0:
            padded = -(-max(frames, 1) // bucket_frames) * bucket_frames
            pad = padded * ds - seq.shape[-1]
            if pad > 0:
                seq = np.pad(seq, (0, pad))
        return path, frames, seq

    pending = []       # (paths of the batch, device (B, frames, D))

    def run_batch(items):
        if hasattr(feature_maker, 'reset_hidden'):
            feature_maker.reset_hidden()
        stack = np.stack([seq for _, seq in items])
        pending.append(([p for p, _ in items],
                        _chunked(feature_maker, stack, maxSizeSeq, seqNorm,
                                 strict)))

    true_frames = {}
    buckets = defaultdict(list)
    with ThreadPoolExecutor(max_workers=4) as pool:
        for path, frames, seq in pool.map(decode, seq_paths):
            true_frames[path] = frames
            buckets[seq.shape[-1]].append((path, seq))
            if len(buckets[seq.shape[-1]]) >= max_batch:
                run_batch(buckets.pop(seq.shape[-1]))
    for items in buckets.values():
        run_batch(items)

    out = {}
    for paths, feats in pending:
        whole = feats.cpu().numpy()
        for j, path in enumerate(paths):
            out[path] = (whole[j:j + 1, :true_frames[path]]
                         if bucket_frames > 0 else whole[j:j + 1])
    return out


buildFeature_files = build_feature_files


# ---------------------------------------------------------------------------
# Combined feature makers (counterparts of `cpc2_tpu/feature_loader.py:
# 583-714`, reference `feature_loader.py:57-173`)
# ---------------------------------------------------------------------------

def to_one_hot(input_vector: torch.Tensor, n_items: int) -> torch.Tensor:
    """(B, S) int -> (B, S, n_items) int32 one-hot
    (reference `feature_loader.py:307-313`)."""
    return torch.nn.functional.one_hot(input_vector.long(),
                                       n_items).to(torch.int32)


toOneHot = to_one_hot


class CriterionWrapper:
    """A criterion module exposing `get_prediction`, run without gradients
    and in full fp32 (the JAX package's wrapper holds a flax module and its
    parameters)."""

    def __init__(self, module: nn.Module):
        self.module = module.eval()

    def to(self, device) -> "CriterionWrapper":
        self.module.to(device)
        return self

    def get_prediction(self, c_feature: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), full_fp32():
            return self.module.get_prediction(c_feature)


def load_supervised_criterion(path_checkpoint: str):
    """Reference `loadSupervisedCriterion` (`feature_loader.py:159-173`):
    the phone classifier of a `--supervised --pathPhone` run, built from
    its saved flags (`n_phones` from `--pathPhone`'s labels) and loaded
    from the checkpoint's `cpcCriterion`, on the CPU. Returns
    (CriterionWrapper, n_phones)."""
    from .data.corpus import parse_seq_labels
    from .losses import PhoneCriterion
    *_, args = get_checkpoint_data(os.path.dirname(path_checkpoint))
    _, n_phones = parse_seq_labels(args.pathPhone)
    criterion = PhoneCriterion(args.hiddenGar, args.hiddenEncoder, n_phones,
                               on_encoder=args.onEncoder,
                               n_layers=getattr(args, 'nLevelsPhone', 1))
    load_state(criterion, load_torch_checkpoint(path_checkpoint)[
        "cpcCriterion"], "cpcCriterion")
    return CriterionWrapper(criterion), n_phones


loadSupervisedCriterion = load_supervised_criterion


class ModelPhoneCombined:
    """Feature maker + phone classifier: per frame the phones' softmax, or
    with `one_hot` the argmax's one-hot (reference
    `feature_loader.py:85-115`)."""

    def __init__(self, model: Callable, criterion: CriterionWrapper,
                 one_hot: bool):
        self.model = model
        self.criterion = criterion
        self.oneHot = one_hot

    def get_downsampling_factor(self) -> int:
        return self.model.get_downsampling_factor()

    getDownsamplingFactor = get_downsampling_factor

    def __call__(self, data) -> torch.Tensor:
        pred = self.criterion.get_prediction(_as_tensor(self.model(data)))
        if self.oneHot:
            return to_one_hot(pred.argmax(dim=2), pred.shape[2])
        return torch.softmax(pred, dim=2)


class ModelClusterCombined:
    """Feature maker + k-means quantizer: per frame the nearest centroid as
    a one-hot (`oneHot`) or an id (`int`), or the softmax of the negated
    squared distances (`softmax`) (reference `feature_loader.py:118-147`)."""

    def __init__(self, model: Callable, cluster: nn.Module, nk: int,
                 out_format: str):
        if out_format not in ['oneHot', 'int', 'softmax']:
            raise ValueError(f'Invalid output format {out_format}')
        self.model = model
        self.cluster = cluster
        self.nk = nk
        self.outFormat = out_format

    def get_downsampling_factor(self) -> int:
        return self.model.get_downsampling_factor()

    getDownsamplingFactor = get_downsampling_factor

    def __call__(self, data) -> torch.Tensor:
        dist = self.cluster(_as_tensor(self.model(data)))
        if self.outFormat == 'oneHot':
            return to_one_hot(dist.argmin(dim=2), self.nk)
        if self.outFormat == 'int':
            return dist.argmin(dim=2)
        return torch.softmax(-dist, dim=2)


class CPCModule:
    """The CPC criterion's positive scores as features: for each window
    frame the `n_pred`-th head's score, softmaxed over the window unless
    `main_distance_only` (reference `feature_loader.py:57-82`). The model
    and the criterion run on the model's device in evaluation mode, without
    gradients and in full fp32, so the heads' FFNs take their fp32 route."""

    def __init__(self, model: nn.Module, criterion_wrapper: CriterionWrapper,
                 main_distance_only: bool = False, n_pred: int = -1):
        self.model = model.eval()
        self.criterion = criterion_wrapper
        self.n_pred = n_pred
        self.main_distance_only = main_distance_only
        self.device = next(model.parameters()).device

    def get_downsampling_factor(self) -> int:
        return DOWNSAMPLING

    getDownsamplingFactor = get_downsampling_factor

    def __call__(self, data) -> torch.Tensor:
        batch_audio, _label = data
        x = _as_tensor(batch_audio).to(self.device, torch.float32)
        if x.ndim >= 3:
            x = x.reshape(x.shape[0], -1)
        with torch.no_grad(), full_fp32():
            c, e, _h = self.model(x)
            distances = self.criterion.module.cosine_distances(c, e)
        preds = distances[:, self.n_pred]                    # (B, W)
        if self.main_distance_only:
            return preds
        return torch.softmax(preds, dim=1)
