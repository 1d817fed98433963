"""Model factories (counterpart of the factories of
`cpc2_tpu/feature_loader.py`, reference `cpc/feature_loader.py:202-235`).

Feature extraction and checkpoint loading are not ported yet (ROADMAP).
"""

from __future__ import annotations

import argparse

from torch import nn

from .models import (CPCAR, CPCEncoder, CPCModel, NoAr,
                     build_transformer_ar)
from .models.encoder import DOWNSAMPLING


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
