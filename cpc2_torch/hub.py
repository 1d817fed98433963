"""Hub-style entry of the port (counterpart of the root `hubconf.py`,
reference `hubconf.py`).

`CPC_audio()` builds the CPC model of the default configuration (keyword
arguments override its flags) on the card, or on the CPU with
`device='cpu'`; `pretrained_path` loads a payload in the layout of the
published libri-light 60k checkpoint, `{'config': the training flags,
'weights': the flat gEncoder.* / gAR.* state dict}`, and `pretrained=True`
downloads that checkpoint. Returns a `models.cpc.CPCModel`: `model(audio
(B, T))` gives `(context, encodings, hidden)`.

    from cpc2_torch.hub import CPC_audio
    model = CPC_audio(pretrained_path="60k_epoch4-d0f474de.pt")
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import torch

from .config import check_model_ported, get_default_cpc_config
from .feature_loader import build_model, load_state
from .io.checkpoint import load_args
from .models import CPCModel
from .training import resolve_device

PRETRAINED_URL = ('https://dl.fbaipublicfiles.com/librilight/'
                  'CPC_checkpoints/60k_epoch4-d0f474de.pt')


def _model(flags: Dict[str, Any]) -> CPCModel:
    """The model of the default configuration with `flags` over it; raises
    for a configuration the port cannot build."""
    loc_args = get_default_cpc_config()
    load_args(loc_args, argparse.Namespace(**flags))
    check_model_ported(loc_args)
    return build_model(loc_args)


def model_from_hub_payload(checkpoint: Dict[str, Any]) -> CPCModel:
    """The model of a hub payload (`{'config', 'weights'}`) on the CPU,
    every parameter loaded from `weights` (a missing one raises)."""
    model = _model(checkpoint["config"])
    load_state(model, checkpoint["weights"], "weights")
    return model


def CPC_audio(pretrained: bool = False, pretrained_path: str = None,
              **kwargs) -> CPCModel:
    """Contrastive predictive coding model for audio.

    pretrained: load the model trained on libri-light 60k
    (https://arxiv.org/abs/1912.07875), downloaded.
    pretrained_path: load such a payload from a local file instead.
    device: `cuda` (the default; raises without a card) or `cpu`.
    **kwargs: the flags of `cpc2_torch/config.py:set_default_cpc_config`
    for a model built from scratch."""
    device = resolve_device(kwargs.pop('device', 'cuda'))
    if pretrained or pretrained_path is not None:
        if pretrained_path is not None:
            checkpoint = torch.load(pretrained_path, map_location='cpu',
                                    weights_only=False)
        else:
            checkpoint = torch.hub.load_state_dict_from_url(
                PRETRAINED_URL, progress=False, map_location='cpu')
        return model_from_hub_payload(checkpoint).to(device)
    return _model(kwargs).to(device)
