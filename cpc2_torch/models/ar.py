"""Autoregressive context networks (counterpart of `cpc2_tpu/models/ar.py`,
reference `cpc/model.py:158-216`).

The input projection of every step, `x @ W_ihᵀ + b_ih`, is one large matmul
over all timesteps; only the hidden-to-hidden recurrence runs step by step.
In LSTM mode that recurrence is the CUDA kernel of `ops/lstm.py`. GRU and
RNN modes, which no TPU kernel covers, run their recurrence in plain
PyTorch. Parameters carry torch's RNN names (`weight_ih_l0`, ...), so the
reference's `gAR.baseNet.*` keys load unchanged.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.lstm import fused_lstm

Tensor = torch.Tensor

_N_GATES = {"GRU": 3, "LSTM": 4, "RNN": 1}


def _gru_scan(gi: Tensor, h: Tensor, w_hh: Tensor,
              b_hh: Tensor) -> Tuple[Tensor, Tensor]:
    ys = []
    for t in range(gi.shape[1]):
        i_r, i_z, i_n = gi[:, t].chunk(3, dim=-1)
        h_r, h_z, h_n = (h @ w_hh.t() + b_hh).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return torch.stack(ys, dim=1), h


def _rnn_scan(gi: Tensor, h: Tensor, w_hh: Tensor,
              b_hh: Tensor) -> Tuple[Tensor, Tensor]:
    ys = []
    for t in range(gi.shape[1]):
        h = torch.tanh(gi[:, t] + h @ w_hh.t() + b_hh)
        ys.append(h)
    return torch.stack(ys, dim=1), h


class StackedRNN(nn.Module):
    """Multi-layer uni-directional RNN with torch's parameter names and
    initialization, U(-1/sqrt(H), 1/sqrt(H)) for every tensor."""

    def __init__(self, dim_input: int, dim_hidden: int, num_layers: int = 1,
                 mode: str = "GRU"):
        super().__init__()
        if mode not in _N_GATES:
            raise ValueError(f"unknown RNN mode {mode!r}")
        self.mode = mode
        self.num_layers = num_layers
        self.dim_hidden = dim_hidden
        gates = _N_GATES[mode] * dim_hidden
        bound = 1.0 / math.sqrt(dim_hidden)
        for layer in range(num_layers):
            d_in = dim_input if layer == 0 else dim_hidden
            for name, shape in ((f"weight_ih_l{layer}", (gates, d_in)),
                                (f"weight_hh_l{layer}", (gates, dim_hidden)),
                                (f"bias_ih_l{layer}", (gates,)),
                                (f"bias_hh_l{layer}", (gates,))):
                self.register_parameter(name, nn.Parameter(
                    torch.empty(shape).uniform_(-bound, bound)))

    def forward(self, x: Tensor, hidden=None):
        """x: (B, T, D). hidden: None (zeros), (L, B, H), or an `(h, c)`
        pair of those in LSTM mode. Returns (ys (B, T, H), new_hidden)."""
        b = x.shape[0]
        zeros = x.new_zeros((self.num_layers, b, self.dim_hidden))
        if hidden is None:
            h0s, c0s = zeros, zeros
        elif self.mode == "LSTM":
            h0s, c0s = hidden
        else:
            h0s, c0s = hidden, None
        out = x
        h_lasts, c_lasts = [], []
        for layer in range(self.num_layers):
            w_ih = getattr(self, f"weight_ih_l{layer}")
            w_hh = getattr(self, f"weight_hh_l{layer}")
            b_ih = getattr(self, f"bias_ih_l{layer}")
            b_hh = getattr(self, f"bias_hh_l{layer}")
            gi = torch.matmul(out, w_ih.t()) + b_ih
            if self.mode == "LSTM":
                out, h_last, c_last = fused_lstm(gi, h0s[layer], c0s[layer],
                                                 w_hh, b_hh)
                c_lasts.append(c_last)
            elif self.mode == "GRU":
                out, h_last = _gru_scan(gi, h0s[layer], w_hh, b_hh)
            else:
                out, h_last = _rnn_scan(gi, h0s[layer], w_hh, b_hh)
            h_lasts.append(h_last)
        new_hidden = torch.stack(h_lasts)
        if self.mode == "LSTM":
            new_hidden = (new_hidden, torch.stack(c_lasts))
        return out, new_hidden


class CPCAR(nn.Module):
    """GRU/LSTM/RNN context network. `forward(x, hidden)` returns
    `(context, new_hidden)`; the caller decides whether to carry
    `new_hidden` into the next batch (the reference's `keepHidden`)."""

    def __init__(self, dim_encoded: int, dim_output: int,
                 keep_hidden: bool = False, n_levels: int = 1,
                 mode: str = "GRU"):
        super().__init__()
        self.keep_hidden = keep_hidden
        self.baseNet = StackedRNN(dim_encoded, dim_output, n_levels, mode)

    def forward(self, x: Tensor, hidden=None, generator=None):
        """`generator` is unused: the recurrence draws nothing."""
        return self.baseNet(x, hidden)


class NoAr(nn.Module):
    """Identity context network (reference `cpc/model.py:210-216`)."""

    def forward(self, x: Tensor, hidden: Optional[Tensor] = None,
                generator=None):
        return x, None
