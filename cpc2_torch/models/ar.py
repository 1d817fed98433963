"""Autoregressive context networks (counterpart of `cpc2_tpu/models/ar.py`,
reference `cpc/model.py:158-271`).

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
    initialization, U(-1/sqrt(H), 1/sqrt(H)) for every tensor. Each of
    `suffixes` is a set of parameters (`weight_ih_l0{suffix}`, ...):
    `('', '_reverse')` holds both directions of a bidirectional torch RNN,
    and `forward(..., suffix=)` runs one of them."""

    def __init__(self, dim_input: int, dim_hidden: int, num_layers: int = 1,
                 mode: str = "GRU", suffixes: Tuple[str, ...] = ("",)):
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
            for suffix in suffixes:
                for name, shape in (
                        (f"weight_ih_l{layer}{suffix}", (gates, d_in)),
                        (f"weight_hh_l{layer}{suffix}", (gates, dim_hidden)),
                        (f"bias_ih_l{layer}{suffix}", (gates,)),
                        (f"bias_hh_l{layer}{suffix}", (gates,))):
                    self.register_parameter(name, nn.Parameter(
                        torch.empty(shape).uniform_(-bound, bound)))

    def forward(self, x: Tensor, hidden=None, suffix: str = ""):
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
            w_ih = getattr(self, f"weight_ih_l{layer}{suffix}")
            w_hh = getattr(self, f"weight_hh_l{layer}{suffix}")
            b_ih = getattr(self, f"bias_ih_l{layer}{suffix}")
            b_hh = getattr(self, f"bias_hh_l{layer}{suffix}")
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
    `new_hidden` into the next batch (the reference's `keepHidden`). With
    `reverse` (`--cpc_mode reverse`) time is flipped before the network
    and back after it (reference `cpc/model.py:190-206`)."""

    def __init__(self, dim_encoded: int, dim_output: int,
                 keep_hidden: bool = False, n_levels: int = 1,
                 mode: str = "GRU", reverse: bool = False):
        super().__init__()
        self.keep_hidden = keep_hidden
        self.reverse = reverse
        self.baseNet = StackedRNN(dim_encoded, dim_output, n_levels, mode)

    def forward(self, x: Tensor, hidden=None, generator=None):
        """`generator` is unused: the recurrence draws nothing."""
        if self.reverse:
            x = torch.flip(x, (1,))
        y, new_hidden = self.baseNet(x, hidden)
        if self.reverse:
            y = torch.flip(y, (1,))
        return y, new_hidden


class NoAr(nn.Module):
    """Identity context network (reference `cpc/model.py:210-216`)."""

    def forward(self, x: Tensor, hidden: Optional[Tensor] = None,
                generator=None):
        return x, None


class BiDIRARTangled(nn.Module):
    """One bidirectional GRU, `ARNet`, for BERT-style training (reference
    `cpc/model.py:219-242`): `dim_output // 2` units a direction, the
    backward direction's parameters named with torch's `_reverse` suffix.
    Each direction is its own stack of `n_levels` layers, as in the JAX
    package. Output (B, T, dim_output), the directions concatenated."""

    def __init__(self, dim_encoded: int, dim_output: int, n_levels: int = 1):
        super().__init__()
        self.dim_output = dim_output
        self.ARNet = StackedRNN(dim_encoded, dim_output // 2, n_levels, "GRU",
                                suffixes=("", "_reverse"))

    def forward(self, x: Tensor, hidden=None, generator=None):
        yf, _ = self.ARNet(x)
        yb, _ = self.ARNet(torch.flip(x, (1,)), suffix="_reverse")
        return torch.cat([yf, torch.flip(yb, (1,))], dim=2), None


class BiDIRAR(nn.Module):
    """Two separate GRUs, `netForward` and `netBackward`, concatenated
    (reference `cpc/model.py:245-271`)."""

    def __init__(self, dim_encoded: int, dim_output: int, n_levels: int = 1):
        super().__init__()
        self.dim_output = dim_output
        self.netForward = StackedRNN(dim_encoded, dim_output // 2, n_levels,
                                     "GRU")
        self.netBackward = StackedRNN(dim_encoded, dim_output // 2, n_levels,
                                      "GRU")

    def forward(self, x: Tensor, hidden=None, generator=None):
        yf, _ = self.netForward(x)
        yb, _ = self.netBackward(torch.flip(x, (1,)))
        return torch.cat([yf, torch.flip(yb, (1,))], dim=2), None
