"""LSTM hidden-to-hidden recurrence with a hand-written CUDA kernel.

Counterpart of `cpc2_tpu/ops/lstm_pallas.py:fused_lstm`. The input
projection `gi = x @ W_ihᵀ + b_ih` of every step is computed outside (one
large matmul, `models/ar.py`); the kernel runs only the serial part, in
torch gate order (i, f, g, o), with a `(h0, c0)` carry in and
`(ys, h_last, c_last)` out. The forward saves the cell states and the
post-activation gates; the backward (`csrc/lstm.cu`) walks time in reverse
with the cell algebra of the TPU kernel's `_bwd_kernel` and gives
`dgi, dh0, dc0, dW_hh, db_hh`.

What bounds it is latency, not bytes or operations: each step is a tiny
(B, H) x (H, 4H) product that depends on the step before. The TPU kernel
keeps W_hh resident in VMEM; 1 MB does not fit one SM's shared memory, so
here each step is one launch whose blocks own a slice of hidden units and
read their W_hh rows from L2 (`csrc/lstm.cu`).

`fused_lstm` launches the kernel for CUDA tensors and runs `lstm_plain`
for CPU tensors; there is no other path.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

Tensor = torch.Tensor


def lstm_plain(gi: Tensor, h0: Tensor, c0: Tensor, w_hh: Tensor,
               b_hh: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The recurrence in plain PyTorch (autograd gives its backward).

    gi: (B, T, 4H); h0, c0: (B, H); w_hh: (4H, H); b_hh: (4H,)."""
    h, c = h0, c0
    ys = []
    for t in range(gi.shape[1]):
        gates = gi[:, t] + h @ w_hh.t() + b_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c = f * c + i * torch.tanh(g)
        h = o * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1), h, c


def _check(gi, h0, c0, w_hh, b_hh) -> torch.device:
    device = _build.check_cuda("fused_lstm", gi, h0, c0, w_hh, b_hh)
    _build.check_f32("fused_lstm", gi, h0, c0, w_hh, b_hh)
    b, t, g4 = gi.shape
    hdim = g4 // 4
    if (g4 != 4 * hdim or tuple(h0.shape) != (b, hdim)
            or tuple(c0.shape) != (b, hdim)
            or tuple(w_hh.shape) != (g4, hdim) or tuple(b_hh.shape) != (g4,)):
        raise ValueError(
            f"fused_lstm: inconsistent shapes gi {tuple(gi.shape)}, h0 "
            f"{tuple(h0.shape)}, c0 {tuple(c0.shape)}, w_hh "
            f"{tuple(w_hh.shape)}, b_hh {tuple(b_hh.shape)}")
    if t == 0:
        raise ValueError("fused_lstm: the sequence is empty")
    return device


class _FusedLSTM(torch.autograd.Function):

    @staticmethod
    def forward(ctx, gi, h0, c0, w_hh, b_hh):
        device = _check(gi, h0, c0, w_hh, b_hh)
        gi, h0, c0 = gi.contiguous(), h0.contiguous(), c0.contiguous()
        w_hh, b_hh = w_hh.contiguous(), b_hh.contiguous()
        b, t, g4 = gi.shape
        hdim = g4 // 4
        ys = torch.empty((b, t, hdim), device=device)
        cs = torch.empty_like(ys)
        ga = torch.empty_like(gi)
        h_last = torch.empty_like(h0)
        c_last = torch.empty_like(c0)
        _build.launch("lstm_fwd", "cpc2_lstm_fwd", device,
                      gi.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                      w_hh.data_ptr(), b_hh.data_ptr(), ys.data_ptr(),
                      cs.data_ptr(), ga.data_ptr(), h_last.data_ptr(),
                      c_last.data_ptr(), b, t, hdim)
        ctx.save_for_backward(ys, cs, ga, h0, c0, w_hh)
        return ys, h_last, c_last

    @staticmethod
    def backward(ctx, dys, dh_last, dc_last):
        ys, cs, ga, h0, c0, w_hh = ctx.saved_tensors
        device = ys.device
        b, t, hdim = ys.shape
        dys = torch.zeros_like(ys) if dys is None else dys.contiguous()
        dh_last = (torch.zeros_like(h0) if dh_last is None
                   else dh_last.contiguous())
        dc_last = (torch.zeros_like(c0) if dc_last is None
                   else dc_last.contiguous())
        # h_{t-1} of every step: the carry-in, then ys without its last step
        hs_prev = torch.cat([h0[:, None], ys[:, :-1]], dim=1)
        w_hh_t = w_hh.t().contiguous()
        dgi = torch.empty_like(ga)
        dh0 = torch.empty_like(h0)
        dc0 = torch.empty_like(c0)
        dw_hh = torch.empty_like(w_hh)
        db_hh = torch.empty((4 * hdim,), device=device)
        _build.launch("lstm_bwd", "cpc2_lstm_bwd", device,
                      w_hh_t.data_ptr(), dys.data_ptr(), dh_last.data_ptr(),
                      dc_last.data_ptr(), cs.data_ptr(), ga.data_ptr(),
                      c0.data_ptr(), hs_prev.data_ptr(), dgi.data_ptr(),
                      dh0.data_ptr(), dc0.data_ptr(), dw_hh.data_ptr(),
                      db_hh.data_ptr(), b, t, hdim)
        return dgi, dh0, dc0, dw_hh, db_hh


def fused_lstm(gi: Tensor, h0: Tensor, c0: Tensor, w_hh: Tensor,
               b_hh: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """LSTM over precomputed input gates, (B, T, ·) layout throughout.

    gi: (B, T, 4H) = x @ W_ihᵀ + b_ih; h0, c0: (B, H); w_hh: (4H, H) torch
    layout; b_hh: (4H,); float32. Returns (ys (B, T, H), h_last, c_last).
    CUDA tensors go through the kernel, CPU tensors through `lstm_plain`."""
    if gi.device.type == "cpu":
        return lstm_plain(gi, h0, c0, w_hh, b_hh)
    return _FusedLSTM.apply(gi, h0, c0, w_hh, b_hh)
