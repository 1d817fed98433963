"""Position-wise FFN `lin2(dropout(relu(lin1(x))))` with a hand-written
CUDA kernel.

Counterpart of `cpc2_tpu/ops/ffn_pallas.py:fused_ffn`: torch-layout weights
W1 (Dff, Din) and W2 (Dout, Dff), a dropout mask drawn inside the kernel
from a seed, and a backward (`csrc/ffn.cu`) that recomputes the hidden and
its mask from that seed instead of saving them. The products are fp32
tiled GEMMs on the card's FMA units with the bias, ReLU and dropout fused
into their epilogues; the work is bound by operations (1.9 GFLOP per head
forward at the recipe).

The mask is a counter-based hash of (seed, row, column), defined the same
way in CUDA (`csrc/common.cuh:dropout_bits`) and in `dropout_bits` below,
so the kernel and `ffn_plain` draw bit-identical masks. The TPU kernel
draws its mask from the TPU's own generator, so against the JAX package
only the distribution matches.

`fused_ffn` launches the kernel for CUDA tensors and runs `ffn_plain` for
CPU tensors; there is no other path.
"""

from __future__ import annotations

import torch

from . import _build

Tensor = torch.Tensor

_M32 = 0xFFFFFFFF


def _mul32(x: Tensor, c: int) -> Tensor:
    """x * c mod 2**32 for int64 tensors holding uint32 values, split in
    16-bit halves of c so that no intermediate leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: Tensor) -> Tensor:
    """`mix32` of csrc/common.cuh on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_bits(seed: Tensor, rows: int, cols: int) -> Tensor:
    """(rows, cols) int64 tensor of the kernel's 32 random bits per element:
    mix32(mix32(seed ^ mix32(row)) + col) in uint32 arithmetic."""
    device = seed.device
    s = seed.reshape(()).to(torch.int64) & _M32
    r = _mix32(torch.arange(rows, device=device, dtype=torch.int64))
    c = torch.arange(cols, device=device, dtype=torch.int64)
    return _mix32((_mix32(s ^ r)[:, None] + c[None, :]) & _M32)


def dropout_threshold(rate: float) -> int:
    """Elements whose bits fall below this are dropped."""
    return min(int(rate * 2.0 ** 32), _M32)


def keep_mask(seed: Tensor, rows: int, cols: int, rate: float) -> Tensor:
    """The kernel's dropout keep mask for a (rows, cols) hidden."""
    return dropout_bits(seed, rows, cols) >= dropout_threshold(rate)


def ffn_plain(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
              seed: Tensor, rate: float = 0.0) -> Tensor:
    """The FFN in plain PyTorch, with the kernel's mask (autograd gives its
    backward). x: (M, Din); seed: one int32 value."""
    h = torch.relu(x @ w1.t() + b1)
    if rate > 0.0:
        keep = keep_mask(seed, x.shape[0], w1.shape[0], rate)
        h = torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))
    return h @ w2.t() + b2


def _check(x, w1, b1, w2, b2, seed, rate) -> torch.device:
    device = _build.check_cuda("fused_ffn", x, w1, b1, w2, b2, seed)
    _build.check_f32("fused_ffn", x, w1, b1, w2, b2)
    m, din = x.shape
    dff, dout = w1.shape[0], w2.shape[0]
    if (tuple(w1.shape) != (dff, din) or tuple(b1.shape) != (dff,)
            or tuple(w2.shape) != (dout, dff) or tuple(b2.shape) != (dout,)):
        raise ValueError(
            f"fused_ffn: inconsistent shapes x {tuple(x.shape)}, w1 "
            f"{tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, "
            f"b2 {tuple(b2.shape)}")
    if seed.dtype != torch.int32 or seed.numel() != 1:
        raise TypeError("fused_ffn: the seed is one int32 value")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_ffn: dropout rate {rate} not in [0, 1)")
    return device


class _FusedFFN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, seed, rate):
        device = _check(x, w1, b1, w2, b2, seed, rate)
        x, w1, b1 = x.contiguous(), w1.contiguous(), b1.contiguous()
        w2, b2, seed = w2.contiguous(), b2.contiguous(), seed.contiguous()
        m, din = x.shape
        dff, dout = w1.shape[0], w2.shape[0]
        hidden = torch.empty((m, dff), device=device)
        y = torch.empty((m, dout), device=device)
        _build.launch("ffn_fwd", "cpc2_ffn_fwd", device,
                      x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                      w2.data_ptr(), b2.data_ptr(), seed.data_ptr(),
                      hidden.data_ptr(), y.data_ptr(), m, din, dff, dout,
                      dropout_threshold(rate), 1.0 / (1.0 - rate))
        ctx.save_for_backward(x, w1, b1, w2, seed)
        ctx.rate = rate
        return y

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, seed = ctx.saved_tensors
        rate = ctx.rate
        device = x.device
        g = g.contiguous()
        m, din = x.shape
        dff, dout = w1.shape[0], w2.shape[0]
        hidden = torch.empty((m, dff), device=device)
        dx = torch.empty_like(x)
        dw1, db1 = torch.empty_like(w1), torch.empty_like(b1)
        dw2 = torch.empty_like(w2)
        db2 = torch.empty((dout,), device=device)
        _build.launch("ffn_bwd", "cpc2_ffn_bwd", device,
                      x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                      w2.data_ptr(), g.data_ptr(), seed.data_ptr(),
                      hidden.data_ptr(), dx.data_ptr(), dw1.data_ptr(),
                      db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
                      m, din, dff, dout, dropout_threshold(rate),
                      1.0 / (1.0 - rate))
        return dx, dw1, db1, dw2, db2, None, None


def fused_ffn(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
              seed: Tensor, rate: float = 0.0) -> Tensor:
    """lin2(dropout(relu(lin1(x)))) with torch-layout weights.

    x: (M, Din); w1: (Dff, Din); b1: (Dff,); w2: (Dout, Dff); b2: (Dout,);
    seed: one int32 value on x's device (unused when rate == 0). Returns
    (M, Dout). CUDA tensors go through the kernel, CPU tensors through
    `ffn_plain`."""
    if x.device.type == "cpu":
        return ffn_plain(x, w1, b1, w2, b2, seed, rate)
    return _FusedFFN.apply(x, w1, b1, w2, b2, seed, rate)
