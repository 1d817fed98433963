"""The CPC waveform encoder, 5 x (strided conv -> ChannelNorm -> ReLU), with
hand-written CUDA kernels.

Counterpart of `cpc2_tpu/ops/encoder_pallas.py:fused_encoder`, with its
numbers: the conv operands are bf16 (x and every weight rounded to bf16,
layers 1-4 stored as bf16), sums and the ChannelNorm statistics are fp32
(unbiased variance, eps 1e-5), and layer 5's output stays fp32. In the
backward, dy is fp32 for the bias gradient and rounded to bf16 for the
weight gradient and the lower layer's gradient.

The kernels (`csrc/encoder.cu`) run one launch per layer: an implicit-GEMM
conv whose blocks own whole rows of C channels, with bias, ChannelNorm,
affine and ReLU in its epilogue; the backward turns each layer's gradient
into dy with a norm kernel, forms dW over all rows in split partials summed
in a fixed order, and the lower layer's gradient with the same implicit
GEMM, once per phase of the stride. With gradients on, the forward keeps
the bf16 activations of layers 1-4 and the fp32 pre-norm outputs of all
five layers (48 MB and 98 MB at the recipe's 16 x 20,480 samples, C = 256)
so that the backward does not recompute the forward. The work is bound by
operations: about 25 GFLOP forward and 50 GFLOP backward at the recipe.

Weight packing, and unpacking the weight gradients, are plain PyTorch
around the kernels, as the JAX package packs outside its Pallas call.

`fused_encoder` launches the kernels for CUDA tensors and runs
`encoder_plain` for CPU tensors; there is no other path.
`use_fused_encoder` is the opt-in gate (`CPC2_FUSED_ENCODER=1`), as in the
JAX package.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.nn.functional as F

from . import _build

Tensor = torch.Tensor

# (kernel, stride, padding) of each layer: the only stack the kernels run
# (`csrc/encoder.cu`), the reference's.
CONV_STACK = ((10, 5, 3), (8, 4, 2), (4, 2, 1), (4, 2, 1), (4, 2, 1))
DOWNSAMPLING = 160
EPS = 1e-5
# The kernels' widths: a lane holds C / 32 channels of a row, up to 8.
CHANNELS = (32, 64, 128, 256)
# Rows of a norm-backward block and the dW partials' floor (csrc/encoder.cu).
_NORM_ROWS = 64
_DW_PARTIAL = 512 * 64 * 64


def use_fused_encoder(t: int, c: int, conv_stack=CONV_STACK,
                      norm_mode: str = "layerNorm",
                      dtype: torch.dtype = torch.float32) -> bool:
    """Run the encoder through `fused_encoder`? Only when asked for with
    CPC2_FUSED_ENCODER=1 (or `on`, `true`), as the JAX package's gate, and
    for what the kernels compute: ChannelNorm (`layerNorm`), the reference
    conv stack, T a positive multiple of 160, a float32 single-channel
    input, C one of `CHANNELS`. It declines under full-fp32 library math
    (`--precision fp32`, or inside `training.full_fp32()`), where the
    convolutions stay cuDNN in fp32: the kernels compute in bf16 like the
    default `bf16mix` path, as the JAX gate declines under 'highest'."""
    if os.environ.get("CPC2_FUSED_ENCODER", "").lower() not in (
            "1", "on", "true"):
        return False
    if norm_mode != "layerNorm" or tuple(conv_stack) != CONV_STACK:
        return False
    if t <= 0 or t % DOWNSAMPLING or dtype != torch.float32:
        return False
    return c in CHANNELS and torch.backends.cudnn.allow_tf32


def _round_bf16(x: Tensor) -> Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class _RoundValue(torch.autograd.Function):
    """bf16 rounding of a value whose gradient passes unrounded (the
    kernels' conv inputs: x, the weights, the stored activations)."""

    @staticmethod
    def forward(ctx, x):
        return _round_bf16(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """Identity whose gradient is rounded to bf16 (dy on its way into the
    conv's weight and input gradients)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round_bf16(g)


def encoder_plain(x: Tensor, conv_w: Sequence[Tensor],
                  conv_b: Sequence[Tensor], norm_w: Sequence[Tensor],
                  norm_b: Sequence[Tensor]) -> Tensor:
    """The encoder in plain PyTorch with the kernels' bf16 rounding points
    (autograd, with the two rounding functions above, gives its backward).
    x: (N, T); conv_w[l]: (C, Cin, K); conv_b, norm_w, norm_b[l]: C values
    each. Returns (N, T // 160, C). `F.conv1d` on bf16-valued operands is
    exact in its products even under TF32, whose mantissa holds bf16's."""
    h = _RoundValue.apply(x)[:, None, :]
    for layer, (_k, s, p) in enumerate(CONV_STACK):
        c = conv_w[layer].shape[0]
        y = F.conv1d(h, _RoundValue.apply(conv_w[layer]), stride=s, padding=p)
        y = _RoundGrad.apply(y) + conv_b[layer].reshape(1, c, 1)
        mean = y.mean(dim=1, keepdim=True)
        var = y.var(dim=1, keepdim=True, unbiased=True)
        h = torch.relu((y - mean) * torch.rsqrt(var + EPS)
                       * norm_w[layer].reshape(1, c, 1)
                       + norm_b[layer].reshape(1, c, 1))
        if layer < len(CONV_STACK) - 1:
            h = _RoundValue.apply(h)
    return h.transpose(1, 2)


def _lengths(t: int):
    out = []
    for _k, s, _p in CONV_STACK:
        t //= s
        out.append(t)
    return out


def _pack_fwd(conv_w) -> Tensor:
    """Every layer's weight as (K, Cin, C), flattened in layer order, bf16."""
    return torch.cat([w.permute(2, 1, 0).reshape(-1) for w in conv_w]).to(
        torch.bfloat16).contiguous()


def _pack_bwd(conv_w) -> Tensor:
    """For layers 2-5, per phase ph of the stride s, the (2C, Cin) matrix
    [W[:, :, ph + s]ᵀ; W[:, :, ph]ᵀ], flattened in order, bf16."""
    blocks = []
    for w, (_k, s, _p) in zip(conv_w[1:], CONV_STACK[1:]):
        for ph in range(s):
            blocks.append(torch.cat([w[:, :, ph + s], w[:, :, ph]]).reshape(-1))
    return torch.cat(blocks).to(torch.bfloat16).contiguous()


def _unpack_dw(dwpack: Tensor, conv_w):
    """The kernels' (K, Cin, C) weight gradients -> (C, Cin, K) each."""
    out, off = [], 0
    for w in conv_w:
        c, cin, k = w.shape
        out.append(dwpack[off:off + k * cin * c].reshape(k, cin, c)
                   .permute(2, 1, 0).contiguous())
        off += k * cin * c
    return out


def _stack(params, c) -> Tensor:
    return torch.stack([p.reshape(c) for p in params]).contiguous()


def _check(x, params) -> torch.device:
    device = _build.check_cuda("fused_encoder", x, *params)
    _build.check_f32("fused_encoder", x, *params)
    if x.dim() != 2:
        raise ValueError(f"fused_encoder: x must be (N, T), got "
                         f"{tuple(x.shape)}")
    t = x.shape[1]
    c = params[0].shape[0]
    if t <= 0 or t % DOWNSAMPLING or c not in CHANNELS:
        raise ValueError(f"fused_encoder: T {t} must be a positive multiple "
                         f"of {DOWNSAMPLING} and C {c} one of {CHANNELS}")
    cin = 1
    for layer, (k, _s, _p) in enumerate(CONV_STACK):
        if tuple(params[layer].shape) != (c, cin, k):
            raise ValueError(f"fused_encoder: conv {layer} weight "
                             f"{tuple(params[layer].shape)}, expected "
                             f"{(c, cin, k)}")
        cin = c
    for p in params[5:]:
        if p.numel() != c:
            raise ValueError(f"fused_encoder: a bias or norm parameter of "
                             f"{p.numel()} values, expected {c}")
    return device


class _FusedEncoder(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, *params):
        device = _check(x, params)
        x = x.contiguous()
        n, t = x.shape
        c = params[0].shape[0]
        lengths = _lengths(t)
        wpack = _pack_fwd(params[:5])
        bias, nw, nb = (_stack(params[i:i + 5], c) for i in (5, 10, 15))
        acts = torch.empty(n * c * sum(lengths[:4]), device=device,
                           dtype=torch.bfloat16)
        keep = any(ctx.needs_input_grad)
        pre = (torch.empty(n * c * sum(lengths), device=device) if keep
               else None)
        out = torch.empty((n, lengths[-1], c), device=device)
        _build.launch("encoder_fwd", "cpc2_encoder_fwd", device,
                      x.data_ptr(), wpack.data_ptr(), bias.data_ptr(),
                      nw.data_ptr(), nb.data_ptr(), acts.data_ptr(),
                      pre.data_ptr() if keep else None, out.data_ptr(),
                      n, t, c)
        if keep:
            ctx.save_for_backward(x, wpack, nw, nb, acts, pre,
                                  *params[:5])
            ctx.param_shapes = [p.shape for p in params[5:]]
        return out

    @staticmethod
    def backward(ctx, gz):
        x, wpack, nw, nb, acts, pre, *conv_w = ctx.saved_tensors
        gz = gz.contiguous()
        device = x.device
        n, t = x.shape
        c = conv_w[0].shape[0]
        m1 = n * (t // CONV_STACK[0][1])
        wtpack = _pack_bwd(conv_w)
        dwpack = torch.empty(wpack.numel(), device=device)
        dnorm = torch.empty((5, 3, c), device=device)
        dx = torch.empty_like(x)
        dh = torch.empty(m1 * c, device=device)
        dy = torch.empty(m1 * c, device=device, dtype=torch.bfloat16)
        part_len = max(_DW_PARTIAL, 8 * c * c,
                       -(-m1 // _NORM_ROWS) * 3 * c)
        part = torch.empty(part_len, device=device)
        _build.launch("encoder_bwd", "cpc2_encoder_bwd", device,
                      x.data_ptr(), gz.data_ptr(), wpack.data_ptr(),
                      wtpack.data_ptr(), nw.data_ptr(), nb.data_ptr(),
                      acts.data_ptr(), pre.data_ptr(), dwpack.data_ptr(),
                      dnorm.data_ptr(), dx.data_ptr(), dh.data_ptr(),
                      dy.data_ptr(), part.data_ptr(), part_len, n, t, c)
        grads = [d.reshape(shape) for d, shape in zip(
            [dnorm[i, k] for k in range(3) for i in range(5)],
            ctx.param_shapes)]
        return (dx, *_unpack_dw(dwpack, conv_w), *grads)


def fused_encoder(x: Tensor, conv_w: Sequence[Tensor],
                  conv_b: Sequence[Tensor], norm_w: Sequence[Tensor],
                  norm_b: Sequence[Tensor]) -> Tensor:
    """5 x (strided conv -> ChannelNorm -> ReLU) with torch-layout
    parameters.

    x: (N, T) float32 waveform, T a multiple of 160; conv_w: the five
    (C, Cin, K) weights; conv_b, norm_w, norm_b: five tensors of C values
    each (norm parameters may be stored (1, C, 1)). Returns (N, T // 160,
    C) float32. CUDA tensors go through the kernels, CPU tensors through
    `encoder_plain`."""
    if x.device.type == "cpu":
        return encoder_plain(x, conv_w, conv_b, norm_w, norm_b)
    return _FusedEncoder.apply(x, *conv_w, *conv_b, *norm_w, *norm_b)
