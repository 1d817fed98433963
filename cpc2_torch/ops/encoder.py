"""The CPC waveform encoder, 5 x (strided conv -> ChannelNorm -> ReLU), with
hand-written CUDA kernels.

Counterpart of `cpc2_tpu/ops/encoder_pallas.py:fused_encoder`, with its
numbers: the conv operands are bf16 (x and every weight rounded to bf16,
layers 1-4 stored as bf16), sums and the ChannelNorm statistics are fp32
(unbiased variance, eps 1e-5), and layer 5's output stays fp32. In the
backward, dy is fp32 for the bias gradient and rounded to bf16 for the
weight gradient and the lower layer's gradient.

The kernels (`csrc/encoder.cu`): layers 2-5's products (the forward conv,
dW and the lower layer's gradient) are bf16 `wgmma` implicit GEMMs on the
TMA block of `csrc/hopper_gemm.cuh`, each k tile one box of a tap, cut
from a 4-D view of the layer's input (`encoder_plan` holds the boxes, the
tiles, the splits and the workspace); a warp-per-row kernel applies
ChannelNorm + affine + ReLU after each forward product, and one turns each
layer's gradient into dy in the backward. Layer 1 (one input channel, ten
taps) runs on SIMT kernels. With gradients on, the forward keeps the bf16
activations of layers 1-4 and the fp32 pre-norm outputs of all five
layers (48 MB and 98 MB at the recipe's 16 x 20,480 samples, C = 256) so
that the backward does not recompute the forward. The work is bound by
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
from dataclasses import dataclass
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
# The kernels' widths: a lane of the warp-per-row kernels holds C / 32
# channels of a row, up to 8.
CHANNELS = (32, 64, 128, 256)
# The products' tiles (csrc/hopper_gemm.cuh): 128 x 128 outputs, k tiles of
# one box of 64 channels; dW's k tiles are 64 rows of t.
TILE = 128
BOX = 64
WGRAD_ROWS = 64
# Layer 1's SIMT kernels (csrc/encoder.cu): rows of a norm-backward block,
# and the dW tile, k slice and blocks aimed for.
_NORM_ROWS = 64
_W_TILE, _W_SLICE, _W_BLOCKS = 64, 16, 512
# streaming multiprocessors of an H100 SXM, the plan's default
H100_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class Product:
    """One product's launch: grid (x, z): x counts (sample, row tile,
    column tile) with the column fastest, or for dW (row tile, column
    tile); z counts the phases of the lower layer's gradient, or dW's
    splits. `row_tiles` per sample: of 128 rows, or dW's k tiles of 64
    rows. `k_tiles` of a tile (dW: in all), `per_split` of a dW split."""
    grid: tuple
    row_tiles: int
    k_tiles: int
    per_split: int


@dataclass(frozen=True)
class LayerPlan:
    """Layer 2-5's products. `boxes[j]` = (phase, row offset) of tap j's box
    in the (C, s, T_out, N) view of the input: input row s t - pad + j is
    phase (j - pad) mod s of view row t + floor((j - pad) / s). `shifts[ph]`
    = 1 where phase ph of the lower layer's gradient starts at dy row a = 1
    (ph < pad), so that its T_out rows u = s (t + shift) + ph - pad all lie
    in [0, T_in). Element offsets: `in_off` of the input in the bf16
    activations (layer 1-4 outputs), `pre_off` of the pre-norm output,
    `w_off` of the weights in wpack, `wt_off` in wtpack."""
    t_in: int
    t_out: int
    taps: int
    stride: int
    pad: int
    boxes: tuple
    shifts: tuple
    fwd: Product
    wgrad: Product
    dgrad: Product
    in_off: int
    pre_off: int
    w_off: int
    wt_off: int


@dataclass(frozen=True)
class EncoderPlan:
    """`tile_k` k tiles a tap (a tap's channels are a multiple of 64, or
    one box zero-filled past C), `col_tiles` 128-wide column tiles; layer 1's
    dW in `w1_splits` splits of `w1_rows` rows; the backward's scratch
    `part_floats` (the kernels refuse another count) and the forward's
    `scratch_floats` for the pre-norm outputs when no gradient is kept."""
    lengths: tuple
    tile_k: int
    col_tiles: int
    layers: tuple
    w1_rows: int
    w1_splits: int
    part_floats: int
    scratch_floats: int


def encoder_plan(n: int, t: int, c: int, sms: int = H100_SMS) -> EncoderPlan:
    """The kernels' plan for x (n, t) at width c on a card of `sms`
    multiprocessors: what `csrc/encoder.cu:Plan`, `taps_geom` and
    `wgrad_geom` compute. Raises where T is not a positive multiple of 160,
    C not one of CHANNELS, or a tensor's offset not 16-byte aligned (TMA's
    base alignment)."""
    if t <= 0 or t % DOWNSAMPLING or c not in CHANNELS or n < 0:
        raise ValueError(f"encoder_plan: N {n}, T {t}, C {c}: T must be a "
                         f"positive multiple of {DOWNSAMPLING} and C one of "
                         f"{CHANNELS}")
    lengths = _lengths(t)
    tile_k = max(1, c // BOX)
    col_tiles = _cdiv(c, TILE)
    act_offs, acc = [], 0
    for length in lengths:
        act_offs.append(acc)
        acc += n * length * c
    w_off = CONV_STACK[0][0] * c
    wt_off = 0
    part = 0
    layers = []
    for layer in range(1, len(CONV_STACK)):
        k, s, p = CONV_STACK[layer]
        t_in, t_out = lengths[layer - 1], lengths[layer]
        row_tiles = _cdiv(t_out, TILE)
        fwd = Product((n * row_tiles * col_tiles, 1), row_tiles,
                      k * tile_k, k * tile_k)
        dgrad = Product((n * row_tiles * col_tiles, s), row_tiles,
                        2 * tile_k, 2 * tile_k)
        w_tiles = _cdiv(t_out, WGRAD_ROWS)
        k_tiles = n * w_tiles
        m_tiles = _cdiv(k * tile_k * BOX, TILE)
        if n:
            splits = min(max(1, sms // (m_tiles * col_tiles)), k_tiles)
            per = _cdiv(k_tiles, splits)
            splits = _cdiv(k_tiles, per)
            part = max(part, splits * k * c * c)
        else:
            per = splits = 0
        wgrad = Product((m_tiles * col_tiles, splits), w_tiles, k_tiles, per)
        boxes = tuple(((j - p) % s, (j - p) // s) for j in range(k))
        shifts = tuple(int(ph < p) for ph in range(s))
        layers.append(LayerPlan(t_in, t_out, k, s, p, boxes, shifts, fwd,
                                wgrad, dgrad, act_offs[layer - 1],
                                act_offs[layer], w_off, wt_off))
        w_off += k * c * c
        wt_off += s * 2 * c * c
    for lp in layers:
        for off, size in ((lp.in_off, 2), (lp.pre_off, 4), (lp.w_off, 2),
                          (lp.wt_off, 2)):
            if off * size % 16:
                raise ValueError(f"encoder_plan: an offset of {off} "
                                 f"elements is not 16-byte aligned")
    w1_rows = w1_splits = 0
    if n:
        m1 = n * lengths[0]
        tiles1 = _cdiv(c, _W_TILE) * _cdiv(CONV_STACK[0][0], _W_TILE)
        w1_splits = max(1, min(_W_BLOCKS // tiles1, _cdiv(m1, 256)))
        w1_rows = _cdiv(_cdiv(m1, w1_splits), _W_SLICE) * _W_SLICE
        w1_splits = _cdiv(m1, w1_rows)
        part = max(part, w1_splits * CONV_STACK[0][0] * c,
                   _cdiv(m1, _NORM_ROWS) * 3 * c)
    return EncoderPlan(tuple(lengths), tile_k, col_tiles, tuple(layers),
                       w1_rows, w1_splits, part, n * lengths[1] * c)


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


# Under a CUDA graph capture the TMA descriptors encoded on the host are
# kept with the launch: right for the same reason as `ffn.py:_FusedFFN`'s.
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
        scratch = (None if keep else torch.empty(
            encoder_plan(n, t, c, _build.sm_count(device)).scratch_floats,
            device=device))
        out = torch.empty((n, lengths[-1], c), device=device)
        _build.launch("encoder_fwd", "cpc2_encoder_fwd", device,
                      x.data_ptr(), wpack.data_ptr(), bias.data_ptr(),
                      nw.data_ptr(), nb.data_ptr(), acts.data_ptr(),
                      pre.data_ptr() if keep else None,
                      None if keep else scratch.data_ptr(), out.data_ptr(),
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
        part_len = encoder_plan(n, t, c, _build.sm_count(device)).part_floats
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
