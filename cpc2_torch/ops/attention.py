"""Causal relative-position attention of the prediction heads with a
hand-written CUDA kernel:

    out = dropout(softmax((q·kᵀ + rel) / √dk + causal)) · v,
    rel[r, c] = Σ_d q[r, d] · Krelpos[d, S-1-(r-c)]   (c <= r)

for every attention unit (a block of S steps of one head of one batch row).

Counterpart of `cpc2_tpu/ops/attention_pallas.py:fused_relpos_attention`.
The JAX package gathers the (dk, S, S) table `W2[d, r, c] = Krelpos[d,
S-1-(r-c)]` outside its kernel; here the kernel indexes `Krelpos` itself,
so no table is built per call and the backward returns `dKrelpos`
directly. The kernel (`csrc/attention.cu`) runs one block per unit with the
unit's q, k, v (and g) in shared memory. The forward keeps one row of
probabilities per warp; the backward recomputes them and holds the
unit's dropped probabilities and score gradients (2 x S x S fp32) in
shared memory, then sums per unit `dKrelpos` partials (N, S, dk) in a
second pass, in a fixed order, so that the result does not depend on the
order in which blocks run. What bounds it is latency: the work is about
165 MFLOP forward and 440 MFLOP backward per head call at the recipe
(N = 64, S = 116, dk = 32), a few microseconds at the fp32 peak.

Dropout keeps (unit, r, c) when the hash of `csrc/common.cuh:dropout_bits`
at row `unit·S + r`, column c is at or above the threshold, as the FFN
kernel does (`ops/ffn.py`), so the kernel and `attention_plain` draw
bit-identical masks. The TPU kernel draws its mask from the TPU's own
generator, so against the JAX package only the distribution matches.

`fused_relpos_attention` launches the kernel for CUDA tensors and runs
`attention_plain` for CPU tensors; there is no other path.
`use_fused_attention` is the opt-in gate (`CPC2_FUSED_ATTENTION=1`), as in
the JAX package.
"""

from __future__ import annotations

import os

import torch

from . import _build
from .ffn import dropout_threshold, keep_mask

Tensor = torch.Tensor

# The kernel's limits: a lane holds up to MAX_S / 32 columns of a row in
# registers, and the backward's shared memory (the unit's q, k, v, g and
# Krelpos with rows padded to an odd stride, plus two S x S planes) must fit
# the 227 KB a block can have. At the recipe (S = 116, dk = 32) the backward
# takes 184 KB.
MAX_S = 256
MAX_SMEM_BYTES = 232448


def bwd_smem_bytes(s: int, dk: int) -> int:
    """Shared memory of the backward kernel for one unit (rows at the odd
    stride dk | 1)."""
    return 4 * (5 * s * (dk | 1) + 2 * s * s)


def use_fused_attention(s: int, dk: int) -> bool:
    """Run the relative-position attention through `fused_relpos_attention`?
    Only when asked for with CPC2_FUSED_ATTENTION=1 (or `on`, `true`), as
    the JAX package's gate, and within the kernel's limits (above)."""
    if os.environ.get("CPC2_FUSED_ATTENTION", "").lower() not in (
            "1", "on", "true"):
        return False
    return _within_limits(s, dk)


def _within_limits(s: int, dk: int) -> bool:
    return 0 < s <= MAX_S and dk > 0 and bwd_smem_bytes(s, dk) <= MAX_SMEM_BYTES


def relpos_table(krelpos: Tensor) -> Tensor:
    """W2[d, r, c] = Krelpos[d, S-1-(r-c)] for c <= r (and Krelpos[d, S-1]
    above the diagonal, where the mask sends every logit to -inf), the
    JAX package's gather (`cpc2_tpu/models/transformer.py:121-124`)."""
    s = krelpos.shape[1]
    pos = torch.arange(s, device=krelpos.device)
    offs = (pos[:, None] - pos[None, :]).clamp(0, s - 1)
    return krelpos.flip(1)[:, offs]


def attention_plain(q: Tensor, k: Tensor, v: Tensor, krelpos: Tensor,
                    seed: Tensor, rate: float = 0.0) -> Tensor:
    """The attention in plain PyTorch with the W2 table and the kernel's
    mask (autograd gives its backward). q, k, v: (N, S, dk); krelpos: (dk,
    S); seed: one int32 value."""
    n, s, dk = q.shape
    scale = 1.0 / dk ** 0.5
    logits = (torch.matmul(q, k.transpose(1, 2))
              + torch.einsum("nrd,drc->nrc", q, relpos_table(krelpos))) * scale
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=2)
    if rate > 0.0:
        keep = keep_mask(seed, n * s, s, rate).reshape(n, s, s)
        p = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
    return torch.matmul(p, v)


def _check(q, k, v, krelpos, seed, rate) -> torch.device:
    device = _build.check_cuda("fused_relpos_attention", q, k, v, krelpos,
                               seed)
    _build.check_f32("fused_relpos_attention", q, k, v, krelpos)
    n, s, dk = q.shape
    if (tuple(k.shape) != (n, s, dk) or tuple(v.shape) != (n, s, dk)
            or tuple(krelpos.shape) != (dk, s)):
        raise ValueError(
            f"fused_relpos_attention: inconsistent shapes q {tuple(q.shape)},"
            f" k {tuple(k.shape)}, v {tuple(v.shape)}, krelpos "
            f"{tuple(krelpos.shape)}")
    if not _within_limits(s, dk):
        raise ValueError(f"fused_relpos_attention: S {s}, dk {dk} beyond "
                         f"the kernel's limits")
    if seed.dtype != torch.int32 or seed.numel() != 1:
        raise TypeError("fused_relpos_attention: the seed is one int32 value")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_relpos_attention: dropout rate {rate} not "
                         f"in [0, 1)")
    return device


class _FusedAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, krelpos, seed, rate):
        device = _check(q, k, v, krelpos, seed, rate)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        krelpos, seed = krelpos.contiguous(), seed.contiguous()
        n, s, dk = q.shape
        out = torch.empty_like(q)
        _build.launch("attention_fwd", "cpc2_attention_fwd", device,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      krelpos.data_ptr(), seed.data_ptr(), out.data_ptr(),
                      n, s, dk, dropout_threshold(rate), 1.0 / (1.0 - rate))
        ctx.save_for_backward(q, k, v, krelpos, seed)
        ctx.rate = rate
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, krelpos, seed = ctx.saved_tensors
        rate = ctx.rate
        g = g.contiguous()
        n, s, dk = q.shape
        dq, dk_, dv = (torch.empty_like(q) for _ in range(3))
        partial = torch.empty((n, s, dk), device=q.device)
        dkrel = torch.empty_like(krelpos)
        _build.launch("attention_bwd", "cpc2_attention_bwd", q.device,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      krelpos.data_ptr(), seed.data_ptr(), g.data_ptr(),
                      dq.data_ptr(), dk_.data_ptr(), dv.data_ptr(),
                      partial.data_ptr(), dkrel.data_ptr(), n, s, dk,
                      dropout_threshold(rate), 1.0 / (1.0 - rate))
        return dq, dk_, dv, dkrel, None, None


def fused_relpos_attention(q: Tensor, k: Tensor, v: Tensor, krelpos: Tensor,
                           seed: Tensor, rate: float = 0.0) -> Tensor:
    """Causal relative-position attention over N units.

    q, k, v: (N, S, dk); krelpos: (dk, S), the `Krelpos` parameter; seed:
    one int32 value on q's device (unused when rate == 0); float32. Returns
    (N, S, dk). CUDA tensors go through the kernel, CPU tensors through
    `attention_plain`."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, krelpos, seed, rate)
    return _FusedAttention.apply(q, k, v, krelpos, seed, rate)
