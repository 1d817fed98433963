"""Position-wise FFN `lin2(dropout(relu(lin1(x))))` with hand-written
CUDA kernels.

Counterpart of `cpc2_tpu/ops/ffn_pallas.py:fused_ffn`: torch-layout weights
W1 (Dff, Din) and W2 (Dout, Dff), a dropout mask drawn inside the kernel
from a seed, and a backward (`csrc/ffn.cu`) that recomputes the hidden and
its mask from that seed instead of saving them. The work is bound by
operations (1.9 GFLOP per head forward at the recipe). Two routes:

- `bf16=True` (the default `--precision bf16mix`): the JAX package's
  single-pass bf16 products with fp32 accumulation. x, W1 and W2 (and the
  incoming gradient) are rounded to bf16, the hidden is stored as bf16, and
  the products are TMA-fed `wgmma` tiles with the bias, ReLU, dropout and
  their gradients fused into the epilogues (`csrc/hopper_gemm.cuh`). The
  bias gradients and the forward's bias add see unrounded fp32 values.
  Where x is bf16 (`--precision bf16`, the heads' bf16 activations), the
  bf16-in/bf16-out route of its own (`ffn_bf16io_plan`): x and the
  incoming gradient are read as they come, y and dx are summed in fp32
  and rounded to bf16 once, as the JAX package's kernel rounds its fp32
  output block once to x's dtype; the hidden and dh share one launch, and
  the products whose K is long split it over the CTAs of a thread-block
  cluster, which add their partials in shared memory, in rank order.
- `bf16=False` (`--precision fp32`): the same products at fp32 accuracy,
  in 3xTF32 on the tensor cores: each operand split into two TF32 planes,
  big and small, and each product taken as small*big + big*small +
  big*big, from TMA-fed `wgmma` tiles with the same fused epilogues. The
  planes are K-major, the one layout the TF32 `wgmma` reads, so a first
  launch splits (and, where a product reads it the other way, transposes)
  the operands, and the epilogues write the hidden's and its gradient's
  planes as the next products read them. `ffn_fp32_plan` holds the launch
  plan: tiles, splits over K, the planes' padded rows and the workspace.

The mask is a counter-based hash of (seed, row, column), defined the same
way in CUDA (`csrc/common.cuh:dropout_bits`) and in `dropout_bits` below,
so the kernels and `ffn_plain` draw bit-identical masks. The TPU kernel
draws its mask from the TPU's own generator, so against the JAX package
only the distribution matches.

`fused_ffn` launches a kernel for CUDA tensors and runs `ffn_plain` for
CPU tensors; there is no other path. It picks the bf16-in/bf16-out
kernels by x's dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .encoder import _RoundGrad, _RoundValue

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
              seed: Tensor, rate: float = 0.0, bf16: bool = False) -> Tensor:
    """The FFN in plain PyTorch, with the kernel's mask (autograd gives its
    backward). x: (M, Din); seed: one int32 value.

    With `bf16`, the bf16 kernels' rounding points: x, W1 and W2 rounded
    (their gradients pass unrounded), the hidden rounded before the second
    product, and the gradient of each product rounded before it reaches
    the product's operands, but not the bias gradients. A matmul of
    bf16-valued fp32 operands is exact in its products, so only the sums'
    order differs from the kernels'. A bf16 x (which takes `bf16`) gives a
    bf16 y, rounded once from the fp32 sum with b2; dx, the gradient of
    the cast, is then rounded once after its fp32 sum."""
    if x.dtype == torch.bfloat16:
        if not bf16:
            raise TypeError("ffn_plain: a bf16 x takes the bf16 route")
        return ffn_plain(x.float(), w1, b1, w2, b2, seed, rate,
                         True).to(torch.bfloat16)
    if bf16:
        x, w1, w2 = (_RoundValue.apply(t) for t in (x, w1, w2))
        pre = _RoundGrad.apply(x @ w1.t()) + b1
    else:
        pre = x @ w1.t() + b1
    h = torch.relu(pre)
    if rate > 0.0:
        keep = keep_mask(seed, x.shape[0], w1.shape[0], rate)
        h = torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))
    if bf16:
        return _RoundGrad.apply(_RoundValue.apply(h) @ w2.t()) + b2
    return h @ w2.t() + b2


# The fp32 kernels' tile (`csrc/hopper_gemm.cuh:ffn_tf32x3_gemm`: 128 x 128
# outputs, k tiles of 32 floats), the split pass's tiles of 32 rows (db2's
# partial sums), the row padding of the planes (TMA's 16-byte strides) and
# the alignment of the workspace's regions, in bytes; a block's consumer
# threads.
TILE, K_TILE, SPLIT_ROWS, PAD, ALIGN = 128, 32, 32, 4, 256
CONSUMERS = 256
# streaming multiprocessors of an H100 SXM, the plan's default
H100_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


class Product(NamedTuple):
    """One product of the fp32 kernels: its grid of output tiles, its k
    tiles, and their runs of `per` k tiles, one a split (`splits`)."""
    m_tiles: int
    n_tiles: int
    k_tiles: int
    per: int
    splits: int


class FFNPlan(NamedTuple):
    """The fp32 kernels' launch plan. ld_*: the padded row stride, in
    floats, of the planes whose rows are that wide. The products: the
    hidden (x W1^T) and dh (g W2), never split over K; y (hidden W2^T),
    dW2 (g^T hidden), dW1 (dh^T x) and dx (dh W1), split to fill the card.
    fwd_bytes and bwd_bytes: the workspace of a forward and a backward."""
    ld_m: int
    ld_din: int
    ld_dff: int
    ld_dout: int
    hidden: Product
    y: Product
    dw2: Product
    dh: Product
    dw1: Product
    dx: Product
    fwd_bytes: int
    bwd_bytes: int


def _product(m: int, n: int, k: int, sms: int, split: bool) -> Product:
    """Enough splits of K to give every multiprocessor a block, each at
    least one k tile; at least one split, also for K = 0."""
    tiles = _cdiv(m, TILE) * _cdiv(n, TILE)
    k_tiles = _cdiv(k, K_TILE)
    parts = min(max(sms // max(tiles, 1), 1), k_tiles) if split else 1
    per = max(_cdiv(k_tiles, max(parts, 1)), 1)
    return Product(_cdiv(m, TILE), _cdiv(n, TILE), k_tiles, per,
                   max(_cdiv(k_tiles, per), 1))


@functools.lru_cache(maxsize=None)
def ffn_fp32_plan(m: int, din: int, dff: int, dout: int,
                  sms: int = H100_SMS) -> FFNPlan:
    """The fp32 kernels' plan for x (m, din), W1 (dff, din), W2 (dout, dff)
    on a card of `sms` multiprocessors. The workspace mirrors the layout of
    `csrc/ffn.cu:ffn_fwd_fp32` and `ffn_bwd_fp32`, region by region, each
    rounded up to ALIGN bytes; the kernels refuse a byte count that differs
    from their own. The forward: the big and small planes of x, W1, W2
    and the hidden, then y's split partials. The backward: the planes of
    x, x^T, W1, W1^T, W2^T, g, g^T, the hidden^T (then dh^T) and dh, db2's
    partials per 32 rows, db1's per 128-row tile, the hidden's signs (64
    bits a consumer thread of each hidden tile), then dW2's, dW1's and
    dx's split partials. An empty m launches nothing."""
    if min(m, din, dff, dout) < 0:
        raise ValueError(f"ffn_fp32_plan: negative width in "
                         f"{(m, din, dff, dout)}")
    ld_m, ld_din, ld_dff, ld_dout = (_up(w, PAD) for w in (m, din, dff, dout))
    hidden = _product(m, dff, din, sms, False)
    y = _product(m, dout, dff, sms, True)
    dw2 = _product(dout, dff, m, sms, True)
    dh = _product(m, dff, dout, sms, False)
    dw1 = _product(dff, din, m, sms, True)
    dx = _product(m, din, dff, sms, True)

    def floats(n: int) -> int:
        return _up(4 * n, ALIGN)

    def planes(rows: int, ld: int) -> int:
        return floats(2 * rows * ld)

    def partials(p: Product, n: int) -> int:
        return floats(p.splits * n) if p.splits > 1 else 0

    fwd = (planes(m, ld_din) + planes(dff, ld_din) + planes(dout, ld_dff)
           + planes(m, ld_dff) + partials(y, m * dout))
    bwd = (planes(m, ld_din) + planes(din, ld_m) + planes(dff, ld_din)
           + planes(din, ld_dff) + planes(dff, ld_dout) + planes(m, ld_dout)
           + planes(dout, ld_m) + planes(dff, ld_m) + planes(m, ld_dff)
           + floats(_cdiv(m, SPLIT_ROWS) * dout)
           + floats(_cdiv(m, TILE) * dff)
           + floats(hidden.m_tiles * hidden.n_tiles * 2 * CONSUMERS)
           + partials(dw2, dout * dff)
           + partials(dw1, dff * din) + partials(dx, m * din))
    return FFNPlan(ld_m, ld_din, ld_dff, ld_dout, hidden, y, dw2, dh, dw1,
                   dx, fwd, bwd)


# The bf16 kernels' tile (`csrc/hopper_gemm.cuh`: 128 x 128 outputs, k tiles
# of 64 bf16), the bf16-io hidden block's dynamic shared memory (1,024 bytes
# of alignment, a ring of 4 stages of two 16 KB boxes, 8 warps' column
# sums, the stages' two mbarriers, the staged bf16 tile of 128 rows 272
# bytes apart; the split block has no tile), the bf16-io route's clusters
# (2, 4 and 8 CTAs: portable sizes) and g's rows a db2 partial sums.
IO_TILE, IO_K_TILE = 128, 64
IO_SMEM = 1024 + 4 * 2 * 16384 + 8 * 128 * 4 + 2 * 4 * 8 + 128 * 272
IO_CLUSTERS = (2, 4, 8)
IO_SUM_ROWS = 32
# Clusters of 2, 4 and 8 split CTAs (one a multiprocessor: their shared
# memory) that an H100 80GB HBM3 holds at once, as its
# `cudaOccupancyMaxActiveClusters` gave them (`chip_smoke.py`'s `[bf16
# kernels]` line): the plan's default; on a card the wrapper asks the card.
H100_CLUSTER_FITS = (66, 30, 15)


class IoProduct(NamedTuple):
    """One product of the bf16-io kernels: its grid of output tiles, its k
    tiles, and the CTAs of the cluster that splits them (1: not split)."""
    m_tiles: int
    n_tiles: int
    k_tiles: int
    cluster: int

    def k_runs(self):
        """Each rank's k tiles [k0, k1): r k / R to (r + 1) k / R
        (`hopper_gemm.cuh:io_k_begin`)."""
        k, c = self.k_tiles, self.cluster
        return [(r * k // c, (r + 1) * k // c) for r in range(c)]


class FFNIoPlan(NamedTuple):
    """The bf16-io kernels' plan (`csrc/ffn.cu:io_layout`). Launches: the
    forward casts W1 and W2 to bf16, takes the hidden by (m, f) tiles
    (`ffn_io_hidden`), then y split over clusters of `y.cluster` CTAs
    (`ffn_io_split`); the backward takes the hidden and dh by the same
    tiles in one launch, from the forward's bf16 weights (`weights` bf16
    values, W1 then W2, which the forward's caller keeps for it), then dW2
    and dW1 in one launch of clusters of `dw2.cluster` (= `dw1.cluster`)
    CTAs, then dx. Each split product's tile is summed over its cluster's
    ranks in shared memory: the workspace holds the hidden and dh and the
    bias gradients' partials (db1 per 128-row tile, db2 per 32 rows), never
    a partial of y, dx, dW1 or dW2."""
    m: int
    din: int
    dff: int
    dout: int
    fits: tuple     # clusters of 2, 4, 8 CTAs the card holds at once
    hidden: IoProduct
    dh: IoProduct
    y: IoProduct
    dw2: IoProduct
    dw1: IoProduct
    dx: IoProduct
    smem: int
    weights: int
    fwd_bytes: int
    bwd_bytes: int

    def as_c_longs(self):
        """The plan as the C entry points read it (`IoPlan` in
        csrc/ffn.cu): a ctypes array of longs, made once a plan."""
        return _c_longs(self)


@functools.lru_cache(maxsize=64)
def _c_longs(plan: FFNIoPlan):
    values = (plan.m, plan.din, plan.dff, plan.dout, *plan.fits,
              plan.y.cluster, plan.dw2.cluster,
              plan.dx.cluster, plan.smem, plan.fwd_bytes, plan.bwd_bytes)
    return (ctypes.c_long * len(values))(*values)


def _io_cluster(tiles: int, k_tiles: int, fits: tuple) -> int:
    """The largest cluster, of 2, 4 or 8 CTAs and at most k_tiles (every
    rank a run of k tiles), of which the card holds a launch's `tiles` at
    once, so that the launch runs in one wave; 1 where none."""
    c = 1
    for fit in fits:
        if 2 * c > k_tiles or tiles > fit:
            break
        c *= 2
    return c


@functools.lru_cache(maxsize=None)
def ffn_bf16io_plan(m: int, din: int, dff: int, dout: int,
                    fits: tuple = H100_CLUSTER_FITS) -> FFNIoPlan:
    """The bf16-io kernels' plan for a bf16 x (m, din), W1 (dff, din), W2
    (dout, dff) on a card that holds `fits` clusters of 2, 4 and 8 split
    CTAs at once: tiles, each split launch's cluster (the largest that
    keeps the launch in one wave), the ranks' runs of k tiles, shared
    memory and the workspace, region by region as `csrc/ffn.cu:io_space`
    lays it out; the C entry points refuse a plan that differs from
    theirs. m > 0; the widths multiples of 8 (TMA's 16-byte rows)."""
    if m <= 0 or min(din, dff, dout) <= 0 or din % 8 or dff % 8 or dout % 8:
        raise ValueError(f"ffn_bf16io_plan: no kernel for "
                         f"{(m, din, dff, dout)}")
    fits = tuple(fits)
    if len(fits) != len(IO_CLUSTERS) or min(fits) < 0:
        raise ValueError(f"ffn_bf16io_plan: cluster fits {fits}")
    mt, it, ft, ot = (_cdiv(w, IO_TILE) for w in (m, din, dff, dout))

    def kt(k):
        return _cdiv(k, IO_K_TILE)
    y = IoProduct(mt, ot, kt(dff), _io_cluster(mt * ot, kt(dff), fits))
    dw = _io_cluster(ot * ft + ft * it, kt(m), fits)
    dx = IoProduct(mt, it, kt(dff), _io_cluster(mt * it, kt(dff), fits))

    def bf16s(n):
        return _up(2 * n, ALIGN)

    def floats(n):
        return _up(4 * n, ALIGN)
    fwd = bf16s(m * dff)
    bwd = (fwd + bf16s(m * dff) + floats(mt * dff)
           + floats(IO_TILE // IO_SUM_ROWS * mt * dout))
    return FFNIoPlan(m, din, dff, dout, fits,
                     IoProduct(mt, ft, kt(din), 1),
                     IoProduct(mt, ft, kt(dout), 1), y,
                     IoProduct(ot, ft, kt(m), dw), IoProduct(ft, it, kt(m), dw),
                     dx, IO_SMEM, dff * din + dout * dff, fwd, bwd)


@functools.lru_cache(maxsize=None)
def cluster_fits(device: torch.device) -> tuple:
    """The clusters of 2, 4 and 8 bf16-io split CTAs that `device` holds at
    once (`cudaOccupancyMaxActiveClusters`), asked once a device."""
    lib = _build.library()
    with torch.cuda.device(device):
        fits = tuple(lib.cpc2_ffn_io_max_clusters(c) for c in IO_CLUSTERS)
    if min(fits) < 0:
        raise RuntimeError(f"cpc2_ffn_io_max_clusters failed: {fits}")
    return fits


def _check(x, w1, b1, w2, b2, seed, rate, bf16) -> torch.device:
    device = _build.check_cuda("fused_ffn", x, w1, b1, w2, b2, seed)
    _build.check_f32("fused_ffn", w1, b1, w2, b2)
    if x.dtype == torch.bfloat16 and not bf16:
        raise TypeError("fused_ffn: a bf16 x takes the bf16 route")
    if x.dtype != torch.bfloat16:
        _build.check_f32("fused_ffn", x)
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
    if bf16 and (din % 8 or dff % 8 or dout % 8):
        raise ValueError(f"fused_ffn: the bf16 kernels take widths that are "
                         f"multiples of 8, got {din}, {dff}, {dout}")
    return device


def _aligned(name: str, *tensors: Tensor) -> None:
    """The bf16 kernels read and write 16 bytes at a time."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: a tensor is not 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _workspace_bytes(m: int, din: int, dff: int, dout: int,
                     backward: bool) -> int:
    return _build.library().cpc2_ffn_bf16_workspace(m, din, dff, dout,
                                                    int(backward))


# Inside a CUDA graph (`training.MultiStep`) a launch keeps the arguments
# it was captured with, the TMA descriptors that the C entry points encode
# on the host from these pointers among them, so a replay reads and writes
# the same addresses. That is right because every operand is a parameter
# that the optimizer updates in place, or a tensor allocated during the
# capture from the graph's private pool, which each replay reuses at the
# same address (`chip_smoke.py`'s `[dispatch]` holds replays bit for bit
# against eager steps).
class _FusedFFN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, seed, rate, bf16):
        device = _check(x, w1, b1, w2, b2, seed, rate, bf16)
        x, w1, b1 = x.contiguous(), w1.contiguous(), b1.contiguous()
        w2, b2, seed = w2.contiguous(), b2.contiguous(), seed.contiguous()
        m, din = x.shape
        dff, dout = w1.shape[0], w2.shape[0]
        io = x.dtype == torch.bfloat16
        y = torch.empty((m, dout), device=device, dtype=x.dtype)
        ptrs = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), seed.data_ptr())
        drop = (dropout_threshold(rate), 1.0 / (1.0 - rate))
        if m == 0:
            pass  # nothing to compute, nothing launched
        elif io:
            _aligned("fused_ffn", x, w1, b1, w2, b2)
            plan = ffn_bf16io_plan(m, din, dff, dout,
                                   cluster_fits(device))
            scratch = torch.empty(plan.fwd_bytes, device=device,
                                  dtype=torch.uint8)
            wb = torch.empty(plan.weights, device=device, dtype=torch.bfloat16)
            c_plan = plan.as_c_longs()
            _build.launch("ffn_fwd_bf16io", "cpc2_ffn_fwd_bf16io", device,
                          *ptrs, scratch.data_ptr(), wb.data_ptr(),
                          y.data_ptr(), ctypes.addressof(c_plan), len(c_plan),
                          *drop)
        elif bf16:
            _aligned("fused_ffn", x, w1, b1, w2, b2)
            scratch = torch.empty(_workspace_bytes(m, din, dff, dout, False),
                                  device=device, dtype=torch.uint8)
            _build.launch("ffn_fwd", "cpc2_ffn_fwd_bf16", device, *ptrs,
                          scratch.data_ptr(), y.data_ptr(), m, din, dff,
                          dout, *drop)
        else:
            plan = ffn_fp32_plan(m, din, dff, dout, _build.sm_count(device))
            scratch = torch.empty(plan.fwd_bytes, device=device,
                                  dtype=torch.uint8)
            _build.launch("ffn_fwd_fp32", "cpc2_ffn_fwd", device, *ptrs,
                          scratch.data_ptr(), y.data_ptr(), plan.fwd_bytes,
                          m, din, dff, dout, plan.y.per, *drop)
        ctx.save_for_backward(x, w1, b1, w2, seed,
                              wb if io and m else None)
        ctx.rate, ctx.bf16 = rate, bf16
        return y

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, seed, wb = ctx.saved_tensors
        rate = ctx.rate
        device = x.device
        io = x.dtype == torch.bfloat16
        g = g.to(x.dtype).contiguous()
        m, din = x.shape
        dff, dout = w1.shape[0], w2.shape[0]
        if m == 0:  # nothing launched: the weights' gradients are 0
            return (torch.empty_like(x), torch.zeros_like(w1),
                    torch.zeros_like(b1), torch.zeros_like(w2),
                    torch.zeros((dout,), device=device), None, None, None)
        dx = torch.empty_like(x)
        dw1, db1 = torch.empty_like(w1), torch.empty_like(b1)
        dw2 = torch.empty_like(w2)
        db2 = torch.empty((dout,), device=device)
        ptrs = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                g.data_ptr(), seed.data_ptr())
        grads = (dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
                 dw2.data_ptr(), db2.data_ptr())
        drop = (dropout_threshold(rate), 1.0 / (1.0 - rate))
        if io:
            _aligned("fused_ffn", g, dx)
            plan = ffn_bf16io_plan(m, din, dff, dout,
                                   cluster_fits(device))
            scratch = torch.empty(plan.bwd_bytes, device=device,
                                  dtype=torch.uint8)
            c_plan = plan.as_c_longs()
            _build.launch("ffn_bwd_bf16io", "cpc2_ffn_bwd_bf16io", device,
                          x.data_ptr(), wb.data_ptr(), b1.data_ptr(),
                          g.data_ptr(), seed.data_ptr(), scratch.data_ptr(),
                          *grads, ctypes.addressof(c_plan), len(c_plan),
                          *drop)
        elif ctx.bf16:
            _aligned("fused_ffn", g)
            scratch = torch.empty(_workspace_bytes(m, din, dff, dout, True),
                                  device=device, dtype=torch.uint8)
            _build.launch("ffn_bwd", "cpc2_ffn_bwd_bf16", device, *ptrs,
                          scratch.data_ptr(), *grads, m, din, dff, dout,
                          *drop)
        else:
            plan = ffn_fp32_plan(m, din, dff, dout, _build.sm_count(device))
            scratch = torch.empty(plan.bwd_bytes, device=device,
                                  dtype=torch.uint8)
            _build.launch("ffn_bwd_fp32", "cpc2_ffn_bwd", device, *ptrs,
                          scratch.data_ptr(), *grads, plan.bwd_bytes, m, din,
                          dff, dout, plan.dw2.per, plan.dw1.per, plan.dx.per,
                          *drop)
        return dx, dw1, db1, dw2, db2, None, None, None


def fused_ffn(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
              seed: Tensor, rate: float = 0.0, bf16: bool = False) -> Tensor:
    """lin2(dropout(relu(lin1(x)))) with torch-layout weights.

    x: (M, Din); w1: (Dff, Din); b1: (Dff,); w2: (Dout, Dff); b2: (Dout,);
    seed: one int32 value on x's device (unused when rate == 0). Returns
    (M, Dout) in x's dtype. `bf16` takes the bf16 route (widths multiples of
    8), else the fp32 one (any widths); a bf16 x takes the bf16 route's
    bf16-in/bf16-out kernels. CUDA tensors go through the kernels, CPU
    tensors through `ffn_plain`."""
    if x.device.type == "cpu":
        return ffn_plain(x, w1, b1, w2, b2, seed, rate, bf16)
    return _FusedFFN.apply(x, w1, b1, w2, b2, seed, rate, bf16)
