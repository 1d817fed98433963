"""LSTM hidden-to-hidden recurrence with hand-written CUDA kernels.

Counterpart of `cpc2_tpu/ops/lstm_pallas.py:fused_lstm`. The input
projection `gi = x @ W_ihᵀ + b_ih` of every step is computed outside (one
large matmul, `models/ar.py`); the kernels run only the serial part, in
torch gate order (i, f, g, o), with a `(h0, c0)` carry in and
`(ys, h_last, c_last)` out. The forward saves the cell states and the
post-activation gates; the backward walks time in reverse with the cell
algebra of the TPU kernel's `_bwd_kernel` and gives `dgi, dh0, dc0, dW_hh,
db_hh`.

What bounds it is latency, not bytes or operations: each step is a tiny
(B, H) x (H, 4H) product that depends on the step before. The TPU kernel
keeps W_hh resident in VMEM and walks time inside one call; here the same
holds across a thread-block cluster or across the whole card. Two routes
(`csrc/lstm.cu`), chosen by `lstm_plan` from (B, H) and the card's SMs:

- `resident` (launch counters `lstm_fwd`, `lstm_bwd`): one launch per call.
  Clusters of C CTAs each own `bc` batch rows; each CTA keeps the W_hh rows
  of its H/C hidden units in shared memory for the whole sequence, and only
  h crosses CTAs: remote stores into distributed shared memory, counted by
  an mbarrier on each of two h buffers, one wait a step. The backward
  reduce-scatters the recurrent gradient's row-slice partials the same way
  and sums them in rank order, and sums db_hh in a fixed order, so it is
  bit-for-bit deterministic; the walk also writes `[h0, ys[:, :-1]]` for
  dW_hh, one product after it. A step is bound by its latency chain, about
  1.5 µs on an H100 whatever the batch tile, so the plan spreads a batch
  over up to MAX_CLUSTERS clusters of 16 CTAs (PERF.md, "Findings").
- `grid` (counters `lstm_fwd_grid`, `lstm_bwd_grid`): for widths whose
  slice does not fit a cluster (H = 512 and wider, H not a multiple of 4).
  One cooperative launch per call of `ctas` CTAs, one an SM at most, each
  owning `units` hidden units and keeping its W_hh slice in shared memory
  (read from L2 where it does not fit beside the staged operand); a step
  stages h_{t-1} (dgi_{t+1}) through L2, forms the CTA's products in a
  fixed order, runs the cell with c (dc) in registers and ends in one grid
  barrier. No atomics on values: bit for bit the same across calls. The
  walk writes `[h0, ys[:, :-1]]` for dW_hh, one product after it, and
  db_hh is a fixed-order column sum. `grid_layout` mirrors the kernels'
  layout, which they check.

`fused_lstm` launches a kernel for CUDA tensors and runs `lstm_plain` for
CPU tensors; there is no other path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

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


# The resident route's limits (`csrc/lstm.cu`): at most 256 threads a CTA,
# the dynamic shared memory of one block (of which two mbarriers take the
# first 16 bytes), and the cluster sizes and batch tiles it is built for, in
# the order the plan tries them.
MAX_THREADS = 256
SMEM_LIMIT = 232448
BARRIER_BYTES = 16
CLUSTERS = (16, 8)
BATCH_TILES = (1, 2, 4, 8)
MAX_CLUSTERS = 8


# The grid route's limits (`csrc/lstm.cu`, "grid route"): threads and warps
# a CTA, (unit, batch row) items whose c or dc a thread carries, and the
# batch rows of a product tile.
GRID_THREADS = 256
GRID_WARPS = GRID_THREADS // 32
CELL_ITEMS = 4
TILE_ROWS = 8


class GridLayout(NamedTuple):
    """One direction's layout on the grid route (`grid_layout`)."""
    walk: int    # batch rows walked through time at once
    chunk: int   # batch rows staged in shared memory at once
    splits: int  # slices of k a product tile is split into, one a warp
    w_smem: int  # 1: the W_hh slice stays in shared memory; 0: read from L2
    smem: int    # dynamic shared memory bytes of a CTA


class LSTMPlan(NamedTuple):
    route: str    # "resident" or "grid"
    cluster: int  # CTAs a cluster (0 on the grid route)
    bc: int       # batch rows a cluster (0 on the grid route)
    smem: int     # shared memory bytes of one CTA, the larger direction's
    ctas: int = 0   # grid route: CTAs of the launch
    units: int = 0  # grid route: hidden units a CTA
    fwd: GridLayout | None = None  # grid route: the forward's layout
    bwd: GridLayout | None = None  # grid route: the backward's layout


def _pow2_split(groups: int, fits) -> int:
    """The largest power of two s with groups * s <= MAX_THREADS and
    fits(s)."""
    s = 1
    while groups * s * 2 <= MAX_THREADS and fits(s * 2):
        s *= 2
    return s


def resident_smem(h: int, cluster: int, bc: int) -> int:
    """Shared memory of one CTA of the resident route at (H, C, BC), the
    larger of forward and backward, or 0 where the route does not take the
    shape. Mirrors `fwd_layout` and `bwd_layout` of `csrc/lstm.cu`."""
    if (h <= 0 or h % cluster or h % 4 or h // cluster > MAX_THREADS
            or h // 4 > MAX_THREADS or bc not in BATCH_TILES):
        return 0
    u = h // cluster
    r = 4 * u
    ks = _pow2_split(u, lambda s: h % (4 * s) == 0)
    rs = _pow2_split(h // 4, lambda s: r % (4 * s) == 0)
    if ks < bc or (h // 4) * rs < u * bc:
        return 0
    fwd = 4 * (h * r + 2 * bc * h + ks * bc * r)
    bwd = 4 * (r * h + rs * bc * h + bc * r + 2 * cluster * bc * u)
    return BARRIER_BYTES + max(fwd, bwd)


def grid_layout(b: int, h: int, units: int, backward: bool
                ) -> GridLayout | None:
    """One direction's layout of the grid route at (B, H) with `units`
    hidden units a CTA, or None where it takes no shape. Mirrors
    `grid_layout` of `csrc/lstm.cu`: the staged operand's rows are H
    rounded up to 4 floats (forward) or 4H (backward); shared memory holds
    the W_hh slice (forward 4 units rows, backward 4 ceil(units / 4) rows
    of W_hhᵀ) when it fits, the staged chunk and the splits' partial tiles
    of 32 sums; the chunk is the largest of the walk's rows that fits, with
    the slice in shared memory if any chunk fits beside it."""
    walk = min(b, GRID_THREADS * CELL_ITEMS // units)
    if b < 1 or walk < 1:
        return None
    k_row = 4 * h if backward else -(-h // 4) * 4
    groups = -(-units // 4) if backward else units
    w_floats = 4 * groups * k_row if backward else 4 * units * k_row
    for w_smem in (1, 0):
        for chunk in range(walk, 0, -1):
            tiles = groups * -(-chunk // TILE_ROWS)
            splits = max(1, GRID_WARPS // tiles)
            smem = 4 * (w_smem * w_floats + chunk * k_row
                        + 32 * splits * tiles)
            if smem <= SMEM_LIMIT:
                return GridLayout(walk, chunk, splits, w_smem, smem)
    return None


def grid_plan(b: int, h: int, sms: int) -> LSTMPlan:
    """The grid route at (B, H) on a card of `sms` SMs: one CTA an SM at
    most, `units` the smallest with ceil(H / units) <= sms. Raises where it
    does not take the shape (one staged row of dgi, 4H floats, and its
    partial sums above a CTA's shared memory: H above 14,304 on 132
    SMs)."""
    if h < 1:
        raise ValueError("fused_lstm: the hidden width is 0")
    units = -(-h // sms)
    fwd, bwd = (grid_layout(b, h, units, d) for d in (False, True))
    if fwd is None or bwd is None:
        raise ValueError(f"fused_lstm: the grid route does not take B = {b}, "
                         f"H = {h}")
    return LSTMPlan("grid", 0, 0, max(fwd.smem, bwd.smem), -(-h // units),
                    units, fwd, bwd)


@functools.lru_cache(maxsize=None)
def lstm_plan(b: int, h: int, sms: int) -> LSTMPlan:
    """The route and its layout for a batch of b sequences of width h on a
    card of `sms` SMs. The resident route takes every width whose W_hh
    slice and buffers fit one CTA's shared memory at a cluster size of
    CLUSTERS; its batch tile is the smallest of BATCH_TILES that needs at
    most MAX_CLUSTERS clusters, else the largest. Otherwise the grid route
    (`grid_plan`)."""
    tile = next((t for t in BATCH_TILES if -(-b // t) <= MAX_CLUSTERS),
                BATCH_TILES[-1])
    for cluster in CLUSTERS:
        smem = resident_smem(h, cluster, tile)
        if 0 < smem <= SMEM_LIMIT:
            return LSTMPlan("resident", cluster, tile, smem)
    return grid_plan(b, h, sms)


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


def _forward(ctx, kernel, fn, route_args, gi, h0, c0, w_hh, b_hh):
    """Launch one route's forward `fn` (counted under `kernel`) and save
    what the backward needs."""
    device = _check(gi, h0, c0, w_hh, b_hh)
    gi, h0, c0 = gi.contiguous(), h0.contiguous(), c0.contiguous()
    if h0.data_ptr() % 16:
        h0 = h0.clone()  # the grid route stages h0's rows as 16-byte vectors
    w_hh, b_hh = w_hh.contiguous(), b_hh.contiguous()
    b, t, g4 = gi.shape
    hdim = g4 // 4
    ys = torch.empty((b, t, hdim), device=device)
    cs = torch.empty_like(ys)
    ga = torch.empty_like(gi)
    h_last = torch.empty_like(h0)
    c_last = torch.empty_like(c0)
    _build.launch(kernel, fn, device,
                  gi.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                  w_hh.data_ptr(), b_hh.data_ptr(), ys.data_ptr(),
                  cs.data_ptr(), ga.data_ptr(), h_last.data_ptr(),
                  c_last.data_ptr(), b, t, hdim, *route_args)
    ctx.save_for_backward(ys, cs, ga, h0, c0, w_hh)
    return ys, h_last, c_last


def _backward_args(ctx, dys, dh_last, dc_last):
    """The saved tensors, the three cotangents (zeros where autograd passes
    none) and the five gradients' buffers. The caller holds them until the
    launch: a tensor freed before it could hand its memory to the next
    allocation while the kernel still reads it."""
    ys, cs, ga, h0, c0, w_hh = ctx.saved_tensors
    dys = torch.zeros_like(ys) if dys is None else dys.contiguous()
    dh_last = (torch.zeros_like(h0) if dh_last is None
               else dh_last.contiguous())
    dc_last = (torch.zeros_like(c0) if dc_last is None
               else dc_last.contiguous())
    grads = (torch.empty_like(ga), torch.empty_like(h0), torch.empty_like(c0),
             torch.empty_like(w_hh),
             torch.empty((w_hh.shape[0],), device=ys.device))
    return (ys, cs, ga, h0, c0, w_hh), (dys, dh_last, dc_last), grads


def _ptrs(*tensors):
    return [None if x is None else x.data_ptr() for x in tensors]


class _LSTMResident(torch.autograd.Function):
    """The resident route at cluster size `cluster` and batch tile `bc`
    (what `lstm_plan` picks, or any pair the route takes at this shape)."""

    @staticmethod
    def forward(ctx, gi, h0, c0, w_hh, b_hh, cluster, bc):
        hdim = gi.shape[-1] // 4
        if not 0 < resident_smem(hdim, cluster, bc) <= SMEM_LIMIT:
            raise ValueError(f"fused_lstm: the resident route does not take "
                             f"H = {hdim} at cluster {cluster}, tile {bc}")
        ctx.cluster, ctx.bc = cluster, bc
        return _forward(ctx, "lstm_fwd", "cpc2_lstm_fwd", (cluster, bc), gi,
                        h0, c0, w_hh, b_hh)

    @staticmethod
    def backward(ctx, dys, dh_last, dc_last):
        (ys, cs, ga, h0, c0, w_hh), cots, grads = _backward_args(
            ctx, dys, dh_last, dc_last)
        b, t, hdim = ys.shape
        # the walk writes h_{t-1} of every step here for the dW_hh product
        hs_prev = torch.empty_like(ys)
        n_clusters = -(-b // ctx.bc)
        # one row of db_hh partials per cluster, summed in cluster order
        db_part = (torch.empty((n_clusters, 4 * hdim), device=ys.device)
                   if n_clusters > 1 else None)
        _build.launch("lstm_bwd", "cpc2_lstm_bwd", ys.device,
                      *_ptrs(w_hh, *cots, cs, ga, c0, h0, ys, hs_prev,
                             *grads, db_part),
                      b, t, hdim, ctx.cluster, ctx.bc)
        return (*grads, None, None)


def _grid_args(plan: LSTMPlan, layout: GridLayout):
    """The seven ints the grid route's C entry points check against their
    own layout."""
    return (plan.ctas, plan.units, layout.walk, layout.chunk, layout.splits,
            layout.w_smem, layout.smem)


class _LSTMGrid(torch.autograd.Function):
    """The grid route at `plan` (what `lstm_plan` picks, or `grid_plan` at
    any width): one cooperative launch a call. A CUDA graph capture
    (`training.MultiStep`) takes `cudaLaunchCooperativeKernel` as a
    cooperative kernel node."""

    @staticmethod
    def forward(ctx, gi, h0, c0, w_hh, b_hh, plan):
        if plan.route != "grid" or plan.ctas * plan.units < gi.shape[-1] // 4:
            raise ValueError(f"fused_lstm: {plan} is not a grid plan for "
                             f"H = {gi.shape[-1] // 4}")
        ctx.plan = plan
        return _forward(ctx, "lstm_fwd_grid", "cpc2_lstm_fwd_grid",
                        _grid_args(plan, plan.fwd), gi, h0, c0, w_hh, b_hh)

    @staticmethod
    def backward(ctx, dys, dh_last, dc_last):
        (ys, cs, ga, h0, c0, w_hh), cots, grads = _backward_args(
            ctx, dys, dh_last, dc_last)
        b, t, hdim = ys.shape
        # the walk writes h_{t-1} of every step here for the dW_hh product
        hs_prev = torch.empty_like(ys)
        _build.launch("lstm_bwd_grid", "cpc2_lstm_bwd_grid", ys.device,
                      *_ptrs(w_hh, *cots, cs, ga, c0, h0, ys, hs_prev,
                             *grads),
                      b, t, hdim, *_grid_args(ctx.plan, ctx.plan.bwd))
        return (*grads, None)


def fused_lstm(gi: Tensor, h0: Tensor, c0: Tensor, w_hh: Tensor,
               b_hh: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """LSTM over precomputed input gates, (B, T, ·) layout throughout.

    gi: (B, T, 4H) = x @ W_ihᵀ + b_ih; h0, c0: (B, H); w_hh: (4H, H) torch
    layout; b_hh: (4H,); float32. Returns (ys (B, T, H), h_last, c_last).
    CUDA tensors go through the route `lstm_plan` picks, CPU tensors
    through `lstm_plain`."""
    if gi.device.type == "cpu":
        return lstm_plain(gi, h0, c0, w_hh, b_hh)
    device = _check(gi, h0, c0, w_hh, b_hh)
    plan = lstm_plan(gi.shape[0], gi.shape[-1] // 4, _build.sm_count(device))
    if plan.route == "resident":
        return _LSTMResident.apply(gi, h0, c0, w_hh, b_hh, plan.cluster,
                                   plan.bc)
    return _LSTMGrid.apply(gi, h0, c0, w_hh, b_hh, plan)
