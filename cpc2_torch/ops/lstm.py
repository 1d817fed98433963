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
keeps W_hh resident in VMEM; 1 MB does not fit one SM's shared memory, but
it fits across a thread-block cluster's. Two routes (`csrc/lstm.cu`),
chosen by `lstm_plan` from (B, H) alone:

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
- `steps` (counters `lstm_fwd_steps`, `lstm_bwd_steps`): one launch per time
  step, blocks reading their W_hh rows from L2, for widths whose slice does
  not fit a CTA's shared memory (H = 512, say).

`fused_lstm` launches a kernel for CUDA tensors and runs `lstm_plain` for
CPU tensors; there is no other path.
"""

from __future__ import annotations

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


class LSTMPlan(NamedTuple):
    route: str    # "resident" or "steps"
    cluster: int  # CTAs a cluster (0 on the steps route)
    bc: int       # batch rows a cluster (0 on the steps route)
    smem: int     # shared memory bytes of one CTA (one block on steps)


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


def lstm_plan(b: int, h: int) -> LSTMPlan:
    """The route, cluster size, batch tile and shared memory for a batch of
    b sequences of width h. The resident route takes every width whose
    W_hh slice and buffers fit one CTA's shared memory at a cluster size of
    CLUSTERS; its batch tile is the smallest of BATCH_TILES that needs at
    most MAX_CLUSTERS clusters, else the largest. Otherwise the steps
    route."""
    tile = next((t for t in BATCH_TILES if -(-b // t) <= MAX_CLUSTERS),
                BATCH_TILES[-1])
    for cluster in CLUSTERS:
        smem = resident_smem(h, cluster, tile)
        if 0 < smem <= SMEM_LIMIT:
            return LSTMPlan("resident", cluster, tile, smem)
    return LSTMPlan("steps", 0, 0, 4 * (b * h + 8 * b))


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


class _LSTMSteps(torch.autograd.Function):
    """The steps route: one launch per time step."""

    @staticmethod
    def forward(ctx, gi, h0, c0, w_hh, b_hh):
        return _forward(ctx, "lstm_fwd_steps", "cpc2_lstm_fwd_steps", (), gi,
                        h0, c0, w_hh, b_hh)

    @staticmethod
    def backward(ctx, dys, dh_last, dc_last):
        (ys, cs, ga, h0, c0, w_hh), cots, grads = _backward_args(
            ctx, dys, dh_last, dc_last)
        b, t, hdim = ys.shape
        # h_{t-1} of every step, the right operand of dW_hh = dgiᵀ hs_prev:
        # the carry-in, then ys without its last step
        hs_prev = torch.cat([h0[:, None], ys[:, :-1]], dim=1)
        # the per-step backward reads W_hh by columns: W_hhᵀ makes that a
        # row-contiguous read
        w_hh_t = w_hh.t().contiguous()
        _build.launch("lstm_bwd_steps", "cpc2_lstm_bwd_steps", ys.device,
                      *_ptrs(w_hh_t, *cots, cs, ga, c0, hs_prev, *grads),
                      b, t, hdim)
        return grads


def fused_lstm(gi: Tensor, h0: Tensor, c0: Tensor, w_hh: Tensor,
               b_hh: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """LSTM over precomputed input gates, (B, T, ·) layout throughout.

    gi: (B, T, 4H) = x @ W_ihᵀ + b_ih; h0, c0: (B, H); w_hh: (4H, H) torch
    layout; b_hh: (4H,); float32. Returns (ys (B, T, H), h_last, c_last).
    CUDA tensors go through the route `lstm_plan` picks, CPU tensors
    through `lstm_plain`."""
    if gi.device.type == "cpu":
        return lstm_plain(gi, h0, c0, w_hh, b_hh)
    plan = lstm_plan(gi.shape[0], gi.shape[-1] // 4)
    if plan.route == "resident":
        return _LSTMResident.apply(gi, h0, c0, w_hh, b_hh, plan.cluster,
                                   plan.bc)
    return _LSTMSteps.apply(gi, h0, c0, w_hh, b_hh)
