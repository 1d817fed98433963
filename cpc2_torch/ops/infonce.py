"""InfoNCE negative scoring with hand-written CUDA kernels:
`neg[b, k, w, n] = preds[b, k, w, :] · z[idx[b, w, n], :]` (a raw dot; the
criterion divides by D).

Counterpart of `cpc2_tpu/ops/infonce_pallas.py:negative_scores_pallas`.
The TPU kernels keep the whole pool resident and select rows by one-hot
matmuls, so their cost grows with the pool. Here (`csrc/infonce.cu`) a unit
of work is one (b, w): a persistent grid stages each unit's N sampled pool
rows in shared memory with bulk async copies behind mbarriers, and the
products run on the tensor cores in 3xTF32 (fp32 accuracy). The backward
computes `dpreds` the same way and, in the same launch, `dz` by CTAs that
each own a tile of pool rows and a slice of columns and add the sampled
rows' contributions in a fixed order: no atomics, bit-for-bit the same
from call to call. A second launch sums the partials of the CTAs that
split a tile's units, in a fixed order.

`infonce_plan` chooses each launch and shared-memory layout (groups of
predictions, row blocks, column chunks, strides, stages, grids, dz tiles)
from the shapes alone; the kernels take it as given. Any K, N, D and pool
size: the wrapper pads D to a multiple of 4 and, for the backward, N too,
and launches nothing for an empty shape.

Grouped pools (`--neg_pool_group G`, counterpart of the JAX package's
kernel vmapped over groups, `cpc2_tpu/losses/criterion.py:468-491`): with
`group=G`, batch element b samples only the pool rows of its group b // G
(G contiguous elements' rows). The forward and dpreds gather any row
anyway; the dz plan then tiles each group's rows on their own and splits
only that group's units over a tile's CTAs, so a dz CTA walks G·W / splits
units instead of B·W / splits. Still one forward launch and the
backward's two for the whole batch.

Gathered pools (`--global_negatives`): the pool is every rank's
encodings, `ranks` x B x S rows, against this rank's B local elements. The
plan already takes p apart from b: the forward and dpreds gather from any
row, and the dz tiles cover all p rows, each summing the local units that
sampled it (rows no local unit sampled get 0, which the gather's backward
sums over the ranks). The launches count under `infonce_fwd_gathered` and
`infonce_bwd_gathered`.

`negative_scores` launches the kernels for CUDA tensors and runs
`negative_scores_plain` for CPU tensors; there is no other path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

Tensor = torch.Tensor


def negative_scores_plain(preds: Tensor, z: Tensor, idx: Tensor) -> Tensor:
    """Row gather plus a batched dot in plain PyTorch (autograd gives its
    backward). preds: (B, K, W, D); z: (P, D); idx: (B, W, N) -> (B, K, W, N).
    """
    b, _k, w, d = preds.shape
    n = idx.shape[2]
    neg_z = z[idx.reshape(-1).long()].reshape(b, w, n, d)
    return torch.einsum('bkwd,bwnd->bkwn', preds, neg_z)


# The kernels' limits (`csrc/infonce.cu`): the dynamic shared memory of one
# block, the barriers before the rings, at most PLAN_STAGES stages a ring,
# the row blocks of the gathered kernels tried from the largest, the widest
# column chunk of dpreds, the sampled rows of one chunk, the dz
# accumulator's budget and the consumer warps.
SMEM_LIMIT = 232448
BARRIER_BYTES = 128
PLAN_STAGES = 4
ROW_BLOCKS = (128, 64, 32, 16)
MAX_CHUNK = 256
CHUNK_N = 256
DZ_ACC_BYTES = 131072
CONSUMER_WARPS = 8
# a forward row block's (m16, n8) tile pairs per consumer warp, at most
PAIR_SLOTS = 2
# streaming multiprocessors of an H100 SXM, the plan's default grid
H100_SMS = 132


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


class InfoncePlan(NamedTuple):
    """Every launch choice and shared-memory layout of the kernels.
    Predictions go in groups of kp (16 or 32) rows. Forward stage: fwd_rb
    gathered rows, then kp prediction rows, each fwd_stride floats, fwd_dc
    columns of D a stage. dpreds stage: bwd_rb gathered rows of a
    bwd_dc-wide chunk at stride bwd_zs, then kp rows of g at bwd_gs. dz
    stage: nc indices, then min(K, kp) rows of g at stride nc and of the
    preds slice at dzc; after the ring, the (pt, dzc) accumulator and each
    consumer warp's list of nc rows. Stages in floats, shared memory in
    bytes. The backward runs at N rounded up to a multiple of 4, bwd_n.
    dz tiles cover each group's group_rows pool rows apart (pool row
    g·group_rows + t·pt + r for tile t of group g), and a tile's splits
    share its group's group_units units; with one group this is the whole
    pool's plan."""
    kp: int
    fwd_rb: int
    fwd_dc: int
    fwd_stride: int
    fwd_stage: int
    fwd_stages: int
    fwd_grid: int
    fwd_smem: int
    bwd_n: int
    bwd_rb: int
    bwd_dc: int
    bwd_zs: int
    bwd_gs: int
    bwd_stage: int
    bwd_stages: int
    bwd_grid: int     # dpreds CTAs
    nc: int
    dzc: int          # columns of a dz slice
    dz_stage: int
    dz_stages: int
    pt: int           # pool rows of a dz tile
    row_tiles: int    # over all groups: groups x group_tiles
    col_slices: int
    splits: int       # dz CTAs a tile, each over a run of its group's units
    bwd_smem: int
    group_rows: int   # pool rows of a group (P with one group)
    group_units: int  # (b, w) units of a group (B x W with one group)
    group_tiles: int  # row tiles of a group, none straddling two groups


def _ring(stage_floats: int, budget: int = SMEM_LIMIT) -> int:
    return min(PLAN_STAGES, max(0, budget - BARRIER_BYTES)
               // (4 * stage_floats))


def _row_block(n: int, stage_floats) -> tuple:
    """The largest row block of ROW_BLOCKS (none above round16(N) but the
    smallest) whose ring holds at least two stages, and its stages; (0, 0)
    if none. `stage_floats(rb)` is 0 for a block the kernel cannot take."""
    for rb in ROW_BLOCKS:
        if rb > _up(n, 16) and rb != ROW_BLOCKS[-1]:
            continue
        floats = stage_floats(rb)
        if floats and _ring(floats) >= 2:
            return rb, _ring(floats)
    return 0, 0


def _chunk(n: int, d: int, widest: int, stage_floats) -> tuple:
    """The widest column chunk, a multiple of 8 from min(widest, round8(D))
    down by halves, for which `_row_block` finds a block of
    `stage_floats(rb, dc)`; and that block and its stages."""
    dc = min(widest, _up(d, 8))
    while True:
        rb, stages = _row_block(n, lambda r: stage_floats(r, dc))
        if rb:
            return dc, rb, stages
        if dc <= 8:
            raise ValueError("infonce_plan: no row block fits shared memory")
        dc = _up(dc // 2, 8)


def pool_groups(b: int, p: int, group) -> int:
    """How many groups `group` (batch elements a group, or None) makes of
    a batch of b over a pool of p rows: 1 for None or group >= b, else b //
    group, which must divide both b and p (each element owns p / b rows)."""
    if not group or group >= b:
        return 1
    if group < 0 or b % group or p % b:
        raise ValueError(f"infonce: group {group} must divide the batch "
                         f"{b}, and the batch the pool of {p} rows")
    return b // group


def infonce_plan(b: int, k: int, w: int, n: int, d: int, p: int,
                 sms: int = H100_SMS, group=None) -> InfoncePlan:
    """The launches for preds (b, k, w, d), a pool of p rows and n samples
    a position, on a card with `sms` multiprocessors; with `group` G,
    element b's samples lie in the rows of its group b // G (`pool_groups`).
    Any K, N and P; D a multiple of 4 (the wrapper pads it). Raises
    ValueError on an empty dimension (the wrapper launches nothing then),
    on D not a multiple of 4 and on a group that does not divide."""
    if min(b, k, w, n, d, p, sms) <= 0:
        raise ValueError(f"infonce_plan: empty shape b={b} k={k} w={w} "
                         f"n={n} d={d} p={p}")
    if d % 4:
        raise ValueError(f"infonce_plan: the kernels take D a multiple of "
                         f"4, got {d}")
    groups = pool_groups(b, p, group)
    group_rows, group_units = p // groups, b * w // groups
    kp = 16 if k <= 16 else 32
    kr = min(k, kp)
    units = b * w
    grid = min(units, sms)

    # forward: whole rows of D where a stage holds them, the row block's
    # tile pairs within PAIR_SLOTS a consumer warp
    def fwd_stage(rb, dc):
        if rb // 16 * kp // 8 > PAIR_SLOTS * CONSUMER_WARPS:
            return 0
        return (rb + kp) * (_up(dc, 32) + 4)
    fwd_dc, fwd_rb, fwd_stages = _chunk(n, d, _up(d, 8), fwd_stage)

    n4 = _up(n, 4)

    def dp_stage(rb, dc):
        return rb * (_up(dc, 32) + 8) + kp * (_up(rb, 32) + 4)
    bwd_dc, bwd_rb, bwd_stages = _chunk(n4, d, MAX_CHUNK, dp_stage)

    # dz: the fewest column slices (each at most 256 threads x 64 / kp
    # columns) whose ring holds two stages beside the accumulator and lists,
    # the accumulator halved down to 8 rows before a slice is added
    nc = min(n4, CHUNK_N)
    slices = -(-d // (256 * 64 // kp))
    while True:
        dzc = _up(-(-d // slices), 4)
        dz_stage = nc * (1 + kr) + kr * dzc
        pt = max(1, min(_up(group_rows, 8), DZ_ACC_BYTES // (4 * dzc)))
        while True:
            fixed = pt * dzc + CONSUMER_WARPS * nc
            dz_stages = _ring(dz_stage, SMEM_LIMIT - 4 * fixed)
            if dz_stages >= 2 or pt <= 8:
                break
            pt //= 2
        if dz_stages >= 2:
            break
        slices += 1
    group_tiles = -(-group_rows // pt)
    row_tiles = groups * group_tiles
    col_slices = -(-d // dzc)
    splits = max(1, min(group_units, sms // (row_tiles * col_slices)))
    fwd_st = fwd_stage(fwd_rb, fwd_dc)
    dp_st = dp_stage(bwd_rb, bwd_dc)
    return InfoncePlan(
        kp, fwd_rb, fwd_dc, _up(fwd_dc, 32) + 4, fwd_st, fwd_stages, grid,
        BARRIER_BYTES + 4 * fwd_stages * fwd_st,
        n4, bwd_rb, bwd_dc, _up(bwd_dc, 32) + 8, _up(bwd_rb, 32) + 4, dp_st,
        bwd_stages, grid, nc, dzc, dz_stage, dz_stages, pt, row_tiles,
        col_slices, splits,
        BARRIER_BYTES + 4 * max(bwd_stages * dp_st,
                                dz_stages * dz_stage + pt * dzc
                                + CONSUMER_WARPS * nc),
        group_rows, group_units, group_tiles)


def dz_partial_floats(plan: InfoncePlan, d: int) -> int:
    """Floats of the dz partials' buffer: splits x row_tiles * pt x D."""
    return plan.splits * plan.row_tiles * plan.pt * d


def _check(preds, z, idx) -> torch.device:
    device = _build.check_cuda("negative_scores", preds, z, idx)
    _build.check_f32("negative_scores", preds, z)
    b, _k, w, d = preds.shape
    if z.dim() != 2 or z.shape[1] != d or idx.dim() != 3 \
            or tuple(idx.shape[:2]) != (b, w):
        raise ValueError(
            f"negative_scores: inconsistent shapes preds "
            f"{tuple(preds.shape)}, z {tuple(z.shape)}, idx "
            f"{tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"negative_scores: idx must be int32, got "
                        f"{idx.dtype}")
    return device


def _aligned(t: Tensor) -> Tensor:
    """t contiguous and 16-byte aligned, as the bulk copies read it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pad_last(t: Tensor, size: int) -> Tensor:
    """t with its last dimension padded with zeros to `size`, 16-byte
    aligned."""
    return _aligned(t if t.shape[-1] == size
                    else F.pad(t, (0, size - t.shape[-1])))


_SMS = {}


def _plan(b, k, w, n, d4, p, device, group) -> InfoncePlan:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return infonce_plan(b, k, w, n, d4, p, _SMS[device], group)


def _counters(plan: InfoncePlan, p: int, ranks: int) -> tuple:
    """The launch counters of a call: the grouped plan's and the gathered
    pool's own, so that a run shows which plan it took."""
    if plan.group_rows < p:
        return "infonce_fwd_grouped", "infonce_bwd_grouped"
    if ranks > 1:
        return "infonce_fwd_gathered", "infonce_bwd_gathered"
    return "infonce_fwd", "infonce_bwd"


def check_pool(b: int, p: int, group, ranks: int) -> None:
    """A gathered pool (`ranks` > 1) holds `ranks` equal shares of rows and
    takes no group; a group must divide as `pool_groups` says."""
    if ranks < 1:
        raise ValueError(f"infonce: ranks must be at least 1, got {ranks}")
    if ranks > 1:
        if group:
            raise ValueError("infonce: a gathered pool takes no group")
        if p % ranks:
            raise ValueError(f"infonce: a pool of {p} rows does not split "
                             f"into {ranks} ranks' shares")
    pool_groups(b, p, group)


class _NegativeScores(torch.autograd.Function):

    @staticmethod
    def forward(ctx, preds, z, idx, group, ranks):
        device = _check(preds, z, idx)
        b, k, w, d = preds.shape
        n, p = idx.shape[2], z.shape[0]
        check_pool(b, p, group, ranks)
        ctx.ranks = ranks
        ctx.shapes = preds.shape, z.shape
        out = torch.empty((b, k, w, n), device=device)
        if out.numel() == 0 or d == 0:  # nothing to launch
            ctx.plan = None
            return out.zero_()
        # D padded with zeros to a multiple of 4 adds nothing to any dot
        d4 = _up(d, 4)
        plan = _plan(b, k, w, n, d4, p, device, group)
        preds, z = _pad_last(preds, d4), _pad_last(z, d4)
        idx = _aligned(idx)
        _build.launch(_counters(plan, p, ranks)[0], "cpc2_infonce_fwd",
                      device,
                      preds.data_ptr(), z.data_ptr(), idx.data_ptr(),
                      out.data_ptr(), b, k, w, n, d4, plan.kp, plan.fwd_rb,
                      plan.fwd_dc, plan.fwd_stride, plan.fwd_stage,
                      plan.fwd_stages, plan.fwd_grid, plan.fwd_smem)
        ctx.save_for_backward(preds, z, idx)
        ctx.plan = plan
        return out

    @staticmethod
    def backward(ctx, g):
        preds_shape, z_shape = ctx.shapes
        plan = ctx.plan
        if plan is None:
            return (g.new_zeros(preds_shape), g.new_zeros(z_shape), None,
                    None, None)
        preds, z, idx = ctx.saved_tensors
        b, k, w, d4 = preds.shape
        p, d = z.shape[0], preds_shape[3]
        # the backward's N padded to a multiple of 4: rows of the pool's
        # row 0 with a zero cotangent, which add nothing
        n4 = plan.bwd_n
        g, idx = _pad_last(g, n4), _pad_last(idx, n4)
        dpreds = torch.empty_like(preds)
        dz = torch.empty_like(z)
        partial = torch.empty(dz_partial_floats(plan, d4),
                              device=preds.device)
        _build.launch(_counters(plan, p, ctx.ranks)[1], "cpc2_infonce_bwd",
                      preds.device,
                      g.data_ptr(), preds.data_ptr(), z.data_ptr(),
                      idx.data_ptr(), dpreds.data_ptr(), dz.data_ptr(),
                      partial.data_ptr(), b, k, w, n4, d4, p, plan.kp,
                      plan.bwd_rb, plan.bwd_dc, plan.bwd_zs, plan.bwd_gs,
                      plan.bwd_stage, plan.bwd_stages, plan.bwd_grid,
                      plan.nc, plan.dzc, plan.dz_stage, plan.dz_stages,
                      plan.pt, plan.row_tiles, plan.col_slices, plan.splits,
                      plan.group_rows, plan.group_units, plan.group_tiles,
                      plan.bwd_smem)
        if d4 != d:
            dpreds, dz = dpreds[..., :d], dz[:, :d]
        return dpreds, dz, None, None, None


def negative_scores(preds: Tensor, z: Tensor, idx: Tensor,
                    group=None, ranks: int = 1) -> Tensor:
    """neg[b, k, w, n] = preds[b, k, w, :] · z[idx[b, w, n], :].

    preds: (B, K, W, D) float32; z: (P, D) float32; idx: (B, W, N) int32
    rows of z, each in [0, P) (the kernels do not check the range). With
    `group` G (below B), idx[b] must lie in the pool rows of b's group,
    [b // G · G · P / B, + G · P / B): the kernels' dz tiles then walk only
    their group's units (a row outside adds nothing to dz). Returns (B, K,
    W, N) float32. `ranks` > 1: z is a pool gathered over that many ranks
    (`--global_negatives`), `ranks` equal shares of rows, and takes no
    group (`check_pool`). CUDA tensors go through the kernels, CPU tensors
    through `negative_scores_plain`, whose math is the same for any
    indices."""
    if preds.device.type == "cpu":
        check_pool(preds.shape[0], z.shape[0], group, ranks)
        return negative_scores_plain(preds, z, idx)
    return _NegativeScores.apply(preds, z, idx, group, ranks)
