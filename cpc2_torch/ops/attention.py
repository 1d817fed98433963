"""Causal relative-position attention of the prediction heads with
hand-written CUDA kernels:

    out = dropout(softmax((q·kᵀ + rel) / √dk + causal)) · v,
    rel[r, c] = Σ_d q[r, d] · Krelpos[d, S-1-(r-c)]   (c <= r)

for every attention unit (a block of S steps of one head of one batch row).

Counterpart of `cpc2_tpu/ops/attention_pallas.py:fused_relpos_attention`.
The JAX package gathers the (dk, S, S) table `W2[d, r, c] = Krelpos[d,
S-1-(r-c)]` outside its kernel; here the kernels (`csrc/attention.cu`)
form the relative term as a product plus a skew: per 16-row tile of a
unit, QP = Q_t · Krelpos is a (16, S) product and rel[r, c] = QP[r,
S-1-r+c]. Every product runs on the tensor cores in 3xTF32 (fp32
accuracy). A unit's row tiles go in causal-balanced pairs (tile i with
tile T-1-i) to R CTAs; the forward keeps the softmax in registers. The
backward runs a unit on a thread-block cluster of R CTAs: each CTA
recomputes its rows' probabilities, gives dq by rows, and forms its rows'
partials of dk, dv and the unit's dKrelpos by columns; the cluster adds
the partials through distributed shared memory in rank order, and a
second launch sums the per-unit dKrelpos partials (N, S, dk) in unit
order. No atomics: the backward is bit for bit the same from call to
call.

Where a unit's rows do not fit a block whole (dk above 248, or above what
shared memory holds at S up to 58), the wide kernels take one CTA a unit
and dk in chunks: the products over dk add up chunk by chunk, and the
outputs come a chunk of columns at a time.

`attention_plan(N, S, dk, bf16)` holds every launch choice and
shared-memory layout; the kernels take it as given and refuse a plan that
does not hold what they put there. The wrapper pads dk with zeros to a
multiple of 4 for fp32 operands and of 8 for bf16 ones (16-byte rows for
the copies); the kernels pad it to 8 in shared memory.

Dropout keeps (unit, r, c) when the hash of `csrc/common.cuh:dropout_bits`
at row `unit·S + r`, column c is at or above the threshold, as the FFN
kernel does (`ops/ffn.py`), so the kernels and `attention_plain` draw
bit-identical masks. The TPU kernel draws its mask from the TPU's own
generator, so against the JAX package only the distribution matches.

bf16 q, k and v (the heads' bf16 activations under `--precision bf16`)
take the kernels' bf16-in/bf16-out variant: the operands come by TMA boxes
of a bf16 map, landing at the end of the fp32 rows they are widened into
in place, exact in the products (a product of two bf16 operands is one
TF32 product, not three), p~ rounded to bf16 only as p~ . v's operand, out,
dq, dk and dv stored as bf16, dKrelpos in fp32, and the backward's p~
recomputed unrounded (the rounding is straight-through), as the JAX
package's kernel takes them.

`fused_relpos_attention` launches the kernels for CUDA tensors and runs
`attention_plain` for CPU tensors; there is no other path.
`use_fused_attention` is the opt-in gate (`CPC2_FUSED_ATTENTION=1`), as in
the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .ffn import dropout_threshold, keep_mask

Tensor = torch.Tensor

# The gate's limits, those of the port's first attention kernel: S <= MAX_S
# and the shared memory `bwd_smem_bytes` of that kernel's backward (the
# unit's q, k, v, g and Krelpos at the odd stride dk | 1, plus two S x S
# planes) within MAX_SMEM_BYTES. They hold S <= 134 at dk = 32, S <= 169 at
# any dk and dk <= 11,621 at S = 1; `attention_plan` takes every shape
# within them (dk wider than a block holds whole in chunks of dk).
MAX_S = 256
MAX_SMEM_BYTES = 232448


def bwd_smem_bytes(s: int, dk: int) -> int:
    """The gate's shared-memory measure of a unit (see MAX_SMEM_BYTES)."""
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


# --- the kernels' plan -------------------------------------------------------

TILE = 16               # rows of a tile: the m16 of mma.m16n8k8
MAX_TILES = (4, 8, 12)  # the kernels' instantiations: row tiles of a unit
MAX_WARPS = 8           # a warp a row tile of a CTA, 256 threads at most
MAX_CLUSTER = 8         # CTAs of the backward's cluster (portable size)
MAX_BOX = 256           # a TMA box's extent in each dimension
HEADER_BYTES = 128      # the mbarrier, keeping each region 128-byte aligned
SMEM_LIMIT = 232448     # dynamic shared memory of one block
# The forward's CTAs a unit, where it has the pairs: at the recipe 2 ran
# faster than 1 or 4 on an H100 (PERF.md §6).
FWD_CTAS = 2


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


class AttentionPlan(NamedTuple):
    """Every launch choice and shared-memory layout of the two kernels.

    A unit's S rows make `tiles` row tiles of 16 (the last one ragged);
    pair slot i holds tiles i and tiles-1-i (one tile where they meet). CTA
    rank ρ of a unit's R CTAs owns pair slots ρ, ρ + R, ...; its local tile
    slots 2k and 2k + 1 hold the k-th slot's tiles, a warp each
    (`own_tile`). The kernels stage dk in `chunks` chunks of `dc` columns:
    one (dc = dkp) where a unit fits a block whole, else (the wide
    kernels: at most MAX_TILES[0] row tiles, one CTA a unit in both
    kernels) the products over dk add up chunk by chunk and the outputs
    come a chunk at a time. The kernels keep rows at `ld` floats (dc plus
    4: fragment loads free of bank conflicts), the transposed Krelpos (SP
    rows of `ldr` floats, columns XOR-swizzled) and the S-wide planes at
    `lds` (SP = 16 tiles, plus 4). Offsets and sizes are in floats from the
    end of the HEADER_BYTES header, shared memory in bytes. Forward: k, v,
    krel_t, the CTA's q rows, then a scratch region (each warp's QP tile)
    and `f_raw`, where Krelpos lands before the kernel transposes it (over
    the scratch in one chunk). Backward: k, v, krel_t, q and g rows, the
    CTA's planes of dropped probabilities, score gradients and skewed
    score gradients, and `b_raw` (over the planes in one chunk); the
    cluster's exchange of partials lies over k, v and krel_t once the rows
    are done. The backward's CTA finishes m-tiles [ρ T / R, (ρ + 1) T / R)
    of dk, dv and dKrelpos, at most `mtiles` of them. `io` 1: bf16
    operands in rows of dk_in = dk padded to 8 (TMA's 16-byte strides),
    whose boxes (dc values a row) land in a staging region at `f_st`,
    `b_st` (after Krelpos's raw copy: K, V, then every warp slot's q rows,
    then g's) where the block still fits with it, and are widened from
    there to the fp32 rows in one pass; where it would not fit (f_st, b_st
    0), at the end of the fp32 rows they fill, widened in place over a few
    passes. 0: fp32 operands, whose boxes land in the rows themselves."""
    n: int
    s: int
    dk: int
    dk_in: int       # the kernels' row width: dk padded to 4
    dkp: int         # dk padded to 8, the tensor cores' k
    dc: int          # columns of dk a chunk (a multiple of 8)
    chunks: int
    tiles: int
    pairs: int
    max_tiles: int   # the kernels' instantiation, MAX_TILES
    ld: int
    ldr: int
    lds: int
    fwd_ctas: int
    fwd_warps: int
    f_k: int
    f_v: int
    f_krel: int
    f_q: int
    f_x: int
    f_raw: int
    f_floats: int
    fwd_smem: int
    bwd_ctas: int    # the cluster's size
    bwd_warps: int
    mtiles: int
    b_k: int
    b_v: int
    b_krel: int
    b_q: int
    b_g: int
    b_pd: int
    b_ds: int
    b_dqp: int
    b_raw: int
    b_floats: int
    exchange: int
    bwd_smem: int
    io: int
    f_st: int
    b_st: int

    def as_c_ints(self):
        """The plan as the C entry points read it (`AttnPlan` in
        csrc/attention.cu): a ctypes array of ints, fields in order, made
        once a plan."""
        return _c_ints(self)


@functools.lru_cache(maxsize=64)
def _c_ints(plan: AttentionPlan):
    return (ctypes.c_int * len(plan))(*plan)


def own_tile(rank: int, ctas: int, tiles: int, slot: int) -> int:
    """The row tile of local tile slot `slot` of CTA `rank` of a unit's
    `ctas` CTAs, or -1 where the slot is empty."""
    pair = rank + (slot // 2) * ctas
    if pair >= (tiles + 1) // 2:
        return -1
    if slot % 2 == 0:
        return pair
    other = tiles - 1 - pair
    return -1 if other == pair else other


def _layout(n, s, dk, fwd_ctas, bwd_ctas, dc, io=0):
    tiles = -(-s // TILE)
    pairs = -(-tiles // 2)
    sp = TILE * tiles
    dk_in, dkp = _up(dk, 8 if io else 4), _up(dk, 8)
    wide = dc < dkp
    ld, ldr, lds = dc + 4, _up(dc, 32), sp + 4
    max_tiles = next((m for m in MAX_TILES if tiles <= m), None)

    def a(x):  # regions start on 128-byte boundaries
        return _up(x, 32)
    fwd_warps = 2 * -(-pairs // fwd_ctas)
    f_k = 0
    f_v = f_k + a(sp * ld)
    f_krel = f_v + a(sp * ld)
    f_q = f_krel + a(sp * ldr)
    f_x = f_q + a(TILE * fwd_warps * ld)
    qp = fwd_warps * TILE * lds
    f_raw = f_x + a(qp) if wide else f_x
    f_floats = f_raw + a(dc * s) if wide else f_x + a(max(qp, dk_in * s))
    f_st = 0
    if io:  # staged where the block still fits
        st = f_raw + a((dc if wide else dk_in) * s)
        end = st + a(dc * (2 * sp + TILE * fwd_warps) // 2)
        floats = end if wide else f_x + max(qp, end - f_x)
        if HEADER_BYTES + 4 * floats <= SMEM_LIMIT:
            f_st, f_floats = st, floats
    bwd_warps = 2 * -(-pairs // bwd_ctas)
    rows = TILE * bwd_warps
    mtiles = -(-tiles // bwd_ctas)
    b_k, b_v, b_krel = f_k, f_v, f_krel
    b_q = b_krel + a(sp * ldr)
    b_g = b_q + a(rows * ld)
    b_pd = b_g + a(rows * ld)
    b_ds = b_pd + a(rows * lds)
    b_dqp = b_ds + a(rows * lds)
    planes_end = b_dqp + a(rows * lds)
    b_raw = planes_end if wide else b_pd
    b_floats = (b_raw + a(dc * s) if wide
                else max(planes_end, b_pd + a(dk_in * s)))
    b_st = 0
    if io:
        st = b_raw + a((dc if wide else dk_in) * s)
        end = st + a(dc * (2 * sp + 2 * TILE * bwd_warps) // 2)
        floats = end if wide else max(planes_end, end)
        if HEADER_BYTES + 4 * floats <= SMEM_LIMIT:
            b_st, b_floats = st, floats
    exchange = (bwd_ctas - 1) * mtiles * 3 * (dkp // 8) * 128
    return AttentionPlan(
        n, s, dk, dk_in, dkp, dc, -(-dkp // dc), tiles, pairs, max_tiles,
        ld, ldr, lds, fwd_ctas, fwd_warps, f_k, f_v, f_krel, f_q, f_x, f_raw,
        f_floats, HEADER_BYTES + 4 * f_floats, bwd_ctas, bwd_warps, mtiles,
        b_k, b_v, b_krel, b_q, b_g, b_pd, b_ds, b_dqp, b_raw, b_floats,
        exchange, HEADER_BYTES + 4 * b_floats, io, f_st, b_st)


def _fits_fwd(p: AttentionPlan) -> bool:
    return p.fwd_warps <= MAX_WARPS and p.fwd_smem <= SMEM_LIMIT


def _fits_bwd(p: AttentionPlan) -> bool:
    return (p.bwd_warps <= MAX_WARPS and p.bwd_smem <= SMEM_LIMIT
            and p.exchange <= p.b_q - p.b_k)


def attention_plan(n: int, s: int, dk: int,
                   bf16: bool = False) -> AttentionPlan:
    """The kernels' plan for N units of S steps and width dk, of fp32 or
    (`bf16`) bf16 operands (rows padded to 8). Where a unit
    fits a block whole (one chunk of dk), the forward takes FWD_CTAS CTAs a
    unit (fewer where there are fewer pairs, more where a CTA's shared
    memory or warps would not hold its tiles) and the backward the smallest
    cluster of at least 2 CTAs (1 with one pair) that holds them; else the
    wide kernels take one CTA a unit and the widest chunk of dk that fits.
    Raises ValueError for a shape the kernels do not take: S above 16 *
    max(MAX_TILES), or a unit that fits neither way (dk at S above 64 that
    the gate's limits refuse too). Plans are cached: a head call costs no
    planning on the host."""
    return _plan(n, s, dk, int(bool(bf16)))


@functools.lru_cache(maxsize=256)
def _plan(n: int, s: int, dk: int, io: int) -> AttentionPlan:
    if n < 0 or s < 1 or dk < 1:
        raise ValueError(f"attention_plan: no kernel for N {n}, S {s}, "
                         f"dk {dk}")
    tiles = -(-s // TILE)
    pairs = -(-tiles // 2)
    dkp = _up(dk, 8)
    if tiles > MAX_TILES[-1]:
        raise ValueError(f"attention_plan: S {s} beyond the kernels' tiles")

    def pick(first, fits):
        for r in range(min(first, pairs), min(pairs, MAX_CLUSTER) + 1):
            if fits(_layout(n, s, dk, r, r, dkp, io)):
                return r
        return None
    if dkp + 4 <= MAX_BOX:
        rf, rb = pick(FWD_CTAS, _fits_fwd), pick(2, _fits_bwd)
        if rf is not None and rb is not None:
            return _layout(n, s, dk, rf, rb, dkp, io)
    if tiles <= MAX_TILES[0]:
        for dc in range(min(dkp - 8, MAX_BOX - 8), 0, -8):
            plan = _layout(n, s, dk, 1, 1, dc, io)
            if _fits_fwd(plan) and _fits_bwd(plan):
                return plan
    raise ValueError(f"attention_plan: no layout for S {s}, dk {dk} within "
                     f"{SMEM_LIMIT} bytes")


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
    S); seed: one int32 value. bf16 q, k, v: computed in fp32 from their
    values, p~ rounded to bf16 as p~ . v's operand only (`_RoundedPV`: the
    backward's dv and dp~ take p~ and its gradient unrounded), the output
    rounded to bf16 once (the gradients of q, k and v, those of the casts,
    then round once each)."""
    if q.dtype == torch.bfloat16:
        return _attention_f32(q.float(), k.float(), v.float(), krelpos, seed,
                              rate, True).to(torch.bfloat16)
    return _attention_f32(q, k, v, krelpos, seed, rate)


class _RoundedPV(torch.autograd.Function):
    """p~ . v with p~ rounded to bf16 in the product only: the backward
    recomputes with the unrounded p~ (dv = p~^T g, dp~ = g v^T), as the
    bf16 kernels and the TPU kernel do."""

    @staticmethod
    def forward(ctx, p, v):
        ctx.save_for_backward(p, v)
        return torch.matmul(p.to(torch.bfloat16).to(p.dtype), v)

    @staticmethod
    def backward(ctx, g):
        p, v = ctx.saved_tensors
        return torch.matmul(g, v.transpose(1, 2)), torch.matmul(
            p.transpose(1, 2), g)


def _attention_f32(q, k, v, krelpos, seed, rate, round_pv=False):
    n, s, dk = q.shape
    scale = 1.0 / dk ** 0.5
    logits = (torch.matmul(q, k.transpose(1, 2))
              + torch.einsum("nrd,drc->nrc", q, relpos_table(krelpos))) * scale
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=2)
    if rate > 0.0:
        keep = keep_mask(seed, n * s, s, rate).reshape(n, s, s)
        p = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
    return _RoundedPV.apply(p, v) if round_pv else torch.matmul(p, v)


def _check(q, k, v, krelpos, seed, rate) -> AttentionPlan:
    _build.check_cuda("fused_relpos_attention", q, k, v, krelpos, seed)
    _build.check_f32("fused_relpos_attention", krelpos)
    if q.dtype == torch.bfloat16:
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError("fused_relpos_attention: q, k and v take one "
                            "dtype")
    else:
        _build.check_f32("fused_relpos_attention", q, k, v)
    n, s, dk = q.shape
    if (tuple(k.shape) != (n, s, dk) or tuple(v.shape) != (n, s, dk)
            or tuple(krelpos.shape) != (dk, s)):
        raise ValueError(
            f"fused_relpos_attention: inconsistent shapes q {tuple(q.shape)},"
            f" k {tuple(k.shape)}, v {tuple(v.shape)}, krelpos "
            f"{tuple(krelpos.shape)}")
    if seed.dtype != torch.int32 or seed.numel() != 1:
        raise TypeError("fused_relpos_attention: the seed is one int32 value")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_relpos_attention: dropout rate {rate} not "
                         f"in [0, 1)")
    return attention_plan(n, s, dk, q.dtype == torch.bfloat16)


def _operand(x: Tensor, dk_in: int, dim: int = -1) -> Tensor:
    """x contiguous and 16-byte aligned, with dimension `dim` (of size dk)
    padded with zeros to dk_in."""
    pad = dk_in - x.shape[dim]
    if pad:
        x = F.pad(x, (0, pad) if dim == -1 else (0, 0, 0, pad))
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


# Under a CUDA graph capture the TMA descriptors encoded on the host are
# kept with the launch: right for the same reason as `ffn.py:_FusedFFN`'s.
class _FusedAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, krelpos, seed, rate):
        plan = _check(q, k, v, krelpos, seed, rate)
        n, s, dk = q.shape
        q, k, v = (_operand(x, plan.dk_in) for x in (q, k, v))
        krelpos = _operand(krelpos, plan.dk_in, dim=0)
        seed = seed.contiguous()
        out = torch.empty_like(q)
        io = "_bf16io" if q.dtype == torch.bfloat16 else ""
        if n:
            ints = plan.as_c_ints()
            _build.launch(f"attention_fwd{io}", f"cpc2_attention_fwd{io}",
                          q.device,
                          q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          krelpos.data_ptr(), seed.data_ptr(), out.data_ptr(),
                          ctypes.addressof(ints), len(ints),
                          dropout_threshold(rate), 1.0 / (1.0 - rate),
                          1.0 / dk ** 0.5)
        ctx.save_for_backward(q, k, v, krelpos, seed)
        ctx.rate, ctx.plan = rate, plan
        return out[..., :dk]

    @staticmethod
    def backward(ctx, g):
        q, k, v, krelpos, seed = ctx.saved_tensors
        rate, plan = ctx.rate, ctx.plan
        n, s, dk = plan.n, plan.s, plan.dk
        g = _operand(g.to(q.dtype), plan.dk_in)
        dq, dk_, dv = (torch.empty_like(q) for _ in range(3))
        partial = torch.empty_like(q, dtype=torch.float32)
        # an empty batch sums no partials: zeros without a launch
        dkrel = (torch.empty_like if n else torch.zeros_like)(krelpos)
        io = "_bf16io" if q.dtype == torch.bfloat16 else ""
        if n:
            ints = plan.as_c_ints()
            _build.launch(f"attention_bwd{io}", f"cpc2_attention_bwd{io}",
                          q.device,
                          q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          krelpos.data_ptr(), seed.data_ptr(), g.data_ptr(),
                          dq.data_ptr(), dk_.data_ptr(), dv.data_ptr(),
                          partial.data_ptr(), dkrel.data_ptr(),
                          ctypes.addressof(ints), len(ints),
                          dropout_threshold(rate), 1.0 / (1.0 - rate),
                          1.0 / dk ** 0.5)
        return (dq[..., :dk], dk_[..., :dk], dv[..., :dk], dkrel[:dk], None,
                None)


def fused_relpos_attention(q: Tensor, k: Tensor, v: Tensor, krelpos: Tensor,
                           seed: Tensor, rate: float = 0.0) -> Tensor:
    """Causal relative-position attention over N units.

    q, k, v: (N, S, dk), float32 or all three bf16; krelpos: (dk, S), the
    `Krelpos` parameter, float32; seed: one int32 value on q's device
    (unused when rate == 0). Returns (N, S, dk) in q's dtype. CUDA tensors
    go through the kernel, CPU tensors through `attention_plain`."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, krelpos, seed, rate)
    return _FusedAttention.apply(q, k, v, krelpos, seed, rate)
