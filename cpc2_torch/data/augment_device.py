"""Augmentation on the card (the counterpart of
`cpc2_tpu/data/augment_device.py`): the host pipeline of `augmentation.py`
as batched PyTorch functions on (B, W) float32 tensors, run on the batch's
own device by `--augment_on_device`.

Why: the host versions run per-window numpy (the WSOLA stretch is a Python
loop a window), which the prefetch thread can hide only while it is
shorter than a step. Here every window of a batch draws its own
parameters, as the host pipeline's per-window randomness does, from a
`torch.Generator` on the tensor's device.

Each augmentation is split into a draw, of its random parameters (bands,
cents, rooms, spans, SNRs, pool rows) from the generator, and an apply on
given parameters, so that the same draws can be applied on the card and on
the CPU, and the apply held to the JAX package's inner functions at the
same parameters. `make_device_augment` composes them into a `DeviceChain`.

Numerics (as the JAX package's): `bandreject` builds the host's
Kaiser-windowed sinc band-stop with a fixed 1,021 taps (the host sizes them
from the band); `pitch` runs the host's phase vocoder vectorised (its frame
loop becomes gathers and one cumulative sum, taken in float64 so that the
card and the CPU accumulate the same phases), `pitch_quick` the host's
quick linear resample, and `pitch_wsola` the host's WSOLA stretch with the
same segment positions (lags scored in float64 from float32 products,
exact, so no TF32 setting reaches them); Gaussian noise and time dropout
are exact ports; freeverb is linear and time-invariant for one room size,
so artificial reverb is a gather from a bank of impulse responses and an
FFT convolution; natural reverb convolves with a bank of measured impulse
responses loaded once, additive noise mixes rows of a pool of noise windows
kept on the device. Only gathers, FFTs and elementwise ops: no
scatter-add, so a step is bit for bit the same when it is run again.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# The freeverb tunings are the host chain's, so the two cannot drift apart.
from .augmentation import (_ALLPASS_TUNINGS, _COMB_TUNINGS,
                           canonical_augment_type)

SAMPLE_RATE = 16000.0

Tensor = torch.Tensor
Params = Tuple[Tensor, ...]


def _uniform(shape, gen: torch.Generator, dtype=torch.float32) -> Tensor:
    return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)


def _randint(low: int, high: int, shape, gen: torch.Generator) -> Tensor:
    return torch.randint(low, high, shape, generator=gen, device=gen.device)


def _factor64(cents: Tensor) -> Tensor:
    """2^(cents/1200) in float64: the lengths derived from it are the
    host's, which computes them in float64, on every device."""
    return torch.pow(2.0, cents.double() / 1200.0)


def _keep_finite(x: Tensor, y: Tensor, cents: Tensor) -> Tensor:
    """The host's fallbacks: |cents| < 1 and a window with a non-finite
    result return the input."""
    y = torch.where((cents.abs() < 1)[:, None], x, y)
    return torch.where(torch.isfinite(y).all(dim=-1, keepdim=True), y, x)


# ---------------------------------------------------------------------------
# Band-reject (host: `augmentation.py:BandrejectAugment`)
# ---------------------------------------------------------------------------

_BR_TAPS = 1021          # a fixed odd tap count (the host sizes 255..4001)


def _mel2freq(m: Tensor) -> Tensor:
    return (10.0 ** (m / 2595.0) - 1) * 700.0


# The constant tensors below are made once per device and kept (the first
# step makes them), so that a step captured into a CUDA graph
# (`training.MultiStep`) copies nothing from the host.

@functools.lru_cache(maxsize=8)
def _kaiser_window(n: int, beta: float, device) -> Tensor:
    k = torch.arange(n, dtype=torch.float32, device=device)
    r = 2.0 * k / (n - 1) - 1.0
    return (torch.special.i0(beta * torch.sqrt(torch.clamp(1 - r * r,
                                                           min=0.0)))
            / torch.special.i0(torch.tensor(beta, dtype=torch.float32,
                                            device=device)))


def _bandstop_taps(lo: Tensor, hi: Tensor, numtaps: int = _BR_TAPS
                   ) -> Tensor:
    """Kaiser(beta=12)-windowed sinc band-stops, one a (lo, hi) Hz pair
    ((B,) each -> (B, numtaps)): the construction of
    scipy.signal.firwin(pass_zero='bandstop'), unity gain at DC included."""
    m = (torch.arange(numtaps, dtype=torch.float32, device=lo.device)
         - (numtaps - 1) / 2.0)
    f1 = (lo / (SAMPLE_RATE / 2))[:, None]
    f2 = (hi / (SAMPLE_RATE / 2))[:, None]

    def lowpass(fc):
        return fc * torch.sinc(fc * m)

    delta = (m == 0).to(torch.float32)
    band = lowpass(f2) - lowpass(f1)            # band-pass prototype
    h = (delta - band) * _kaiser_window(numtaps, 12.0, lo.device)
    return h / h.sum(dim=-1, keepdim=True)


def bandreject_draw(b: int, w: int, gen: torch.Generator,
                    scaler: float = 1.0) -> Params:
    """A random mel-spaced band a window (host `:78-86`): (lo, hi) in Hz."""
    melfmax = 2595.0 * math.log10(1 + SAMPLE_RATE / 2 / 700.0)
    meldf = _uniform((b,), gen) * melfmax * (27.0 * scaler) / 256.0
    melf0 = _uniform((b,), gen) * (melfmax - meldf)
    lo = torch.clamp(_mel2freq(melf0), 1.0, SAMPLE_RATE / 2 - 1.0)
    hi = torch.clamp(_mel2freq(melf0 + meldf), 1.0, SAMPLE_RATE / 2 - 1.0)
    return lo, hi


def bandreject_apply(x: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """Each window through its band-stop, 'same' mode by FFT; a band
    narrower than 2 Hz leaves its window as it is (the host's no-op)."""
    w = x.shape[1]
    taps = _bandstop_taps(lo, hi)
    nfft = 1 << (w + _BR_TAPS - 2).bit_length()
    half = (_BR_TAPS - 1) // 2
    y = torch.fft.irfft(torch.fft.rfft(x, nfft) * torch.fft.rfft(taps, nfft),
                        nfft)[:, half:half + w]
    return torch.where(((hi - lo) < 2.0)[:, None], x, y)


def bandreject(x: Tensor, gen: torch.Generator, scaler: float = 1.0
               ) -> Tensor:
    return bandreject_apply(x, *bandreject_draw(*x.shape, gen, scaler))


# ---------------------------------------------------------------------------
# Pitch shift (host: `augmentation.py:pitch_shift`)
# ---------------------------------------------------------------------------

_N_FFT, _HOP = 1024, 256


def pitch_draw(b: int, w: int, gen: torch.Generator,
               shift_max: int = 300) -> Params:
    """Cents ~ U{-shift_max, shift_max - 1} a window (host `PitchAugment`),
    as float32."""
    shift_max = int(shift_max)
    return (_randint(-shift_max, shift_max, (b,), gen).to(torch.float32),)


def _resample_live_prefix(src: Tensor, true_len: Tensor, w: int) -> Tensor:
    """Linear-resample each row's live prefix `src[:true_len]` ((B, L),
    (B,)) down to `w` samples: the host's `np.interp` on endpoint=False
    grids, sample j taken at position j * true_len / w. The position's
    integer part is exact integer arithmetic and its fraction is rounded
    once from float64, so every device takes the same positions (a
    float32 quotient is rounded differently where a division by a scalar
    becomes a product with its reciprocal, as on the card). Values past
    the prefix never reach the output: the pair partner's weight is 0 at
    the prefix's edge."""
    num = (torch.arange(w, device=src.device)[None, :]
           * true_len[:, None])
    i0 = torch.div(num, w, rounding_mode='floor')
    fr = ((num - i0 * w).double() / w).to(torch.float32)
    i0 = torch.clamp(torch.minimum(i0, (true_len - 1)[:, None]), min=0)
    # past the end the pair partner is the same sample (host: i1 == i0)
    fr = torch.where(i0 + 1 >= true_len[:, None], 0.0, fr)
    ic = torch.clamp(i0, max=src.shape[1] - 2)
    r0 = torch.gather(src, 1, ic)
    r1 = torch.gather(src, 1, ic + 1)
    return (1 - fr) * r0 + fr * r1


@functools.lru_cache(maxsize=8)
def _hann(device) -> Tensor:
    return torch.from_numpy(
        np.hanning(_N_FFT + 1)[:-1].astype(np.float32)).to(device)


def _overlap_add(frames: Tensor, total: int) -> Tensor:
    """Overlap-add of (B, T, n_fft) frames at hop `_HOP` into (B, total):
    the hop divides n_fft, so it is n_fft / hop shifted sums of the frames'
    quarters, added in a fixed order."""
    b = frames.shape[0]
    out = None
    for r in range(_N_FFT // _HOP):
        seg = frames[:, :, r * _HOP:(r + 1) * _HOP].reshape(b, -1)
        piece = F.pad(seg, (r * _HOP, total - r * _HOP - seg.shape[1]))
        out = piece if out is None else out + piece
    return out


@functools.lru_cache(maxsize=8)
def _bin_advance(n_bins: int, device) -> Tensor:
    """Each frequency bin's phase advance over one hop."""
    return torch.from_numpy((2 * np.pi * _HOP * np.arange(n_bins)
                             / ((n_bins - 1) * 2)).astype(np.float32)
                            ).to(device)


def pitch_apply(x: Tensor, cents: Tensor, shift_max: int = 300) -> Tensor:
    """Phase-vocoder pitch shift of each window by its cents (the host
    algorithm, `augmentation.py:_stft/_phase_vocoder/_istft`, vectorised):
    time-stretch by 1/factor, then linear-resample back to W. The frame
    budget covers the stretch of +shift_max cents; frames past a window's
    own count are masked."""
    b, w = x.shape
    max_factor = 2.0 ** (shift_max / 1200.0)
    factor64 = _factor64(cents)
    rate = (1.0 / factor64).to(torch.float32)
    win = _hann(x.device)
    pad = _N_FFT // 2
    xp = F.pad(x[:, None, :], (pad, pad), mode='reflect')[:, 0]
    spec = torch.fft.rfft(xp.unfold(1, _N_FFT, _HOP) * win, dim=-1)
    n_frames, n_bins = spec.shape[1], spec.shape[2]

    t_out_max = int(math.ceil((n_frames - 1) * max_factor)) + 1
    t = torch.arange(t_out_max, dtype=torch.float32, device=x.device)
    steps = t[None, :] * rate[:, None]                     # (B, T)
    # host: len(np.arange(0, n_frames - 1, rate)) frames
    n_out = torch.ceil((n_frames - 1) / (1.0 / factor64))
    live = (t[None, :] < n_out[:, None]).to(torch.float32)
    i = torch.clamp(steps.to(torch.int64), 0, n_frames - 2)
    frac = (steps - i.to(torch.float32))[..., None]

    omega = _bin_advance(n_bins, x.device)
    rows = torch.arange(b, device=x.device)[:, None]
    s_i, s_i1 = spec[rows, i], spec[rows, i + 1]           # (B, T, F)
    mag = (1 - frac) * s_i.abs() + frac * s_i1.abs()
    dphase = s_i1.angle() - s_i.angle() - omega
    dphase = dphase - 2 * math.pi * torch.round(dphase / (2 * math.pi))
    # host: phase[t] = angle(spec[0]) + sum_{u<t} (omega + dphase_u),
    # accumulated in float64 (the sums reach 1e5 rad)
    inc = (omega + dphase).double()
    phase = spec[:, :1].angle().double() + torch.cat(
        [torch.zeros_like(inc[:, :1]), torch.cumsum(inc, dim=1)[:, :-1]],
        dim=1)
    out_spec = torch.polar(mag.double(), phase).to(torch.complex64) \
        * live[..., None]

    frames = torch.fft.irfft(out_spec, n=_N_FFT, dim=-1) * win
    total = _HOP * (t_out_max - 1) + _N_FFT
    out = _overlap_add(frames, total)
    norm = _overlap_add((win ** 2) * live[..., None], total)
    stretched = out / torch.clamp(norm, min=1e-8)
    true_len = torch.round(w * factor64).to(torch.int64)
    y = _resample_live_prefix(stretched[:, pad:], true_len, w)
    return _keep_finite(x, y, cents)


def pitch(x: Tensor, gen: torch.Generator, shift_max: int = 300) -> Tensor:
    """A random phase-vocoder pitch shift a window (`--pitch_algo
    vocoder`)."""
    return pitch_apply(x, *pitch_draw(*x.shape, gen, shift_max),
                       shift_max=shift_max)


def pitch_quick_apply(x: Tensor, cents: Tensor, shift_max: int = 300
                      ) -> Tensor:
    """The host's quick pitch branch (`augmentation.py:pitch_shift`,
    quick=True, sox `rate -q`): linear-interpolate each window to
    ceil(W * factor) samples, then linear-resample back to W."""
    b, w = x.shape
    max_factor = 2.0 ** (shift_max / 1200.0)
    factor64 = _factor64(cents)
    step = (1.0 / factor64).to(torch.float32)
    # host: len(np.arange(0, w, 1 / factor))
    true_len = torch.ceil(w / (1.0 / factor64)).to(torch.int64)
    l_max = int(math.ceil(w * max_factor)) + 1
    k = torch.arange(l_max, dtype=torch.float32, device=x.device)
    pos = k[None, :] * step[:, None]
    i0 = torch.clamp(pos.to(torch.int64), 0, w - 1)
    fr = pos - i0.to(torch.float32)
    # the last sample twice, so positions in (w-1, w) clamp like
    # np.interp's right fill
    xp = torch.cat([x, x[:, -1:]], dim=1)
    stretched = ((1 - fr) * torch.gather(xp, 1, i0)
                 + fr * torch.gather(xp, 1, i0 + 1))
    y = _resample_live_prefix(stretched, true_len, w)
    return _keep_finite(x, y, cents)


def pitch_quick(x: Tensor, gen: torch.Generator, shift_max: int = 300
                ) -> Tensor:
    """A random quick pitch shift a window (`--pitch_algo vocoder`'s
    `pitch_quick` and `pitch_dropout`)."""
    return pitch_quick_apply(x, *pitch_draw(*x.shape, gen, shift_max),
                             shift_max=shift_max)


# WSOLA (host `augmentation.py:_wsola_stretch`, the sox tempo/pitch family).
# Each segment's lag depends on the tail the previous one left, but the
# search window is fixed (sox tempo's music defaults: segment 82 ms, search
# +-14.68 ms, overlap 12 ms), so a step is one masked cross-correlation of
# 2*search+1 lags and an argmax, over every window of the batch at once;
# about 22 steps stretch a 1.28 s window. The output of step i lands at
# the fixed position i*hop, and the crossfade's reference tail is always
# the previous chunk's [hop:], so the stretched signal is the steps' rows
# side by side: no scatter.

_WS_SEG = int(82.0 * SAMPLE_RATE / 1000)       # 1312
_WS_OVR = int(12.0 * SAMPLE_RATE / 1000)       # 192
_WS_SEARCH = int(14.68 * SAMPLE_RATE / 1000)   # 234
_WS_HOP = _WS_SEG - _WS_OVR                    # 1120


def _round_ratio(num: Tensor, den: Tensor) -> Tensor:
    """round(num / den), halves to even as Python's round, in exact int64
    arithmetic (the host rounds `pos * rate` in float64, which for these
    magnitudes is the correctly rounded rational)."""
    q = torch.div(num, den, rounding_mode='floor')
    r = num - q * den
    up = (2 * r > den) | ((2 * r == den) & (q % 2 == 1))
    return q + up.to(q.dtype)


@functools.lru_cache(maxsize=8)
def _crossfade_ramp(n: int, device) -> Tensor:
    return torch.from_numpy(np.linspace(0.0, 1.0, n).astype(np.float32)
                            ).to(device)


def _wsola_stretch_dev(x: Tensor, out_len: Tensor, max_out_len: int
                       ) -> Tuple[Tensor, Tensor]:
    """WSOLA time-stretch of each window ((B, W)) to its `out_len` ((B,)
    int64) on a budget of `max_out_len` samples. Returns the stretched
    rows on a ceil(max_out_len / hop) * hop grid, whose live prefix is
    `out_len`, and each step's segment position (B, steps).

    The host's algorithm: the same positions, the first maximum on a tie
    (ascending candidate position), the crossfade that replaces the tail,
    the same fallbacks at the ends. A slice that would leave the padded
    input starts at its last valid place, as the JAX package's
    `dynamic_slice`; that happens only at steps past the live prefix."""
    b, w = x.shape
    seg, ovr, search, hop = _WS_SEG, _WS_OVR, _WS_SEARCH, _WS_HOP
    n_steps = -(-max_out_len // hop)
    dev = x.device
    ramp = _crossfade_ramp(ovr, dev)
    # xp[:, search + k] == x[:, k], zeros outside
    xp = F.pad(x, (search, seg + search))
    n_pad = xp.shape[1]
    n_scan = 2 * search + ovr
    scan_off = torch.arange(n_scan, device=dev)
    chunk_off = torch.arange(seg, device=dev)
    lags = torch.arange(2 * search + 1, device=dev)
    rows, positions, tail = [], [], None
    for i in range(n_steps):
        want = _round_ratio(torch.full_like(out_len, i * hop * w), out_len)
        if tail is None:
            best = want
        else:
            lo = torch.clamp(want - search, min=0)
            hi = torch.clamp(want + search, max=w - seg)
            start = torch.clamp(want, 0, n_pad - n_scan)
            scan = torch.gather(xp, 1, start[:, None] + scan_off)
            # candidate j sits at p = want - search + j; float32 products
            # are exact in float64, so the scores and their argmax are the
            # same on every device
            scores = (scan.unfold(1, ovr, 1).double()
                      * tail.double()[:, None, :]).sum(dim=-1)
            p = (want - search)[:, None] + lags
            valid = (p >= lo[:, None]) & (p <= hi[:, None])
            j = torch.argmax(torch.where(valid, scores, -math.inf), dim=1)
            best = torch.where(
                hi > lo, want - search + j,
                # host fallback: max(0, min(want, w - seg))
                torch.clamp(torch.clamp(want, max=w - seg), min=0))
            # past the input's end the host keeps best = want (xp's zeros
            # are its zero fill)
            best = torch.where(want + seg > w, want, best)
        chunk = torch.gather(
            xp, 1, torch.clamp(best + search, 0, n_pad - seg)[:, None]
            + chunk_off)
        head = chunk[:, :ovr]
        if tail is not None:
            head = tail * (1 - ramp) + head * ramp
        rows.append(torch.cat([head, chunk[:, ovr:hop]], dim=1))
        positions.append(best)
        tail = chunk[:, hop:]
    return torch.cat(rows, dim=1), torch.stack(positions, dim=1)


def _wsola_lengths(w: int, cents: Tensor, shift_max: int
                   ) -> Tuple[Tensor, int]:
    out_len = torch.round(w * _factor64(cents)).to(torch.int64)
    return out_len, int(math.ceil(w * 2.0 ** (shift_max / 1200.0))) + 1


def wsola_positions(x: Tensor, cents: Tensor, shift_max: int = 300
                    ) -> Tensor:
    """The segment positions `pitch_wsola_apply` takes for these cents,
    (B, steps) int64."""
    out_len, max_out = _wsola_lengths(x.shape[1], cents, shift_max)
    return _wsola_stretch_dev(x, out_len, max_out)[1]


def pitch_wsola_apply(x: Tensor, cents: Tensor, shift_max: int = 300
                      ) -> Tensor:
    """WSOLA pitch shift of each window by its cents: stretch to
    round(W * factor) samples, linear-resample back to W (the host's
    `pitch_shift(..., algo='wsola')`)."""
    w = x.shape[1]
    out_len, max_out = _wsola_lengths(w, cents, shift_max)
    stretched, _ = _wsola_stretch_dev(x, out_len, max_out)
    y = _resample_live_prefix(stretched, out_len, w)
    return _keep_finite(x, y, cents)


def pitch_wsola(x: Tensor, gen: torch.Generator, shift_max: int = 300
                ) -> Tensor:
    """A random WSOLA pitch shift a window (`--pitch_algo wsola`, the
    default: the sox training distribution)."""
    return pitch_wsola_apply(x, *pitch_draw(*x.shape, gen, shift_max),
                             shift_max=shift_max)


# ---------------------------------------------------------------------------
# Gaussian noise and time dropout (host: `RandomAdditiveNoiseAugment`,
# `TimeDropoutAugment`)
# ---------------------------------------------------------------------------

def gaussian_noise_draw(b: int, w: int, gen: torch.Generator) -> Params:
    return (torch.randn((b, w), generator=gen, device=gen.device),)


def gaussian_noise_apply(x: Tensor, noise: Tensor, snr: float = 15.0
                         ) -> Tensor:
    """The host formula: noise scaled to the window's own std over a
    10^(snr/10) power ratio."""
    alpha = (10.0 ** (snr / 10.0)) / (
        x.std(dim=-1, keepdim=True, correction=0) + 1e-12)
    return x + noise / alpha


def gaussian_noise(x: Tensor, gen: torch.Generator, snr: float = 15.0
                   ) -> Tensor:
    return gaussian_noise_apply(x, *gaussian_noise_draw(*x.shape, gen),
                                snr=snr)


def time_dropout_draw(b: int, w: int, gen: torch.Generator,
                      t_ms: int = 100) -> Params:
    """A span ~ U{0, t_ms ms - 1} samples a window, starting at
    U{0, max(W - span, 1) - 1}: (start, span)."""
    span = _randint(0, int(t_ms * SAMPLE_RATE / 1000), (b,), gen)
    room = torch.clamp(w - span, min=1)
    start = torch.minimum((_uniform((b,), gen, torch.float64)
                           * room).to(torch.int64), room - 1)
    return start, span


def time_dropout_apply(x: Tensor, start: Tensor, span: Tensor) -> Tensor:
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    drop = (pos >= start[:, None]) & (pos < (start + span)[:, None])
    return torch.where(drop, 0.0, x)


def time_dropout(x: Tensor, gen: torch.Generator, t_ms: int = 100
                 ) -> Tensor:
    return time_dropout_apply(x, *time_dropout_draw(*x.shape, gen, t_ms))


# ---------------------------------------------------------------------------
# Artificial reverb (host: `ReverbAugment`, freeverb). For a fixed room
# size freeverb is linear and time-invariant, so the filter chain is one
# convolution with its impulse response. A bank of them (one an integer
# room size) is computed once in numpy with an O(W) block recurrence (the
# feedback taps sit about 1,600 samples back, so scipy.lfilter would cost
# O(W * delay) a filter), moved to the device once, and each window
# gathers its room's and convolves by FFT.
# ---------------------------------------------------------------------------

def _comb_np(x: np.ndarray, d: int, c1: float, c2: float) -> np.ndarray:
    """y[n] = x[n-d] + c1*y[n-d] + c2*y[n-d-1], block by block (every
    index referenced lies before the block, so blocks of d samples
    vectorise)."""
    w = x.shape[0]
    y = np.zeros(w, x.dtype)
    for start in range(0, w, d):
        idx = np.arange(start, min(start + d, w))
        acc = np.zeros(idx.shape[0], x.dtype)
        m = idx >= d
        acc[m] = x[idx[m] - d] + c1 * y[idx[m] - d]
        m2 = idx >= d + 1
        acc[m2] += c2 * y[idx[m2] - d - 1]
        y[idx] = acc
    return y


def _allpass_np(x: np.ndarray, d: int) -> np.ndarray:
    """y[n] = -0.5*x[n] + x[n-d] + 0.5*y[n-d] (the same block scheme)."""
    w = x.shape[0]
    y = np.zeros(w, x.dtype)
    ff = -0.5 * x
    ff[d:] += x[:-d]
    for start in range(0, w, d):
        idx = np.arange(start, min(start + d, w))
        acc = ff[idx].copy()
        m = idx >= d
        acc[m] += 0.5 * y[idx[m] - d]
        y[idx] = acc
    return y


def _freeverb_ir(room: float, reverberance: float, hf_damping: float,
                 w: int) -> np.ndarray:
    """The impulse response of the host's `_freeverb` chain, cut to w (the
    host's output is cut to w anyway)."""
    feedback = 0.28 + 0.7 * (room / 100.0)
    damping = hf_damping / 100.0 * 0.4 + 0.2
    delta = np.zeros(w, np.float64)
    delta[0] = 1.0
    wet = np.zeros(w, np.float64)
    for d in _COMB_TUNINGS:
        wet += _comb_np(delta, d, feedback * (1 - damping),
                        feedback * damping)
    wet /= len(_COMB_TUNINGS)
    for d in _ALLPASS_TUNINGS:
        wet = _allpass_np(wet, d)
    mix = reverberance / 100.0
    return ((1 - mix * 0.5) * delta + mix * 0.5 * wet).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _freeverb_ir_bank(n_rooms: int, reverberance: float, hf_damping: float,
                      w: int) -> np.ndarray:
    return np.stack([_freeverb_ir(room, reverberance, hf_damping, w)
                     for room in range(n_rooms)])


@functools.lru_cache(maxsize=8)
def _ir_bank_on(n_rooms: int, reverberance: float, hf_damping: float,
                w: int, device: torch.device) -> Tensor:
    """The bank on `device`, moved there once (100 x W float32: 8.2 MB at
    W = 20,480)."""
    return torch.from_numpy(_freeverb_ir_bank(
        n_rooms, reverberance, hf_damping, w)).to(device)


def _fft_conv_crop(x: Tensor, ir: Tensor) -> Tensor:
    """Each row's causal convolution with its impulse response, cut to the
    input's length (scipy's 'full' mode [:w], the host's reverb)."""
    w = x.shape[-1]
    nfft = 1 << (2 * w - 2).bit_length()
    y = torch.fft.irfft(torch.fft.rfft(x, nfft) * torch.fft.rfft(ir, nfft),
                        nfft)
    return y[..., :w]


def artificial_reverb_draw(b: int, w: int, gen: torch.Generator,
                           n_rooms: int = 100) -> Params:
    """A room size ~ U{0, n_rooms - 1} a window."""
    return (_randint(0, n_rooms, (b,), gen),)


def artificial_reverb_apply(x: Tensor, rooms: Tensor,
                            reverberance: float = 100.0,
                            hf_damping: float = 100.0,
                            n_rooms: int = 100) -> Tensor:
    bank = _ir_bank_on(n_rooms, float(reverberance), float(hf_damping),
                       x.shape[1], x.device)
    return _fft_conv_crop(x, bank[rooms])


def artificial_reverb(x: Tensor, gen: torch.Generator, n_rooms: int = 100,
                      reverberance: float = 100.0, hf_damping: float = 100.0
                      ) -> Tensor:
    """Freeverb at a random room size a window (host `ReverbAugment`)."""
    return artificial_reverb_apply(
        x, *artificial_reverb_draw(*x.shape, gen, n_rooms),
        reverberance=reverberance, hf_damping=hf_damping, n_rooms=n_rooms)


def artificial_reverb_dropout_draw(b: int, w: int, gen: torch.Generator,
                                   t_ms: int = 100) -> Params:
    return (artificial_reverb_draw(b, w, gen)
            + time_dropout_draw(b, w, gen, t_ms))


def artificial_reverb_dropout_apply(x: Tensor, rooms: Tensor, start: Tensor,
                                    span: Tensor) -> Tensor:
    """Host `ReverbDropout`: reverb(50, 50, room), then time dropout."""
    y = artificial_reverb_apply(x, rooms, reverberance=50.0,
                                hf_damping=50.0)
    return time_dropout_apply(y, start, span)


def artificial_reverb_dropout(x: Tensor, gen: torch.Generator,
                              t_ms: int = 100) -> Tensor:
    return artificial_reverb_dropout_apply(
        x, *artificial_reverb_dropout_draw(*x.shape, gen, t_ms))


def pitch_dropout_draw(b: int, w: int, gen: torch.Generator,
                       shift_max: int = 300, t_ms: int = 100) -> Params:
    return pitch_draw(b, w, gen, shift_max) + time_dropout_draw(b, w, gen,
                                                                t_ms)


def pitch_dropout_apply(x: Tensor, cents: Tensor, start: Tensor,
                        span: Tensor, shift_max: int = 300,
                        pitch_algo: str = 'wsola') -> Tensor:
    """Host `PitchDropout`: a pitch shift, then time dropout. The pitch
    stage is the WSOLA stretch under the default `--pitch_algo wsola` (the
    reference chain `pitch ... rate -q` is a WSOLA stretch and a quick
    resample), the quick linear stretch under 'vocoder'."""
    stage = pitch_wsola_apply if pitch_algo == 'wsola' else pitch_quick_apply
    return time_dropout_apply(stage(x, cents, shift_max=shift_max), start,
                              span)


def pitch_dropout(x: Tensor, gen: torch.Generator, shift_max: int = 300,
                  t_ms: int = 100, pitch_algo: str = 'wsola') -> Tensor:
    return pitch_dropout_apply(
        x, *pitch_dropout_draw(*x.shape, gen, shift_max, t_ms),
        shift_max=shift_max, pitch_algo=pitch_algo)


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------

class Stage:
    """One augmentation of a device chain: `draw(b, w, gen)` gives its
    random parameters, a tuple of tensors on the generator's device, and
    `apply(x, *params)` its result on (B, W) windows. `bank` is the numpy
    array of rows a stage gathers from, where it has one (the impulse
    responses, the noise pool), whose row k a drawn index k names."""

    def __init__(self, name: str, draw: Callable[..., Params],
                 apply: Callable[..., Tensor],
                 bank: Optional[np.ndarray] = None):
        self.name = name
        self.draw = draw
        self.apply = apply
        self.bank = bank

    def __call__(self, x: Tensor, gen: torch.Generator) -> Tensor:
        return self.apply(x, *self.draw(*x.shape, gen))

    def __repr__(self) -> str:
        return f"Stage({self.name})"


class DeviceChain:
    """Stages applied in order. `draw` takes every stage's parameters (in
    stage order) before anything is applied, so the same draws can be
    applied to several views or on several devices."""

    def __init__(self, stages: Sequence[Stage]):
        self.stages = list(stages)

    def draw(self, b: int, w: int, gen: torch.Generator) -> List[Params]:
        return [stage.draw(b, w, gen) for stage in self.stages]

    def apply(self, x: Tensor, params: Sequence[Params]) -> Tensor:
        for stage, p in zip(self.stages, params):
            x = stage.apply(x, *p)
        return x

    def __call__(self, x: Tensor, gen: torch.Generator) -> Tensor:
        return self.apply(x, self.draw(*x.shape, gen))

    def __repr__(self) -> str:
        return f"DeviceChain({[s.name for s in self.stages]})"


# ---------------------------------------------------------------------------
# Natural reverb and additive noise: banks kept on the device
# ---------------------------------------------------------------------------

def _peak_norm(x: Tensor) -> Tensor:
    return x / (x.abs().amax(dim=-1, keepdim=True) + 1e-8)


def _energy_norm(x: Tensor) -> Tensor:
    return x / (torch.sqrt(torch.mean(x ** 2, dim=-1, keepdim=True)) + 1e-8)


class _OnDevice:
    """A numpy bank (rows x length) cut or zero-padded to W columns and
    moved to each device it is asked for, once."""

    def __init__(self, bank: np.ndarray):
        self.bank = bank
        self._moved = {}

    def __call__(self, w: int, device: torch.device) -> Tensor:
        key = (w, str(device))
        if key not in self._moved:
            n = self.bank.shape[1]
            cut = (self.bank[:, :w] if n >= w
                   else np.pad(self.bank, ((0, 0), (0, w - n))))
            self._moved[key] = torch.from_numpy(
                np.ascontiguousarray(cut)).to(device)
        return self._moved[key]


def make_natural_reverb(ir_paths: str, p: float,
                        batch_wise: bool = False) -> Stage:
    """Host `NaturalReverb` on the device: the impulse responses under
    `ir_paths` are loaded once; each window is convolved, with probability
    p, with a random one (one for the whole batch with `batch_wise`), and
    peak-normalised either way, as the host does. Draws: the responses'
    indices and the uniform that decides each window."""
    from .audio_io import load_audio
    from .corpus import find_all_seqs

    ir_files, _ = find_all_seqs(ir_paths, extension=".wav", speaker_level=0)
    irs = [np.asarray(load_audio(os.path.join(ir_paths, rel))[0],
                      np.float32).reshape(-1) for _, rel in ir_files]
    if not irs:
        raise ValueError(f"no impulse responses found under {ir_paths}")
    print("Found %d files for natural reverberation (device bank)"
          % len(irs))
    max_len = max(r.shape[0] for r in irs)
    bank = _OnDevice(np.stack([np.pad(r, (0, max_len - r.shape[0]))
                               for r in irs]))

    def draw(b: int, w: int, gen: torch.Generator) -> Params:
        idx = _randint(0, len(irs), (1 if batch_wise else b,), gen)
        return idx, _uniform((b,), gen)

    def apply(x: Tensor, idx: Tensor, u: Tensor) -> Tensor:
        b, w = x.shape
        ir = bank(w, x.device)[idx].expand(b, w)
        wet = _peak_norm(_fft_conv_crop(x, ir))
        return torch.where((u < p)[:, None], wet, _peak_norm(x))

    return Stage('natural_reverb', draw, apply, bank=bank.bank)


def make_additive_noise(noise_dataset, snr_min: float, snr_max: float,
                        batch_size: int, pool_size: int = 512,
                        sampling: str = 'uniform') -> Stage:
    """Host `AdditiveNoiseAugment` on the device: a pool of noise windows
    is drawn from the noise corpus's loader once (meta augmentation applies
    there, as on the host) and kept on the device (512 x W float32: 42 MB
    at W = 20,480); each window mixes a random pool row at a random SNR ~
    U[snr_min, snr_max). The host takes noise windows in order without
    replacement; the pool is sampled with replacement. Draws: the rows
    and the SNRs."""
    if noise_dataset is None or snr_min > snr_max:
        raise ValueError("additive noise needs a noise dataset and "
                         f"snr_min <= snr_max ({snr_min}, {snr_max})")
    loader = noise_dataset.getDataLoader(
        min(batch_size, 64), sampling, True,
        remove_artefacts=sampling != 'uniform')
    rows: List[np.ndarray] = []
    for batch, _speaker in loader:
        # the host takes view 0 of each noise window
        rows.extend(batch[:, 0].reshape(batch.shape[0], -1))
        if len(rows) >= pool_size:
            break
    pool = _OnDevice(np.stack(rows[:pool_size]).astype(np.float32))
    print("Device noise pool: %d windows of %d samples"
          % pool.bank.shape)

    def draw(b: int, w: int, gen: torch.Generator) -> Params:
        idx = _randint(0, pool.bank.shape[0], (b,), gen)
        return idx, _uniform((b,), gen) * (snr_max - snr_min) + snr_min

    def apply(x: Tensor, idx: Tensor, snr: Tensor) -> Tensor:
        noise = pool(x.shape[1], x.device)[idx]
        noise_rms = (10.0 ** (-snr / 20.0))[:, None]
        return _peak_norm(_energy_norm(x) + _energy_norm(noise) * noise_rms)

    return Stage('additive', draw, apply, bank=pool.bank)


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

# the CLI's `--augment_type` vocabulary; 'random_noise' has no CLI
# spelling in the reference
DEVICE_AUGMENTATIONS = ('bandreject', 'pitch', 'pitch_quick',
                        'pitch_dropout', 'time_dropout', 'random_noise',
                        'artificial_reverb', 'artificial_reverb_dropout',
                        'natural_reverb', 'additive')


def _pitch_stage(name: str, apply, shift_max: int) -> Stage:
    return Stage(name, functools.partial(pitch_draw, shift_max=shift_max),
                 functools.partial(apply, shift_max=shift_max))


def make_device_augment(augment_types: Sequence[str],
                        shift_max: int = 300,
                        bandreject_scaler: float = 1.0,
                        noise_snr: float = 15.0,
                        t_ms: int = 100,
                        noise_dataset=None,
                        snr_min: float = 5.0,
                        snr_max: float = 20.0,
                        batch_size: int = 8,
                        ir_paths: Optional[str] = None,
                        ir_prob: float = 1.0,
                        ir_batch_wise: bool = False,
                        noise_sampling: str = 'uniform',
                        pitch_algo: str = 'wsola'
                        ) -> Optional[DeviceChain]:
    """The chain of the host factory's whole vocabulary, or None for an
    empty list. `natural_reverb` needs `ir_paths` (a directory of impulse
    responses) and `additive` a `noise_dataset`, and raise without them as
    the host factory does; a name with no device version raises
    ValueError."""
    names = [canonical_augment_type(t) for t in augment_types or []]
    shift_max = int(shift_max)
    # Under the default pitch_algo='wsola' every pitch stage runs the WSOLA
    # stretch (the host dispatches on the algo first: sox `pitch` is WSOLA
    # in every reference chain, quick or not). 'vocoder' keeps the host
    # factory's quick contagion: a combined chain passes
    # pitch_quick=('pitch_quick' in augment_type) to every pitch stage, so
    # a 'pitch' listed beside a 'pitch_quick' runs the quick resample too.
    quick_contagion = len(names) > 1 and 'pitch_quick' in names
    stages = []
    for name in names:
        if name == 'bandreject':
            stages.append(Stage(name, functools.partial(
                bandreject_draw, scaler=bandreject_scaler),
                bandreject_apply))
        elif name in ('pitch', 'pitch_quick') and pitch_algo == 'wsola':
            stages.append(_pitch_stage(name, pitch_wsola_apply, shift_max))
        elif name == 'pitch_quick' or (name == 'pitch' and quick_contagion):
            stages.append(_pitch_stage(name, pitch_quick_apply, shift_max))
        elif name == 'pitch':
            stages.append(_pitch_stage(name, pitch_apply, shift_max))
        elif name == 'pitch_dropout':
            stages.append(Stage(name, functools.partial(
                pitch_dropout_draw, shift_max=shift_max, t_ms=t_ms),
                functools.partial(pitch_dropout_apply, shift_max=shift_max,
                                  pitch_algo=pitch_algo)))
        elif name == 'random_noise':
            stages.append(Stage(name, gaussian_noise_draw, functools.partial(
                gaussian_noise_apply, snr=noise_snr)))
        elif name == 'time_dropout':
            stages.append(Stage(name, functools.partial(
                time_dropout_draw, t_ms=t_ms), time_dropout_apply))
        elif name == 'artificial_reverb':
            stages.append(Stage(name, artificial_reverb_draw,
                                artificial_reverb_apply))
        elif name == 'artificial_reverb_dropout':
            stages.append(Stage(name, functools.partial(
                artificial_reverb_dropout_draw, t_ms=t_ms),
                artificial_reverb_dropout_apply))
        elif name == 'natural_reverb':
            if ir_paths is None:
                raise RuntimeError('Impulse responses are needed for the '
                                   'natural reverb (--pathImpulseResponses)')
            stages.append(make_natural_reverb(ir_paths, ir_prob,
                                              batch_wise=ir_batch_wise))
        elif name == 'additive':
            if noise_dataset is None:
                raise RuntimeError('Noise dataset is needed for the '
                                   'additive noise')
            # noise_sampling carries --temporal_additive_noise to the pool's
            # loader, as the host factory maps it to its sampler
            stages.append(make_additive_noise(noise_dataset, snr_min,
                                              snr_max, batch_size,
                                              sampling=noise_sampling))
        else:
            raise ValueError(
                f"augmentation {name!r} has no device implementation "
                f"(supported: {DEVICE_AUGMENTATIONS}); run it on the host "
                f"pipeline instead")
    return DeviceChain(stages) if stages else None
