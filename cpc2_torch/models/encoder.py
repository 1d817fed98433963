"""The waveform encoders (counterpart of `cpc2_tpu/models/encoder.py`,
reference `cpc/model.py:27-155`): the strided convolutional encoder, and
the MFCC and learned-filterbank front-ends of `--encoder_type mfcc|lfb`.

The convolutions are `nn.Conv1d` in PyTorch's NCW layout on cuDNN (the
first, with its one input channel, as one product over the input's
windows: see `conv_windows`), or, with CPC2_FUSED_ENCODER=1, the CUDA
kernels of `ops/encoder.py`, which run the whole stack; the public output
is `(B, frames, C)`, the JAX package's layout. The MFCC and LFB
front-ends have no kernel in the JAX package either: their FFT, mel
products and convolutions are library calls here too.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.encoder import fused_encoder, use_fused_encoder

DOWNSAMPLING = 160

# (kernel, stride, padding) per layer of the strided conv stack.
CONV_STACK = ((10, 5, 3), (8, 4, 2), (4, 2, 1), (4, 2, 1), (4, 2, 1))

NORM_MODES = ("batchNorm", "instanceNorm", "ID", "layerNorm")

# the MFCC front-end's FFT size (hop = n_fft // 2 = 160), and the learned
# filterbank's taps and the padding of its smoothing
MFCC_N_FFT = 321
LFB_TAPS, LFB_PAD = 400, 350


def encoded_seq_len(size_window: int, encoder_type: str = "cpc") -> int:
    """Number of encoded frames produced for a raw window of `size_window`
    by the `--encoder_type` encoder (128 for each at 20,480 samples)."""
    if encoder_type == "mfcc":
        return 1 + (size_window + 2 * (MFCC_N_FFT // 2) - MFCC_N_FFT) \
            // (MFCC_N_FFT // 2)
    if encoder_type == "lfb":
        length = size_window - LFB_TAPS + 1
        return (length + 2 * LFB_PAD - LFB_TAPS) // DOWNSAMPLING + 1
    length = size_window
    for k, s, p in CONV_STACK:
        length = (length + 2 * p - k) // s + 1
    return length


class ChannelNorm(nn.Module):
    """Per-timestep normalization over the channel axis of an NCW tensor with
    the unbiased variance, eps 1e-5 and an affine map stored `(1, C, 1)`,
    as in the reference's checkpoints."""

    def __init__(self, num_features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(1, num_features, 1))
        self.bias = nn.Parameter(torch.zeros(1, num_features, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, keepdim=True, unbiased=True)
        return (x - mean) * torch.rsqrt(var + self.epsilon) * self.weight \
            + self.bias


def conv_windows(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """`conv(x)` for a convolution with one input channel, as one batched
    product of the kernel `(C, k)` with the input's windows `(k, T_out)`,
    the bias added in it, the output in NCW like `conv`'s. cuDNN's
    weight gradient for this layer differs between calls on the same
    inputs on an H100, and with it every later step of a run; the product's
    gradients are batched GEMMs and sums, the same on every call, so a run
    on the card replays exactly (a resumed one too)."""
    (k,), (s,), (p,) = conv.kernel_size, conv.stride, conv.padding
    windows = nn.functional.pad(x[:, 0], (p, p)).unfold(-1, k, s)
    weight = conv.weight[:, 0].expand(x.shape[0], -1, -1)    # (B, C, k)
    return torch.baddbmm(conv.bias[:, None], weight,
                         windows.transpose(1, 2))             # (B, C, T_out)


def _norm(norm_mode: str, channels: int) -> nn.Module:
    if norm_mode == "layerNorm":
        return ChannelNorm(channels)
    if norm_mode == "instanceNorm":
        return nn.InstanceNorm1d(channels, affine=True)
    if norm_mode == "batchNorm":
        # torch's running statistics, as the reference's BatchNorm1d keeps
        return nn.BatchNorm1d(channels)
    if norm_mode == "ID":
        return nn.Identity()
    raise ValueError(f"Norm mode must be in {list(NORM_MODES)}")


class CPCEncoder(nn.Module):
    """5-layer strided Conv1d stack, 160x downsampling, each convolution
    followed by a normalization (`normMode`) and a ReLU. Parameters are
    named `conv{i}` and `batchNorm{i}` like the reference's.

    Input: raw waveform `(B, T)` or `(B, 1, T)`.
    Output: encoded frames `(B, T // 160, size_hidden)`."""

    def __init__(self, size_hidden: int = 512, norm_mode: str = "layerNorm"):
        super().__init__()
        self.norm_mode = norm_mode
        self.size_hidden = size_hidden
        in_channels = 1
        for i, (k, s, p) in enumerate(CONV_STACK):
            self.add_module(f"conv{i}", nn.Conv1d(in_channels, size_hidden,
                                                  k, stride=s, padding=p))
            self.add_module(f"batchNorm{i}", _norm(norm_mode, size_hidden))
            in_channels = size_hidden

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x[:, None, :]
        if x.shape[1] == 1 and use_fused_encoder(
                x.shape[2], self.size_hidden, CONV_STACK, self.norm_mode,
                x.dtype):
            # the whole stack in the encoder kernels (`ops/encoder.py`),
            # opt-in as in the JAX package
            n = len(CONV_STACK)
            convs = [getattr(self, f"conv{i}") for i in range(n)]
            norms = [getattr(self, f"batchNorm{i}") for i in range(n)]
            return fused_encoder(x[:, 0], [c.weight for c in convs],
                                 [c.bias for c in convs],
                                 [m.weight for m in norms],
                                 [m.bias for m in norms])
        for i in range(len(CONV_STACK)):
            conv = getattr(self, f"conv{i}")
            x = conv_windows(x, conv) if i == 0 else conv(x)
            x = torch.relu(getattr(self, f"batchNorm{i}")(x))
        return x.transpose(1, 2)


# ---------------------------------------------------------------------------
# MFCC front-end (reference `cpc/model.py:111-125`, torchaudio's defaults)
# ---------------------------------------------------------------------------

def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def melscale_fbanks(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                    sample_rate: int) -> np.ndarray:
    """Triangular mel filter bank as torchaudio's default (HTK scale, no
    normalization). Returns (n_freqs, n_mels)."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_min, m_max = _hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def _dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """DCT-II with 'ortho' norm, (n_mels, n_mfcc), torchaudio's layout."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    dct = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k[None, :]) * 2.0
    dct[:, 0] *= 1.0 / math.sqrt(2.0)
    dct *= 1.0 / math.sqrt(2.0 * n_mels)
    return dct.astype(np.float32)


class MFCCEncoder(nn.Module):
    """MFCC front-end (reference `cpc/model.py:111-125`), torchaudio's
    defaults: n_fft = win = 321, hop 160, centred frames (reflect
    padding), a periodic Hann window, the power spectrum, an HTK mel bank
    of max(128, dim) bands, `AmplitudeToDB(top_db=80)` and an ortho DCT.
    No parameters. The top-dB clamp is taken against the maximum of the
    whole batch, as torchaudio's `amplitude_to_DB` takes it, so the
    training step's one call on both views couples them as the JAX
    package's does."""

    def __init__(self, dim_encoded: int, sample_rate: int = 16000,
                 n_fft: int = MFCC_N_FFT):
        super().__init__()
        self.size_hidden = dim_encoded
        self.n_fft = n_fft
        n_mels = max(128, dim_encoded)
        self.register_buffer("window", torch.from_numpy(
            np.hanning(n_fft + 1)[:-1].astype(np.float32)), persistent=False)
        self.register_buffer("fb", torch.from_numpy(melscale_fbanks(
            n_fft // 2 + 1, 0.0, sample_rate / 2, n_mels, sample_rate)),
            persistent=False)
        self.register_buffer("dct", torch.from_numpy(
            _dct_matrix(dim_encoded, n_mels)), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[:, 0] if x.shape[1] == 1 else x.reshape(x.shape[0], -1)
        hop = pad = self.n_fft // 2
        x = nn.functional.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
        frames = x.unfold(-1, self.n_fft, hop)              # (B, F, n_fft)
        spec = torch.fft.rfft(frames * self.window, n=self.n_fft, dim=-1)
        power = spec.real * spec.real + spec.imag * spec.imag
        mel = torch.matmul(power, self.fb)
        db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
        db = torch.maximum(db, db.max() - 80.0)
        return torch.matmul(db, self.dct)


class LFBEncoder(nn.Module):
    """Learned filterbank (reference `cpc/model.py:128-155`): `conv`, a
    400-tap stride-1 convolution to 2 x dim channels, each pair's squared
    magnitude, a Hann smoothing (400 taps, stride 160, padding 350, one
    filter a channel), log1p of the magnitude and an instance norm over
    time without affine parameters. `conv` runs as one product over the
    input's windows (`conv_windows`), as the CPC encoder's first layer
    does, so that its weight gradient is the same on every call."""

    def __init__(self, dim_encoded: int, normalize: bool = True):
        super().__init__()
        self.size_hidden = dim_encoded
        self.normalize = normalize
        self.conv = nn.Conv1d(1, 2 * dim_encoded, LFB_TAPS, stride=1)
        han = np.hanning(LFB_TAPS + 1)[:-1].astype(np.float32)
        self.register_buffer("han", torch.from_numpy(han).reshape(
            1, 1, LFB_TAPS).expand(dim_encoded, 1, LFB_TAPS).contiguous(),
            persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x[:, None, :]
        y = conv_windows(x, self.conv)                     # (B, 2 dim, W)
        b, _, w = y.shape
        y = y.transpose(1, 2).reshape(b, w, self.size_hidden, 2)
        y = (y[..., 0] * y[..., 0] + y[..., 1] * y[..., 1]).transpose(1, 2)
        y = nn.functional.conv1d(y, self.han, stride=DOWNSAMPLING,
                                 padding=LFB_PAD, groups=self.size_hidden)
        y = torch.log1p(torch.abs(y))
        if self.normalize:
            mean = y.mean(dim=2, keepdim=True)
            var = y.var(dim=2, keepdim=True, unbiased=False)
            y = (y - mean) * torch.rsqrt(var + 1e-5)
        return y.transpose(1, 2)
