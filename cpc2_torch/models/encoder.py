"""The strided convolutional waveform encoder (counterpart of
`cpc2_tpu/models/encoder.py`, reference `cpc/model.py:27-108`).

The convolutions are `nn.Conv1d` in PyTorch's NCW layout on cuDNN (the
first, with its one input channel, as one product over the input's
windows: see `conv_windows`), or, with CPC2_FUSED_ENCODER=1, the CUDA
kernels of `ops/encoder.py`, which run the whole stack; the public output
is `(B, frames, C)`, the JAX package's layout.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.encoder import fused_encoder, use_fused_encoder

DOWNSAMPLING = 160

# (kernel, stride, padding) per layer of the strided conv stack.
CONV_STACK = ((10, 5, 3), (8, 4, 2), (4, 2, 1), (4, 2, 1), (4, 2, 1))

NORM_MODES = ("batchNorm", "instanceNorm", "ID", "layerNorm")


def encoded_seq_len(size_window: int) -> int:
    """Number of encoded frames produced for a raw window of `size_window`."""
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
