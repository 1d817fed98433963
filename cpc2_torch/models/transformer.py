"""Blockwise causal transformer used as the CPC prediction heads
(counterpart of `cpc2_tpu/models/transformer.py`, reference
`cpc/transformers.py`).

Attention is `torch.matmul` and softmax, or, with CPC2_FUSED_ATTENTION=1,
the CUDA kernel of `ops/attention.py`; the FFN runs through the CUDA kernels
of `ops/ffn.py`. A bf16 input (the prediction heads under `--precision
bf16`, `losses/criterion.py`) runs the JAX package's bf16 flow: the
linears and norms of `layers.py`, the logits, softmax and dropout in fp32
with p~ cast to bf16 for the product with v, bf16 residuals, and the FFN's
and the attention's bf16-in/bf16-out kernels. Module and parameter names follow the reference's
(`multihead.Wq.weight`, `ln_multihead.weight`, `ffnetwork.lin1.weight`,
`last_linear.weight`, ...), with the layers of a `TransformerAR` named
'0', '1', ... like an `nn.Sequential`.

Every `forward` takes an optional `torch.Generator` that draws the dropout
masks and the kernels' dropout seeds; dropout is active in training mode
only.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.attention import fused_relpos_attention, use_fused_attention
from ..ops.ffn import fused_ffn
from .layers import Dropout, LayerNorm, Linear

Tensor = torch.Tensor
Generator = Optional[torch.Generator]


def _dropout_seed(rate: float, generator: Generator,
                  device: torch.device) -> Tensor:
    """A kernel's int32 dropout seed, drawn from `generator` on `device`
    when the rate is nonzero (else 0)."""
    if rate > 0.0:
        return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=device, dtype=torch.int32)
    return torch.zeros((1,), device=device, dtype=torch.int32)


class ScaledDotProductAttention(nn.Module):
    """Causal attention over fixed blocks of `size_seq` steps, with the
    relative-position logits of the reference's zero-diagonal shift."""

    def __init__(self, size_seq: int, dk: int, dropout: float,
                 relpos: bool = False):
        super().__init__()
        self.size_seq = size_seq
        self.relpos = relpos
        if relpos:
            stdv = 1.0 / math.sqrt(dk)
            self.Krelpos = nn.Parameter(
                torch.empty(dk, size_seq).uniform_(-stdv, stdv))
        self.drop = Dropout(dropout)
        self.register_buffer(
            "mask", torch.triu(torch.full((size_seq, size_seq),
                                          float("-inf")), diagonal=1),
            persistent=False)

    def _prepare(self, x: Tensor) -> Tensor:
        # (N, S, k) -> zero-pad S to a multiple of size_seq, then fold the
        # blocks into the batch: (N * S/size_seq, size_seq, k).
        n, s, k = x.shape
        r = s % self.size_seq
        if r > 0:
            x = nn.functional.pad(x, (0, 0, 0, self.size_seq - r))
            s += self.size_seq - r
        return x.reshape(n * (s // self.size_seq), self.size_seq, k)

    def forward(self, q: Tensor, k: Tensor, v: Tensor,
                generator: Generator = None) -> Tensor:
        n, s_orig, dk = q.shape
        q, k, v = self._prepare(q), self._prepare(k), self._prepare(v)
        s = self.size_seq
        if self.relpos and use_fused_attention(s, dk):
            # the whole unit in one kernel (`ops/attention.py`), opt-in as
            # in the JAX package; its dropout seed comes from the generator
            rate = self.drop.rate if self.training else 0.0
            seed = _dropout_seed(rate, generator, q.device)
            out = fused_relpos_attention(q, k, v, self.Krelpos, seed, rate)
            return out.reshape(n, -1, dk)[:, :s_orig]
        # the logits, softmax and dropout in fp32 or wider (a bf16 q and k
        # cast up; fp32 and fp64 ones are themselves); p~ in v's dtype
        wide = torch.promote_types(q.dtype, torch.float32)
        q32 = q.to(wide)
        qk = torch.matmul(q32, k.to(wide).transpose(1, 2))
        if self.relpos:
            # rel[r, c] = q[r] . Krelpos[:, s-1-(r-c)] for c <= r: prepend a
            # zero column, view (S, S+1) as (S+1, S), drop the first row.
            bsz = q.shape[0]
            qp = torch.matmul(q32, self.Krelpos)
            qp = torch.cat([qp.new_zeros(bsz, s, 1), qp], dim=2)
            qk = qk + qp.reshape(bsz, s + 1, s)[:, 1:, :]
        a = torch.softmax(qk / math.sqrt(dk) + self.mask, dim=2)
        a = self.drop(a, generator)
        out = torch.matmul(a.to(v.dtype), v)
        return out.reshape(n, -1, dk)[:, :s_orig]


class MultiHeadAttention(nn.Module):
    """`transformers.py:73-104`."""

    def __init__(self, size_seq: int, dropout: float, dmodel: int,
                 nheads: int, abspos: bool):
        super().__init__()
        self.nheads = nheads
        self.dk = dmodel // nheads
        self.Wq = Linear(dmodel, dmodel, bias=False)
        self.Wk = Linear(dmodel, dmodel, bias=False)
        self.Wv = Linear(dmodel, dmodel, bias=False)
        self.Wo = Linear(dmodel, dmodel, bias=False)
        self.Att = ScaledDotProductAttention(size_seq, self.dk, dropout,
                                             relpos=not abspos)

    def _split(self, x: Tensor) -> Tensor:
        b, t, _ = x.shape
        return (x.reshape(b, t, self.nheads, self.dk).transpose(1, 2)
                .reshape(b * self.nheads, t, self.dk))

    def forward(self, q: Tensor, k: Tensor, v: Tensor,
                generator: Generator = None) -> Tensor:
        y = self.Att(self._split(self.Wq(q)), self._split(self.Wk(k)),
                     self._split(self.Wv(v)), generator)
        bh, t, _ = y.shape
        b = bh // self.nheads
        y = (y.reshape(b, self.nheads, t, self.dk).transpose(1, 2)
             .reshape(b, t, self.nheads * self.dk))
        return self.Wo(y)


class FFNetwork(nn.Module):
    """`transformers.py:107-116`: lin1 -> ReLU -> dropout -> lin2, run by
    the FFN kernels (`ops/ffn.py`), whose dropout seed is drawn from the
    generator on the input's device. Under `bf16mix` (TF32 library matmuls,
    `training.set_precision`) the FFN takes its bf16 route, as the JAX
    package's kernel takes single-pass bf16 products; under `fp32` and
    inside `training.full_fp32()` its fp32 route. A bf16 input takes the
    bf16 route's bf16-in/bf16-out kernels."""

    def __init__(self, din: int, dout: int, dff: int, dropout: float):
        super().__init__()
        self.lin1 = nn.Linear(din, dff)
        self.lin2 = nn.Linear(dff, dout)
        self.dropout = dropout

    def forward(self, x: Tensor, generator: Generator = None) -> Tensor:
        rate = self.dropout if self.training else 0.0
        seed = _dropout_seed(rate, generator, x.device)
        lead = x.shape[:-1]
        bf16 = (torch.backends.cuda.matmul.allow_tf32
                or x.dtype == torch.bfloat16)
        y = fused_ffn(x.reshape(-1, x.shape[-1]), self.lin1.weight,
                      self.lin1.bias, self.lin2.weight, self.lin2.bias, seed,
                      rate, bf16=bf16)
        return y.reshape(*lead, y.shape[-1])


class TransformerLayer(nn.Module):
    """Post-LN block with a dimension-reducing output projection
    (`transformers.py:119-134`)."""

    def __init__(self, size_seq: int = 32, dmodel: int = 512,
                 dout: int = 512, dff: int = 2048, dropout: float = 0.1,
                 nheads: int = 8, abspos: bool = False):
        super().__init__()
        self.multihead = MultiHeadAttention(size_seq, dropout, dmodel,
                                            nheads, abspos)
        self.ln_multihead = LayerNorm(dmodel)
        self.ffnetwork = FFNetwork(dmodel, dmodel, dff, dropout)
        self.last_linear = Linear(dmodel, dout)
        self.ln_ffnetwork = LayerNorm(dout)

    def forward(self, x: Tensor, generator: Generator = None) -> Tensor:
        y = self.ln_multihead(x + self.multihead(x, x, x, generator))
        ff = self.ffnetwork(y, generator)
        return self.ln_ffnetwork(self.last_linear(y + ff))


class MultiClassifierTransformerHead(nn.Module):
    """One attention trunk and one FFN for K classifiers
    (`transformers.py:137-158`): the FFN is `dmodel -> dff -> dmodel * K`,
    one call of the FFN kernels for all K heads. Output (B, S, K, dout)."""

    def __init__(self, nclassifiers: int, size_seq: int = 32,
                 dmodel: int = 512, dout: int = 512, dff: int = 2048,
                 dropout: float = 0.1, nheads: int = 8,
                 abspos: bool = False):
        super().__init__()
        self.nclassifiers = nclassifiers
        self.multihead = MultiHeadAttention(size_seq, dropout, dmodel,
                                            nheads, abspos)
        self.ln_multihead = LayerNorm(dmodel)
        self.ffnetwork = FFNetwork(dmodel, dmodel * nclassifiers, dff,
                                   dropout)
        self.last_linear = Linear(dmodel, dout)
        self.ln_ffnetwork = LayerNorm(dout)

    def forward(self, x: Tensor, generator: Generator = None) -> Tensor:
        y = self.ln_multihead(x + self.multihead(x, x, x, generator))
        b, s, d = y.shape
        ff = self.ffnetwork(y, generator).reshape(b, s, self.nclassifiers, d)
        return self.ln_ffnetwork(self.last_linear(ff + y[:, :, None, :]))


class StaticPositionEmbedding(nn.Module):
    """Sinusoidal positions (`transformers.py:161-173`)."""

    def __init__(self, seqlen: int, dmodel: int):
        super().__init__()
        pos = torch.arange(seqlen, dtype=torch.float64)[:, None]
        dim = torch.arange(dmodel, dtype=torch.float64)[None, :]
        pe = pos * torch.exp(-math.log(10000.0) * (2 * (dim // 2) / dmodel))
        pe[:, 0::2] = torch.sin(pe[:, 0::2])
        pe[:, 1::2] = torch.cos(pe[:, 1::2])
        self.register_buffer("pe", pe.float(), persistent=False)

    def forward(self, x: Tensor, generator: Generator = None) -> Tensor:
        return x + self.pe[None, :x.shape[1], :].to(x.dtype)


class TransformerAR(nn.Sequential):
    """`buildTransformerAR` (`transformers.py:176-187`): an optional static
    position embedding, then `n_layers` transformer layers, named '0',
    '1', ... `forward(x, hidden, generator)` returns `(y, None)`."""

    def __init__(self, dim_encoded: int, dim_ar: int, n_layers: int,
                 size_seq: int, abspos: bool = False):
        layers = []
        if abspos:
            layers.append(StaticPositionEmbedding(size_seq, dim_ar))
        layers += [TransformerLayer(size_seq=size_seq, dmodel=dim_ar,
                                    dout=dim_encoded, abspos=abspos)
                   for _ in range(n_layers)]
        super().__init__(*layers)

    def forward(self, x: Tensor, hidden=None, generator: Generator = None):
        for layer in self:
            x = layer(x, generator)
        return x, None


class MultiHeadTransformerAR(nn.Sequential):
    """`buildMultHeadTransformerAR` (`transformers.py:190-212`): an optional
    static position embedding, `n_layers - 1` transformer layers and a
    `MultiClassifierTransformerHead`, named '0', '1', ... `forward(x,
    generator)` returns (B, S, n_heads_out, dim_encoded)."""

    def __init__(self, dim_encoded: int, dim_ar: int, n_layers: int,
                 size_seq: int, n_heads_out: int, abspos: bool = False):
        layers = []
        if abspos:
            layers.append(StaticPositionEmbedding(size_seq, dim_ar))
        layers += [TransformerLayer(size_seq=size_seq, dmodel=dim_ar,
                                    dout=dim_encoded, abspos=abspos)
                   for _ in range(n_layers - 1)]
        layers.append(MultiClassifierTransformerHead(
            n_heads_out, size_seq=size_seq, dmodel=dim_ar, dout=dim_encoded,
            abspos=abspos))
        super().__init__(*layers)

    def forward(self, x: Tensor, generator: Generator = None) -> Tensor:
        for layer in self:
            x = layer(x, generator)
        return x


def build_transformer_ar(dim_encoded: int, dim_ar: int, n_layers: int,
                         size_seq: int, abspos: bool) -> TransformerAR:
    return TransformerAR(dim_encoded, dim_ar, n_layers, size_seq, abspos)
