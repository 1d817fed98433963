"""InfoNCE negative scoring with a hand-written CUDA kernel:
`neg[b, k, w, n] = preds[b, k, w, :] · z[idx[b, w, n], :]` (a raw dot; the
criterion divides by D).

Counterpart of `cpc2_tpu/ops/infonce_pallas.py:negative_scores_pallas`.
The TPU kernel keeps the whole pool resident and selects rows by one-hot
matmuls, so its cost grows with the pool; here (`csrc/infonce.cu`) one
block per (b, w) stages its K prediction rows and N indices in shared
memory and reads each sampled pool row once for all K dots, so the cost
does not depend on the pool size. The work is bound by operations (0.73
GFLOP forward at the recipe). The backward gives `dpreds` with the same
blocking and scatter-adds `dz` with fp32 atomics, whose order of summation
varies from run to run.

`negative_scores` launches the kernel for CUDA tensors and runs
`negative_scores_plain` for CPU tensors; there is no other path.
"""

from __future__ import annotations

import torch

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


class _NegativeScores(torch.autograd.Function):

    @staticmethod
    def forward(ctx, preds, z, idx):
        device = _check(preds, z, idx)
        preds, z, idx = preds.contiguous(), z.contiguous(), idx.contiguous()
        b, k, w, d = preds.shape
        n = idx.shape[2]
        out = torch.empty((b, k, w, n), device=device)
        _build.launch("infonce_fwd", "cpc2_infonce_fwd", device,
                      preds.data_ptr(), z.data_ptr(), idx.data_ptr(),
                      out.data_ptr(), b, k, w, n, d)
        ctx.save_for_backward(preds, z, idx)
        return out

    @staticmethod
    def backward(ctx, g):
        preds, z, idx = ctx.saved_tensors
        g = g.contiguous()
        b, k, w, d = preds.shape
        n = idx.shape[2]
        dpreds = torch.empty_like(preds)
        dz = torch.zeros_like(z)
        _build.launch("infonce_bwd", "cpc2_infonce_bwd", preds.device,
                      g.data_ptr(), preds.data_ptr(), z.data_ptr(),
                      idx.data_ptr(), dpreds.data_ptr(), dz.data_ptr(),
                      b, k, w, n, d)
        return dpreds, dz, None


def negative_scores(preds: Tensor, z: Tensor, idx: Tensor) -> Tensor:
    """neg[b, k, w, n] = preds[b, k, w, :] · z[idx[b, w, n], :].

    preds: (B, K, W, D) float32; z: (P, D) float32; idx: (B, W, N) int32
    rows of z, each in [0, P). Returns (B, K, W, N) float32. CUDA tensors
    go through the kernel, CPU tensors through `negative_scores_plain`."""
    if preds.device.type == "cpu":
        return negative_scores_plain(preds, z, idx)
    return _NegativeScores.apply(preds, z, idx)
