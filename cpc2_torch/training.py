"""The training and validation step (counterpart of the forward of
`cpc2_tpu/training.py:build_steps`, reference `cpc/train.py:95-104`).

The step runs the encoder on `concat(past, future)`, the context network
on the past half only, and the criterion with the future half's encodings
as targets. The loss is the sum over the K heads of their mean losses; the
optimizer is Adam (or SGD with momentum 0.9) with the flags' settings,
whose update is optax's `adam` formula.
"""

from __future__ import annotations

import argparse
import contextlib
from typing import Callable, Optional, Tuple

import torch
from torch import nn

Tensor = torch.Tensor


def resolve_device(name: str) -> torch.device:
    """`cuda` (the default) must have a card behind it: the port never
    carries on on the CPU unless asked to."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run the plain versions)")
    return torch.device(name)


def set_precision(precision: str) -> None:
    """`fp32`: library matmuls and convolutions in full fp32. `bf16mix`:
    in TF32, the card's analogue of the TPU's single-pass default. The
    hand-written kernels compute in fp32 either way."""
    if precision not in ("fp32", "bf16mix"):
        raise NotImplementedError(f"--precision {precision}: not ported")
    tf32 = precision == "bf16mix"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


@contextlib.contextmanager
def full_fp32():
    """Library matmuls and convolutions in full fp32 inside the block,
    whatever `set_precision` chose, as the JAX package's feature extraction
    and ABX force `default_matmul_precision('highest')`."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def make_optimizer(args: argparse.Namespace, params) -> torch.optim.Optimizer:
    """Adam/SGD as `cpc2_tpu/training.py:make_optimizer` (reference
    `train.py:475-484`)."""
    if args.optimizer == 'adam':
        return torch.optim.Adam(params, lr=args.learningRate,
                                betas=(args.beta1, args.beta2),
                                eps=args.epsilon)
    if args.optimizer == 'sgd':
        return torch.optim.SGD(params, lr=args.learningRate, momentum=0.9)
    raise ValueError(f"Unsupported optimizer: {args.optimizer}")


def make_lr_schedule(learning_rate: float, scheduler_step: int,
                     scheduler_ramp: Optional[int]) -> Callable[[int], float]:
    """Per-epoch learning rate: the reference's StepLR(gamma=0.5) with an
    optional linear ramp, chained as torch chains them (a copy of
    `cpc2_tpu/utils/misc.py:make_lr_schedule`)."""

    def lr_fn(epoch: int) -> float:
        if scheduler_ramp is not None:
            if epoch <= scheduler_ramp:
                return learning_rate * (
                    1.0 if epoch >= scheduler_ramp
                    else (epoch + 1) / scheduler_ramp)
            if scheduler_step > 0:
                return learning_rate * 0.5 ** (
                    epoch // scheduler_step - scheduler_ramp // scheduler_step)
            return learning_rate
        if scheduler_step > 0:
            return learning_rate * 0.5 ** (epoch // scheduler_step)
        return learning_rate

    return lr_fn


class Trainer:
    """One model, its criterion and their optimizer on one device.

    `generator` draws the InfoNCE negatives, the dropout masks and the FFN
    kernel's dropout seeds. With `keep_hidden` (sequential sampling with a
    recurrent context network) the context network's final state is
    carried, detached, into the next batch of the same size."""

    def __init__(self, model: nn.Module, criterion: nn.Module,
                 optimizer: torch.optim.Optimizer,
                 generator: Optional[torch.Generator] = None,
                 keep_hidden: bool = False):
        self.model = model
        self.criterion = criterion
        self.optimizer = optimizer
        self.generator = generator
        self.keep_hidden = keep_hidden
        self._hidden = None

    def set_learning_rate(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group['lr'] = lr

    def _forward(self, batch: Tensor, negative_indices: Optional[Tensor],
                 carry: bool) -> Tuple[Tensor, Tensor]:
        b = batch.shape[0]
        encoded = self.model.gEncoder(
            torch.cat([batch[:, 0, 0, :], batch[:, 1, 0, :]], dim=0))
        hidden = self._hidden if carry else None
        if hidden is not None and _batch_of(hidden) != b:
            hidden = None
        c_feature, new_hidden = self.model.gAR(encoded[:b], hidden,
                                               self.generator)
        if carry and new_hidden is not None:
            self._hidden = _detach(new_hidden)
        return self.criterion(c_feature, encoded[b:], self.generator,
                              negative_indices)

    def train_step(self, batch: Tensor,
                   negative_indices: Optional[Tensor] = None
                   ) -> Tuple[Tensor, Tensor]:
        """One optimizer step on `batch` (B, 2, 1, W); returns the per-head
        (losses, accuracies), each (1, K - n_skipped), detached."""
        self.model.train()
        self.criterion.train()
        self.optimizer.zero_grad(set_to_none=True)
        losses, accs = self._forward(batch, negative_indices,
                                     self.keep_hidden)
        losses.sum().backward()
        self.optimizer.step()
        return losses.detach(), accs

    @torch.no_grad()
    def val_step(self, batch: Tensor,
                 negative_indices: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Tensor]:
        """The step's losses and accuracies in evaluation mode (no dropout,
        BatchNorm running statistics), without an update."""
        self.model.eval()
        self.criterion.eval()
        return self._forward(batch, negative_indices, False)


def _batch_of(hidden) -> int:
    return (hidden[0] if isinstance(hidden, tuple) else hidden).shape[1]


def _detach(hidden):
    if isinstance(hidden, tuple):
        return tuple(h.detach() for h in hidden)
    return hidden.detach()
