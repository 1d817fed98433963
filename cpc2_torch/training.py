"""The training and validation step (counterpart of the forward of
`cpc2_tpu/training.py:build_steps`, reference `cpc/train.py:95-104`).

The step runs the encoder on `concat(past, future)`, the context network
on the past half only, and the criterion with the future half's encodings
as targets (the CPC criterion) or beside the labels (a supervised one,
`--supervised`). `--mask_prob` writes the model's `mask_emb` into the
context network's input at the masked frames of the past half; the BERT
model (`--cpc_mode bert`) keeps the JAX package's single forward over both
views, its masked blocks zeroed, and pairs the past half's context and
mask with the future half's encodings. The loss is the sum over the K
heads of their mean losses (`--cpc_mode none`: a constant, and every
gradient 0, as JAX differentiates it);
the optimizer is Adam (or SGD with momentum 0.9) with the flags' settings,
whose update is optax's `adam` formula.

`MultiStep` runs N steps per call (`--steps_per_dispatch`, counterpart of
`cpc2_tpu/training.py:build_multi_step`): on a card, one replay of a CUDA
graph of the N steps.

Under ranks (`parallel.DataParallel`, `--nGPU`/`--distributed`) each step
averages the gradients, losses, accuracies and BatchNorm statistics over
the ranks, as the JAX step `pmean`s them over its data mesh; the weighted
step (`example_weights`, the ranks' padded tails) divides by the weights'
sum over the ranks and sums the gradients (`cpc2_tpu/training.py:280-330`).
"""

from __future__ import annotations

import argparse
import contextlib
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from .losses.bert import CPCBertCriterion
from .losses.criterion import CTCPhoneCriterion, SupervisedCriterion
from .models.cpc import CPCBertModel
from .ops import _build
from .optim import AdamBF16Moment

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
    in TF32, the card's analogue of the TPU's single-pass default, and the
    head FFN's kernels (`ops/ffn.py`) in bf16 products with fp32 sums, as
    the JAX package's FFN kernel under that precision; the opt-in encoder
    kernel runs under `bf16mix` and `bf16` only. The other hand-written
    kernels compute in fp32 either way. `bf16` sets the same switches as
    `bf16mix` (as the JAX package's `'bfloat16'` matmul precision is the
    TPU's default): what it adds, the transformer heads' bf16
    activations, the criterion carries (`head_dtype`, built from
    `--precision`)."""
    if precision not in ("fp32", "bf16mix", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    tf32 = precision != "fp32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


@contextlib.contextmanager
def precision(name: str):
    """`set_precision(name)` inside the block; the switches it sets are
    restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    set_precision(name)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def full_fp32():
    """Library matmuls and convolutions (and the FFN kernels) in full fp32
    inside the block, whatever `set_precision` chose, as the JAX package's
    feature extraction and ABX force `default_matmul_precision('highest')`."""
    return precision("fp32")


def make_optimizer(args: argparse.Namespace, params,
                   capturable: bool = False) -> torch.optim.Optimizer:
    """Adam/SGD as `cpc2_tpu/training.py:make_optimizer` (reference
    `train.py:475-484`). `capturable` (every training run on a card, so
    that a `MultiStep` graph and a single step update alike): torch's
    fused Adam, which keeps its step count on the device and computes the
    bias corrections there, in fp32, in one multi-tensor kernel, so that a
    CUDA graph can replay its update (the unfused capturable route spends
    about 400 tiny launches a step on them). `--adam_mu_dtype bf16`:
    `optim.AdamBF16Moment`, optax's update with a bf16 first moment, whose
    counts follow the parameters' device whatever `capturable` says."""
    if args.optimizer == 'adam' and getattr(args, 'adam_mu_dtype',
                                            'fp32') == 'bf16':
        return AdamBF16Moment(params, lr=args.learningRate,
                              betas=(args.beta1, args.beta2),
                              eps=args.epsilon)
    if args.optimizer == 'adam':
        return torch.optim.Adam(params, lr=args.learningRate,
                                betas=(args.beta1, args.beta2),
                                eps=args.epsilon, capturable=capturable,
                                fused=True if capturable else None)
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
    carried, detached, into the next batch of the same size.

    `device_augment = (chain, augment_past, augment_future,
    past_equal_future)` augments the training steps' views on the device
    before the encoder (`data/augment_device.py`, `--augment_on_device`):
    the future view takes draws of its own unless `past_equal_future`.
    They come from `augment_generator`, a generator of their own on the
    device, so that the negatives and dropout draws are the same with
    augmentation on or off (the JAX package keys them with
    `fold_in(key, 3)`).

    A supervised criterion (`losses/criterion.py:SupervisedCriterion`)
    takes the steps' `label` (the past views' speakers or phones) in place
    of the negatives. The steps' `mask` (2B, S), drawn on the host, is the
    `--mask_prob` span mask or the BERT block mask of both views; `quality`
    (B, Q) weights the CPC criterion's losses (`--signal_quality_path`).

    `dp` (a `parallel.DataParallel`, or None for one process): the rank
    this trainer runs as; its steps reduce over the ranks, and with
    `global_negatives` the CPC criterion draws over the pool gathered from
    every rank. Under ranks the gradients live in `grad_buffers`
    (`DataParallel.bind_gradients`), one flat buffer a dtype.
    `alone(generator, augment_generator)` runs steps on the rank's batch
    alone, without the gathered pool, drawing from generators that every
    rank holds alike (the tail that every rank runs whole,
    `train_tails.TailRunner`); their reductions stay, so that the ranks
    hold one replica whatever each card computes."""

    def __init__(self, model: nn.Module, criterion: nn.Module,
                 optimizer: torch.optim.Optimizer,
                 generator: Optional[torch.Generator] = None,
                 keep_hidden: bool = False, device_augment=None,
                 augment_generator: Optional[torch.Generator] = None,
                 dp=None, global_negatives: bool = False):
        self.model = model
        self.criterion = criterion
        self.optimizer = optimizer
        self.generator = generator
        self.keep_hidden = keep_hidden
        self.device_augment = device_augment
        self.augment_generator = augment_generator
        self.supervised = isinstance(criterion, SupervisedCriterion)
        self.dp = dp
        self.global_negatives = global_negatives
        self.grad_buffers = (None if dp is None else dp.bind_gradients(
            p for group in optimizer.param_groups for p in group['params']))
        self._hidden = None

    @contextlib.contextmanager
    def alone(self, generator: Optional[torch.Generator],
              augment_generator: Optional[torch.Generator]):
        """Steps inside the block draw from `generator` and
        `augment_generator` and score over the rank's batch alone (no
        gathered pool)."""
        saved = self.generator, self.augment_generator, self.global_negatives
        self.generator, self.augment_generator = generator, augment_generator
        self.global_negatives = False
        try:
            yield
        finally:
            (self.generator, self.augment_generator,
             self.global_negatives) = saved

    def set_learning_rate(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group['lr'] = lr

    def _augment(self, past: Tensor, future: Tensor
                 ) -> Tuple[Tensor, Tensor]:
        """The views through the device chain, as
        `cpc2_tpu/training.py:175-182`."""
        chain, aug_past, aug_future, same = self.device_augment
        b, w = past.shape
        draws = None
        if aug_past:
            draws = chain.draw(b, w, self.augment_generator)
            past = chain.apply(past, draws)
        if aug_future:
            if draws is None or not same:
                draws = chain.draw(b, w, self.augment_generator)
            future = chain.apply(future, draws)
        return past, future

    def _forward(self, batch: Tensor, negative_indices: Optional[Tensor],
                 carry: bool, train: bool = False,
                 label: Optional[Tensor] = None,
                 mask: Optional[Tensor] = None,
                 quality: Optional[Tensor] = None,
                 example_weights: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Tensor]:
        b = batch.shape[0]
        past, future = batch[:, 0, 0, :], batch[:, 1, 0, :]
        if train and self.device_augment is not None:
            past, future = self._augment(past, future)
        encoded = self.model.encode(torch.cat([past, future], dim=0))
        if isinstance(self.model, CPCBertModel):
            # `cpc2_tpu/training.py:550-566`: the context of both views,
            # the masked blocks zeroed; the past's context and mask, the
            # future's encodings
            c_feature, _ = self.model.context(
                self.model.mask(encoded, mask), None, self.generator)
            c_feature = c_feature[:b]
        else:
            hidden = self._hidden if carry else None
            if hidden is not None and _batch_of(hidden) != b:
                hidden = None
            ar_input = encoded[:b]
            if mask is not None and hasattr(self.model, 'mask'):
                ar_input = self.model.mask(ar_input, mask[:b])
            c_feature, new_hidden = self.model.context(ar_input, hidden,
                                                       self.generator)
            if carry and new_hidden is not None:
                self._hidden = _detach(new_hidden)
        weights = ({} if example_weights is None
                   else {"example_weights": example_weights})
        if self.supervised:
            return self.criterion(c_feature, encoded[b:], label, **weights)
        if isinstance(self.criterion, CPCBertCriterion):
            if mask is None:
                raise ValueError("the BERT criterion scores the masked "
                                 "frames: the step needs its mask")
            return self.criterion(c_feature, encoded[b:], mask[:b],
                                  self.generator, negative_indices,
                                  **weights)
        pool = (self.dp if self.global_negatives and self.dp is not None
                and self.dp.world > 1 else None)
        return self.criterion(c_feature, encoded[b:], self.generator,
                              negative_indices, quality, pool=pool,
                              **weights)

    def _weight_total(self, example_weights: Optional[Tensor]
                      ) -> Optional[Tensor]:
        """The weights' sum over the ranks (at least 1e-9), or None."""
        if example_weights is None:
            return None
        total = example_weights.float().sum()
        if self.dp is not None:
            total = self.dp.all_reduce(total.reshape(1))[0]
        return total.clamp_min(1e-9)

    def _metrics(self, losses: Tensor, accs: Tensor,
                 total: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
        """The step's losses and accuracies over the ranks: their mean, or
        with weights their sum over the total weight; in one
        `all_reduce`."""
        if self.dp is None and total is None:
            return losses, accs
        both = torch.cat([losses.detach().float(), accs.detach().float()])
        if self.dp is not None:
            both = self.dp.all_reduce(both.clone())
        both = both / (self.dp.world if total is None and self.dp is not None
                       else total)
        return both[:losses.shape[0]], both[losses.shape[0]:]

    def train_step(self, batch: Tensor,
                   negative_indices: Optional[Tensor] = None,
                   label: Optional[Tensor] = None,
                   mask: Optional[Tensor] = None,
                   quality: Optional[Tensor] = None,
                   example_weights: Optional[Tensor] = None
                   ) -> Tuple[Tensor, Tensor]:
        """One optimizer step on `batch` (B, 2, 1, W); returns the per-head
        (losses, accuracies), each (1, K - n_skipped), or a supervised
        criterion's (1, 1) on `label`, detached. A parameter the loss does
        not reach (all of them under `--cpc_mode none`) steps on a zero
        gradient, as in the JAX package, whose gradients are dense.

        Under ranks the gradients, metrics and BatchNorm statistics are
        averaged over them. With `example_weights` (B,) (0 on a padded
        row) the step is the exact mean over the real examples of every
        rank: the criterion's weighted sums over the weights' total, the
        gradients summed over the ranks, the statistics averaged over the
        ranks that hold a real row."""
        self.model.train()
        self.criterion.train()
        # under ranks the gradients stay views of `grad_buffers`
        self.optimizer.zero_grad(set_to_none=self.dp is None)
        total = self._weight_total(example_weights)
        losses, accs = self._forward(batch, negative_indices,
                                     self.keep_hidden, train=True,
                                     label=label, mask=mask, quality=quality,
                                     example_weights=example_weights)
        objective = losses.sum() if total is None else losses.sum() / total
        if objective.requires_grad:
            objective.backward()
        params = [p for group in self.optimizer.param_groups
                  for p in group['params']]
        for p in params:
            if p.grad is None and p.requires_grad:
                p.grad = torch.zeros_like(p)
        if self.dp is not None:
            self.dp.reduce_gradients(self.grad_buffers, mean=total is None)
            self.dp.reduce_batch_stats(
                (self.model, self.criterion), None if example_weights is None
                else (example_weights.sum() > 0))
        losses, accs = self._metrics(losses.detach(), accs, total)
        self.optimizer.step()
        return losses, accs

    @torch.no_grad()
    def val_step(self, batch: Tensor,
                 negative_indices: Optional[Tensor] = None,
                 label: Optional[Tensor] = None,
                 mask: Optional[Tensor] = None,
                 quality: Optional[Tensor] = None,
                 example_weights: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Tensor]:
        """The step's losses and accuracies in evaluation mode (no dropout,
        BatchNorm running statistics), without an update; averaged over
        the ranks, or with `example_weights` weighted as `train_step`'s."""
        self.model.eval()
        self.criterion.eval()
        total = self._weight_total(example_weights)
        losses, accs = self._forward(batch, negative_indices, False,
                                     label=label, mask=mask, quality=quality,
                                     example_weights=example_weights)
        return self._metrics(losses, accs, total)


def dispatch_route(device: torch.device, criterion: nn.Module,
                   dp=None) -> str:
    """`MultiStep`'s route: `graph` on a CUDA device unless the criterion
    copies to the host (`--CTC`) or the ranks reduce over `gloo`, whose
    collectives a CUDA graph cannot capture (NCCL's it can), else
    `eager`."""
    if device.type == "cuda" and not isinstance(criterion, CTCPhoneCriterion) \
            and (dp is None or dp.backend == "nccl"):
        return "graph"
    return "eager"


class MultiStep:
    """`n_inner` optimizer steps of `trainer` a call
    (`--steps_per_dispatch`): `multi_step(inputs, labels, quality, masks)`
    returns the steps' (losses (N, K), accs (N, K)) on the device.
    `inputs` are (N, B) window offsets into `corpus`'s resident pack
    (`data/device_corpus.py`), whose steps gather their batches on the
    device, or without a corpus the (N, B, 2, 1, W) batches; `labels` (N,
    ...) are the batches' labels, which a supervised criterion takes;
    `quality` (N, B, Q) and `masks` (N, 2B, S), where the run has them,
    each step's signal quality and mask. On
    the graph route the returned tensors are the graph's outputs, which
    the next call overwrites.

    `route` is `graph` on a CUDA device: the N steps (gather, device
    augmentation, forward, backward, optimizer step) are captured into one
    `torch.cuda.CUDAGraph`, and a call is a copy of the inputs into static
    buffers and one replay. The run's first call is the warm-up (lazy
    library handles and workspaces): its N steps run eagerly, on the
    capture's side stream, as real steps. The graph is captured at the
    next call and again whenever a group's learning rate changes (the
    graph holds the rate it was captured with) or the corpus gets a new
    slab. The trainer's generators (negatives and dropout, device
    augmentation) are registered with the graph, so that a replay draws
    what N eager steps draw and leaves the generators where they would.
    The optimizer must be capturable (`make_optimizer`). The kernels'
    launch counts (`ops/_build.py:LAUNCHES`) taken at the capture are
    added at every replay: a replay launches nothing from Python.

    Under NCCL ranks the steps' all-reduces are captured with them, so a
    replay reduces as N eager steps do.

    `route` is `eager` on the CPU, for a criterion that copies to the
    host (`--CTC`: torch's CUDA `ctc_loss` reads its lengths there) and
    under `gloo` ranks: the N steps run one after another, the losses
    copied once per call."""

    def __init__(self, trainer: Trainer, n_inner: int, corpus=None):
        self.trainer = trainer
        self.n_inner = n_inner
        self.corpus = corpus
        self.device = next(trainer.model.parameters()).device
        self.route = dispatch_route(self.device, trainer.criterion,
                                    trainer.dp)
        self.launches = {}        # a replay's kernel launches
        self.captures = 0
        self._graph = None
        self._warm = False
        self._stream = (torch.cuda.Stream(self.device)
                        if self.route == "graph" else None)
        self._static = None       # inputs, labels, quality, masks
        self._out = None
        self._lrs = None
        self._slab = None

    def _steps(self, inputs: Tensor, labels: Optional[Tensor],
               quality: Optional[Tensor] = None,
               masks: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        trainer, out = self.trainer, []
        for i in range(self.n_inner):
            batch = (self.corpus.put(inputs[i]) if self.corpus is not None
                     else inputs[i])
            label = labels[i] if trainer.supervised else None
            out.append(trainer.train_step(
                batch, label=label,
                quality=None if quality is None else quality[i],
                mask=None if masks is None else masks[i]))
        return (torch.cat([losses for losses, _ in out]),
                torch.cat([accs for _, accs in out]))

    def __call__(self, inputs: Tensor, labels: Optional[Tensor] = None,
                 quality: Optional[Tensor] = None,
                 masks: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        if labels is not None and not self.trainer.supervised:
            labels = None
        given = (inputs, labels, quality, masks)
        if self.route == "eager":
            return self._steps(*(None if t is None else
                                 t.to(self.device, non_blocking=True)
                                 for t in given))
        if not self._warm:
            current = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                out = self._steps(*(None if t is None else
                                    t.to(self.device, non_blocking=True)
                                    for t in given))
            current.wait_stream(self._stream)
            torch.cuda.synchronize(self.device)
            self._warm = True
            return out
        if self._static is None:
            self._static = tuple(
                None if t is None else torch.empty(
                    t.shape, dtype=t.dtype, device=self.device)
                for t in given)
        lrs = [group['lr'] for group in self.trainer.optimizer.param_groups]
        slab = None if self.corpus is None else self.corpus.resident
        if self._graph is None or lrs != self._lrs or slab is not self._slab:
            self._capture(lrs, slab)
        for static, t in zip(self._static, given):
            if static is not None:
                static.copy_(t, non_blocking=True)
        self._graph.replay()
        for name, n in self.launches.items():
            _build.LAUNCHES[name] += n
        return self._out

    def _capture(self, lrs, slab) -> None:
        """Capture the N steps on the static inputs (nothing runs); the
        graph before it, if any, is dropped first."""
        self._graph = self._out = None
        graph = torch.cuda.CUDAGraph()
        for gen in (self.trainer.generator, self.trainer.augment_generator):
            if gen is not None:
                graph.register_generator_state(gen)
        before = dict(_build.LAUNCHES)
        # thread_local: the loader's thread pins memory meanwhile
        with torch.cuda.graph(graph, stream=self._stream,
                              capture_error_mode="thread_local"):
            out = self._steps(*self._static)
        self.launches = {name: _build.LAUNCHES[name] - before[name]
                         for name in before
                         if _build.LAUNCHES[name] != before[name]}
        _build.LAUNCHES.update(before)
        self._graph, self._out = graph, out
        self._lrs, self._slab = lrs, slab
        self.captures += 1


def _batch_of(hidden) -> Optional[int]:
    """The batch of a state: a tensor (L, B, H), an LSTM's (h, c), or a
    concatenated model's list of those (None for a model without one)."""
    if isinstance(hidden, list):
        return next((n for n in map(_batch_of, hidden) if n is not None),
                    None)
    if hidden is None:
        return None
    return (hidden[0] if isinstance(hidden, tuple) else hidden).shape[1]


def _detach(hidden):
    if isinstance(hidden, list):
        return [_detach(h) for h in hidden]
    if isinstance(hidden, tuple):
        return tuple(h.detach() for h in hidden)
    return None if hidden is None else hidden.detach()
