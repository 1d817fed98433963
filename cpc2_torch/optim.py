"""Adam with its first moment stored in bf16 (`--adam_mu_dtype bf16`).

Counterpart of `cpc2_tpu/training.py:make_optimizer`'s
`optax.inject_hyperparams(optax.adam)(..., mu_dtype=bfloat16)`. optax
takes the injected b1, b2, eps and learning rate as fp32 arrays, so per
element, each operation rounded to fp32:

    mu32 = (1 - b1) * g + b1 * float(mu)
    nu   = (1 - b2) * (g * g) + b2 * nu
    p    = p + ((mu32 / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)) * -lr
    mu   = bf16(mu32)

torch's Adam (fused or not) keeps `exp_avg` in the parameter's dtype and
updates it with `lerp`, so it cannot take this. `AdamBF16Moment` is a
`torch.optim.Adam` whose state keeps the keys of torch's (`step`,
`exp_avg` in bf16, `exp_avg_sq`), so that checkpoints keep the
reference's layout, and whose step is one hand-written multi-tensor
kernel (`csrc/adam.cu`, counter `adam_bf16_moment`) on a card and
`adam_bf16_plain` on the CPU. On a card the counts live there and the
bias corrections are computed there: a step is one `_foreach_add_` of the
counts and one call of the kernel (a launch per MAX_TENSORS tensors, 4
for the recipe's 204), which a CUDA graph (`training.MultiStep`)
replays.

A state dict loaded into it has its `exp_avg` cast to bf16 (torch casts
it to the parameter's dtype first), and one it saved loads into torch's
Adam, which casts `exp_avg` back to fp32: a run resumed under the other
`--adam_mu_dtype` takes the saved moment, rounded where it goes to bf16.
"""

from __future__ import annotations

import ctypes
from typing import List

import torch

from .ops import _build

Tensor = torch.Tensor

# the tensors one launch of the kernel takes (`csrc/adam.cu:kMaxTensors`)
MAX_TENSORS = 64


def adam_bf16_plain(params: List[Tensor], grads: List[Tensor],
                    mus: List[Tensor], nus: List[Tensor],
                    steps: List[Tensor], lr: float, b1: float, b2: float,
                    eps: float) -> None:
    """The kernel's update in plain PyTorch, in place, one fp32 operation
    at a time (as optax's arithmetic above). `steps` hold each tensor's
    count, already incremented for this step."""
    for p, g, mu, nu, step in zip(params, grads, mus, nus, steps):
        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=p.device)
        b1_, b2_, eps_ = f32(b1), f32(b2), f32(eps)
        t = step.to(device=p.device, dtype=torch.float32)
        bc1 = 1 - torch.pow(b1_, t)
        bc2 = 1 - torch.pow(b2_, t)
        m = (1 - b1_) * g + b1_ * mu.float()
        v = (1 - b2_) * (g * g) + b2_ * nu
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps_)
        p.add_(u * -f32(lr))
        mu.copy_(m.to(torch.bfloat16))
        nu.copy_(v)


def adam_bf16_moment(params: List[Tensor], grads: List[Tensor],
                     mus: List[Tensor], nus: List[Tensor],
                     steps: List[Tensor], lr: float, b1: float, b2: float,
                     eps: float) -> None:
    """One update of fp32 `params` from `grads`, bf16 first moments `mus`
    and fp32 second moments `nus`, in place; `steps` are the fp32 counts,
    already incremented. CUDA tensors go through the kernel, CPU tensors
    through `adam_bf16_plain`."""
    if not params:
        return
    if params[0].device.type == "cpu":
        adam_bf16_plain(params, grads, mus, nus, steps, lr, b1, b2, eps)
        return
    device = _build.check_cuda("adam_bf16_moment", *params, *grads, *mus,
                               *nus, *steps)
    _build.check_f32("adam_bf16_moment", *params, *grads, *nus, *steps)
    for p, g, mu, nu in zip(params, grads, mus, nus):
        if mu.dtype != torch.bfloat16:
            raise TypeError("adam_bf16_moment: the first moment is bf16")
        if not (p.is_contiguous() and g.is_contiguous()
                and mu.is_contiguous() and nu.is_contiguous()
                and p.shape == g.shape == mu.shape == nu.shape):
            raise ValueError("adam_bf16_moment: contiguous tensors of one "
                             "shape a parameter")
    n = len(params)

    def ptrs(ts):
        return (ctypes.c_long * n)(*(t.data_ptr() for t in ts))
    sizes = (ctypes.c_long * n)(*(p.numel() for p in params))
    # the C function launches once for each MAX_TENSORS tensors that are
    # not all empty
    launches = sum(any(sizes[i:i + MAX_TENSORS])
                   for i in range(0, n, MAX_TENSORS))
    _build.launch("adam_bf16_moment", "cpc2_adam_bf16_moment", device,
                  ptrs(params), ptrs(grads), ptrs(mus), ptrs(nus),
                  ptrs(steps), sizes, n, lr, b1, b2, eps, times=launches)


class AdamBF16Moment(torch.optim.Adam):
    """torch's Adam with optax's `mu_dtype=bfloat16` update (see the
    module's docstring). No weight decay, amsgrad or maximize, as the
    JAX package's Adam has none."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, lr=lr, betas=betas, eps=eps, foreach=False)

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for p, state in self.state.items():
            if "exp_avg" in state:
                state["exp_avg"] = state["exp_avg"].to(torch.bfloat16)
            if "step" in state:
                state["step"] = state["step"].to(self._step_device(p),
                                                 torch.float32)

    @staticmethod
    def _step_device(p: Tensor) -> torch.device:
        """The kernel reads the counts on the card: there they live beside
        the parameters."""
        return p.device if p.device.type == "cuda" else torch.device("cpu")

    def _state(self, p: Tensor) -> dict:
        state = self.state[p]
        if not state:
            state["step"] = torch.zeros((), dtype=torch.float32,
                                        device=self._step_device(p))
            state["exp_avg"] = torch.zeros_like(
                p, dtype=torch.bfloat16, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self._state(p) for p in params]
            steps = [s["step"] for s in states]
            torch._foreach_add_(steps, 1.0)
            b1, b2 = group["betas"]
            adam_bf16_moment(params, [p.grad for p in params],
                             [s["exp_avg"] for s in states],
                             [s["exp_avg_sq"] for s in states], steps,
                             float(group["lr"]), float(b1), float(b2),
                             float(group["eps"]))
        return loss
