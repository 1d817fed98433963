"""CPC2 on PyTorch and CUDA: Contrastive Predictive Coding on raw audio for
one NVIDIA Hopper card.

A port of the JAX package `cpc2_tpu`, which stays the reference it is held
against. This package imports `torch` and nothing of JAX or `cpc2_tpu`.
The three kernels of the training step's hot path (the LSTM recurrence, the
prediction heads' FFN and InfoNCE negative scoring) are hand-written CUDA
(`csrc/`), built on first use (`ops/_build.py`).

Run the trainer with `python -m cpc2_torch.train --pathDB ...`.
"""
