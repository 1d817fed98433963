"""Hand-written CUDA kernels of the training step, each beside its plain
PyTorch version: `lstm.fused_lstm`, `ffn.fused_ffn` and
`infonce.negative_scores`, built and loaded by `_build`."""
