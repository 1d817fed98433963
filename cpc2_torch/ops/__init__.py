"""Hand-written CUDA kernels, each beside its plain PyTorch version:
`lstm.fused_lstm`, `ffn.fused_ffn`, `infonce.negative_scores`,
`dtw.dtw_normalized`, `attention.fused_relpos_attention` and
`encoder.fused_encoder`, built and loaded by `_build`."""
