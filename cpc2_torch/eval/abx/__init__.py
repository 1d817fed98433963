"""ABX discriminability: triplet iterators and the batched group scorer."""
