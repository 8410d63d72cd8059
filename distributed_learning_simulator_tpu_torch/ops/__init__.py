"""Tensor ops and the hand-written CUDA kernels they launch."""
