"""Tensor ops: fold-2 engine, its CUDA kernel, resampling, metrics."""
