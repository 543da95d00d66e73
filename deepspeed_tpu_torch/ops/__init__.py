"""Operators of the port: attention, quantization and the CUDA kernels."""
