"""Fully-integer quantized matmul: plain version (ref) and the CUDA
kernel's entry point (ops)."""
