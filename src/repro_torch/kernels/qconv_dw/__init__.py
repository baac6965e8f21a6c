"""Fully-integer direct depthwise conv: plain version (ref) and the CUDA
kernel's entry point (ops)."""
