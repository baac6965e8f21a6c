"""Direct depthwise conv, int8- and float-activation modes: plain versions
(ref) and the CUDA kernel's entry points (ops)."""
