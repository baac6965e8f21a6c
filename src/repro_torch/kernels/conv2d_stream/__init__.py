"""Streaming line-buffer convolution of the stream target."""
