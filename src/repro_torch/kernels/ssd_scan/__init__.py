"""Mamba-2 SSD chunked scan: the hand-written kernel and its plain version."""
