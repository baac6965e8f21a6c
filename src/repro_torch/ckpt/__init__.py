"""Checkpointing (counterpart of ``repro.ckpt``)."""
