"""Optimizers (counterpart of ``repro.optim``)."""
