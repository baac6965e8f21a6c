"""Serving runtime: scheduler and AccelServer (counterpart of
``repro.runtime``)."""
