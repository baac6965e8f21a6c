"""Compiler core: IR, reader, passes, writers, flow (counterpart of
``repro.core``)."""
