"""Datasets (counterpart of ``repro.data``)."""
