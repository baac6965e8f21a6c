"""Model parameter dictionaries (counterpart of ``repro.models``)."""
