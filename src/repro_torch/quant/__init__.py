"""Numerics core: qtypes, fixed point, PTQ and packed weights (counterpart
of ``repro.quant``)."""
