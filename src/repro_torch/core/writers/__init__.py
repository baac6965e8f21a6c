"""Writers: the float reference ``torch`` target and the packed-weight
fully-integer ``qtorch`` target (counterpart of ``repro.core.writers``)."""
