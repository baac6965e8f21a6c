"""Writers: the float reference ``torch`` target, the streaming ``stream``
target and the packed-weight ``qtorch`` target (counterpart of
``repro.core.writers``)."""
