"""Command-line launchers (counterpart of ``repro.launch``)."""
