"""Entry points (counterpart of ``repro.launch``)."""
