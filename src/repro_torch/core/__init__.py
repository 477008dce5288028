"""Consensus core: schedules, the method registry, the flat engine and the
method lowering (counterpart of ``repro.core``)."""
