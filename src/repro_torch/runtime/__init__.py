"""Fault tolerance of the torch port: ``coordinator`` (the counterpart of
``repro.runtime.coordinator``)."""
