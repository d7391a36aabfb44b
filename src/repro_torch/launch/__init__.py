"""Launchers of the torch port: ``train`` (the counterpart of
``repro.launch.train``, on one device; no mesh)."""
