"""Mamba-2 SSD chunked scan (replaces the Pallas kernel
``repro.kernels.ssd_scan``)."""
