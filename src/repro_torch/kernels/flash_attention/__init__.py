"""Blockwise (flash) attention with an online softmax (replaces the Pallas
kernel ``repro.kernels.flash_attention``)."""
