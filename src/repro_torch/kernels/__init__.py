"""Hand-written Hopper kernels of the port, one folder per kernel of
``repro.kernels``: CUDA sources under ``csrc/``, the plain-torch version
in ``ref.py`` and the dispatching wrapper in ``ops.py``."""
