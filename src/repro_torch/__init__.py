"""PyTorch/CUDA port of the PIMulator (``repro``), for NVIDIA Hopper.

Module paths mirror the JAX package ``repro``: ``repro_torch.core.engine``
is the counterpart of ``repro.core.engine``, and so on.  The port imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.  Its entry
points (``PIMSystem``, ``compile_cache.run``, ``engine.run``) run on the
CUDA card unless the caller passes ``device="cpu"``.
"""
