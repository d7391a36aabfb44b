"""The HBM-PIM command model's step (``repro.core.hbmpim.make_cmd_step``,
plain jnp in the JAX package) as one CUDA kernel, K commands per launch."""
