"""The SIMT engine's cycle step as one CUDA kernel, K steps per launch, the
ALU inside (the step of ``repro.core.simt.make_step_traced``, whose ALU
is the jnp mirror of the Pallas kernel ``repro.kernels.alu_exec``); it
also runs the HBM-PIM all-bank compat target."""
