"""The simulator's cycle step as one CUDA kernel, K steps per launch, the
ALU inside (absorbs the Pallas kernel ``repro.kernels.alu_exec`` into
``repro.core.engine.make_step_traced``)."""
