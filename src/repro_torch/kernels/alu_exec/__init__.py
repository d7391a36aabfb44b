"""The simulator's 12-way int32 ALU (replaces the Pallas kernel
``repro.kernels.alu_exec``)."""
