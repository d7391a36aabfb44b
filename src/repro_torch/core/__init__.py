"""The simulator core: ISA + assembler, the cycle engine, its driver and
backends, the host runtime and the derived statistics."""
