"""LM model code of the port (dense and ssm families): the counterpart of
``repro.models``.  Parameters are float32 in the JAX package's layout and
are cast to ``cfg.dtype`` where they are used."""
