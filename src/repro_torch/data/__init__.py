"""The synthetic LM data pipeline of the port (numpy only): a copy of
``repro.data.pipeline``."""
