"""Serving of the port: :class:`repro_torch.serve.engine.ServeEngine`."""
