"""Launchers of the torch port (the counterpart of ``repro.launch``):
``train`` (the training CLI, on one device; no mesh), ``dryrun`` (every
cell counted on the meta device by ``cost`` and priced on one H100 by
``roofline``; its inputs from ``specs``) and ``mesh`` (device meshes over
``torch.distributed`` process groups)."""
