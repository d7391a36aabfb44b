"""Architecture and shape configurations (copies of ``repro.configs``
with the import prefix changed): ``base.get_config(arch_id)``."""
