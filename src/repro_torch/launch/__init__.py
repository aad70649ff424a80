"""repro_torch.launch — the port of ``repro.launch``: the serving
launcher (``python -m repro_torch.launch.serve``). The mesh, training,
dry-run and roofline launchers follow in later slices."""
