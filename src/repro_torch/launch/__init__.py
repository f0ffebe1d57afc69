"""Launch drivers (the port of ``repro/launch``): the serving driver
``python -m repro_torch.launch.serve`` and the training driver
``python -m repro_torch.launch.train``.  The mesh, shardings, dry run and
roofline of the reference's ``launch/`` are ROADMAP item 14.5."""
