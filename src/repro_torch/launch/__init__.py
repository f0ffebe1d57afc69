"""Launch layer (the port of ``repro/launch``) on ``torch.distributed``:
device meshes (``mesh``), the sharding rules (``shardings``; the DTensor
placements that carry them out are ``core.placement``'s), the dry run's shape stand-ins (``specs``), collective
statistics (``hlo_stats``), the dry run, roofline and flags harness
(``dryrun``, ``roofline``, ``perf``), and the serving and training
drivers (``python -m repro_torch.launch.serve`` / ``.train``, each with
``--mesh DATAxMODEL``)."""
