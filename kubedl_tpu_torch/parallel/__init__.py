"""Parallelism of the port: the mesh layout (``mesh``), the logical
sharding rules and placements (``sharding``), the collectives sharded
training runs (``collectives``), ring and Ulysses attention (``ring``,
``ulysses``), the pipeline schedules (``pipeline``) and a local launcher
of process-group ranks (``launch``)."""
