"""Training over processes: the mesh and its collectives (parallel/mesh.py),
the fsdp axis (parallel/fsdp.py)."""
