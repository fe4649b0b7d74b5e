"""The benchmark's traffic generators: frozen numpy copies of the port's
synthetic scenes, SEM resampling, voxelization and batch collation, and
the makers of serving pairs and training batches that read a traffic
file's parameters (pairs.py)."""
