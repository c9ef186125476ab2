"""Parallelism: the spatial domain decomposition over a mesh of devices."""
