"""Parallelism: the spatial domain decomposition over a mesh of devices, held
by one process or by several (``multihost.py``)."""
