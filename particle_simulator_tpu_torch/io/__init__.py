"""The port's own wire codec and transport: copies of the JAX package's
``particle_simulator_tpu/io`` modules (``frame``, ``transport``, ``presets``,
``native``), so the port imports nothing of that package. The wire format is
frozen; ``tests/test_torch_io.py`` holds the copies byte for byte against
the originals."""
