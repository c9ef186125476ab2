"""Scene builders: the repo's phase configurations as wire frames.

Counterpart of the builders of ``particle_simulator_tpu/scenes/library.py``
(the headless runner with ``--render``/``--gif`` is not ported yet, see
ROADMAP.md). Phase is set by lattice spacing (potential energy) and initial
speed (kinetic energy / temperature); boxes are sized to the particle count,
so density, not count, selects the phase. The same arguments give the same
bytes as the JAX package's builders (``tests/test_torch_io.py``).
"""

from __future__ import annotations

import numpy as np

from particle_simulator_tpu_torch.io.frame import Frame, MieParams
from particle_simulator_tpu_torch.io.presets import ParticleLattice

# leapfrog stability envelope: dt = 10 fs is stable long-horizon; the 50 fs
# default is only safe for sparse scenes
STABLE_DT = 10e-15


def _scene(
    nx: int,
    ny: int,
    distance_factor: float,
    speed: float,
    box_fill: float = 0.5,
    dt: float = STABLE_DT,
    steps_per_frame: int = 100,
    seed: int = 0,
) -> Frame:
    """Lattice scene centered in a square box whose side is the lattice's
    longer span over ``box_fill``."""
    frame = Frame.new()
    meta = frame.metadata
    r0 = MieParams.nitrogen().force0_r()
    span = max(nx, ny) * r0 * distance_factor
    box = span / box_fill
    meta.box_width = box
    meta.box_height = box
    meta.step_dt = dt
    meta.steps_per_frame = steps_per_frame
    lat = ParticleLattice((nx, ny), distance_factor=distance_factor, velocity=(0.0, speed))
    lat.hex_square(frame, (box / 2, box / 2), rng=np.random.default_rng(seed))
    return frame


def liquid_droplet(n_side: int = 45) -> Frame:
    """~2k-particle droplet: near-equilibrium spacing, warm enough to flow."""
    return _scene(n_side, n_side, distance_factor=1.1, speed=80.0, box_fill=0.45)


def gas_diffusion(n_side: int = 128) -> Frame:
    """16k-particle gas: sparse start, hot; the particles fill the box."""
    return _scene(n_side, n_side, distance_factor=2.5, speed=400.0, box_fill=0.7)


def solid_crystal(n_side: int = 256) -> Frame:
    """64k-particle crystal: equilibrium spacing, cold; the hex lattice holds."""
    return _scene(n_side, n_side, distance_factor=1.0, speed=5.0, box_fill=0.6)


SCENES = {
    "liquid_droplet": liquid_droplet,
    "gas_diffusion": gas_diffusion,
    "solid_crystal": solid_crystal,
}
