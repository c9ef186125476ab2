"""Forces shared by every data-structure path.

Counterpart of ``particle_simulator_tpu/physics/step.py``; only
``external_forces`` is ported so far (the all-pairs CompactArray path is
queued in ROADMAP.md).
"""

from __future__ import annotations

import torch

from particle_simulator_tpu_torch.engine.state import ParticleState
from particle_simulator_tpu_torch.physics.mie import cursor_force, wall_force


def external_forces(state: ParticleState, params: torch.Tensor):
    """Cursor repulsion + wall forces on every slot."""
    fcx, fcy = cursor_force(state.x, state.y, params)
    fwx, fwy = wall_force(state.x, state.y, params)
    return fcx + fwx, fcy + fwy
