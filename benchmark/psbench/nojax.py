"""The check that a process loaded nothing of JAX or of the JAX package.

Each loaded module's top-level name (the part before the first dot) is
compared whole: ``particle_simulator_tpu_torch`` begins with
``particle_simulator_tpu`` and is allowed.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "particle_simulator_tpu")


def foreign_modules() -> list[str]:
    """The loaded modules whose top-level name is a forbidden one."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)
