"""Throughput meter of the engine daemon.

Counterpart of ``particle_simulator_tpu/utils/profiling.py``; only
``StepMeter`` is ported (the JAX module's trace helpers wrap
``jax.profiler``; ``torch.profiler`` takes their place where needed).
"""

from __future__ import annotations

import time


class StepMeter:
    """Exponentially smoothed steps/sec + particle-steps/sec meter."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self._last: float | None = None
        self.steps_per_sec = 0.0
        self.particle_steps_per_sec = 0.0
        self.total_steps = 0

    def tick(self, steps: int, particles: int) -> None:
        """Record that ``steps`` physics steps over ``particles`` particles
        just completed."""
        now = time.perf_counter()
        self.total_steps += steps
        if self._last is not None:
            dt = now - self._last
            if dt > 0:
                inst = steps / dt
                self.steps_per_sec += self.alpha * (inst - self.steps_per_sec)
                self.particle_steps_per_sec += self.alpha * (
                    inst * particles - self.particle_steps_per_sec
                )
        self._last = now

    def report(self) -> dict:
        return {
            "steps_per_sec": round(self.steps_per_sec, 2),
            "particle_steps_per_sec": round(self.particle_steps_per_sec, 1),
            "total_steps": self.total_steps,
        }
