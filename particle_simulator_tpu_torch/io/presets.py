"""Scene generators and saved presets.

Copy of ``particle_simulator_tpu/io/presets.py`` for the port.

Mirrors the reference's ``particle_io::presets`` (particle_io/src/presets.rs):
hex/square lattice generators with randomized velocity directions, and named
preset snapshots (box + species params + particle list) convertible to/from
frames.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from particle_simulator_tpu_torch.io.frame import (
    Frame,
    PARTICLE_DTYPE,
    U32_MAX,
)


@dataclasses.dataclass
class ParticleLattice:
    """Lattice generator (reference: particle_io/src/presets.rs:6-82).

    Spacing between particles = species equilibrium distance * distance_factor.
    Velocities have magnitude uniform in ``velocity`` and a random direction.
    """

    particle_count: tuple[int, int]
    distance_factor: float = 1.0
    velocity: tuple[float, float] = (0.0, 0.0)

    def _random_vels(self, n: int, rng: np.random.Generator) -> np.ndarray:
        lo, hi = self.velocity
        v = rng.uniform(lo, hi, size=n) if hi > lo else np.full(n, lo)
        angle = rng.uniform(0.0, 2.0 * math.pi, size=n)
        # Rust uses sin_cos -> (sin, cos) as the (x, y) direction.
        return np.stack([np.sin(angle) * v, np.cos(angle) * v], axis=-1)

    def _emit(self, frame: Frame, xs, ys, vels, ty: int) -> None:
        meta = frame.metadata
        parts = np.zeros(len(xs), dtype=PARTICLE_DTYPE)
        parts["x"] = (
            np.round(U32_MAX * np.asarray(xs, dtype=np.float64) / meta.box_width)
            .astype(np.int64)
            .astype(np.uint32)
        )
        parts["y"] = (
            np.round(U32_MAX * np.asarray(ys, dtype=np.float64) / meta.box_height)
            .astype(np.int64)
            .astype(np.uint32)
        )
        parts["vx"] = vels[:, 0]
        parts["vy"] = vels[:, 1]
        parts["ty"] = ty
        frame.extend(parts)

    def hex_square(
        self,
        frame: Frame,
        center: tuple[float, float],
        species: int = 0,
        ty: int = 0,
        rng: Optional[np.random.Generator] = None,
    ) -> None:
        """Hexagonal lattice: odd rows offset by rx/2, row spacing sin(60 deg)*rx."""
        nx, ny = self.particle_count
        n = nx * ny
        if n == 0:
            return
        rng = rng or np.random.default_rng()
        meta = frame.metadata

        rx = meta.species(species).force0_r() * float(self.distance_factor)
        ry = math.sin(math.pi / 3.0) * rx
        x0 = center[0] - rx * (nx - 1) / 2.0
        y0 = center[1] - ry * (ny - 1) / 2.0

        ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        ix, iy = ix.ravel(), iy.ravel()
        offset = np.where(iy % 2 == 0, 0.0, rx / 2.0)
        xs = x0 + rx * ix + offset
        ys = y0 + ry * iy
        self._emit(frame, xs, ys, self._random_vels(n, rng), ty)

    def square(
        self,
        frame: Frame,
        center: tuple[float, float],
        species: int = 0,
        ty: int = 0,
        rng: Optional[np.random.Generator] = None,
    ) -> None:
        nx, ny = self.particle_count
        n = nx * ny
        if n == 0:
            return
        rng = rng or np.random.default_rng()
        meta = frame.metadata

        r = meta.species(species).force0_r() * float(self.distance_factor)
        x0 = center[0] - r * (nx - 1) / 2.0
        y0 = center[1] - r * (ny - 1) / 2.0

        ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        xs = x0 + r * ix.ravel()
        ys = y0 + r * iy.ravel()
        self._emit(frame, xs, ys, self._random_vels(n, rng), ty)


@dataclasses.dataclass
class Preset:
    """Named scene snapshot (reference: particle_io/src/presets.rs:84-120)."""

    name: str
    box_size: tuple[float, float]
    species: np.ndarray  # METADATA particles field, shape (2,)
    particles: np.ndarray  # PARTICLE_DTYPE array

    def to_frame(self) -> Frame:
        frame = Frame.new()
        meta = frame.metadata
        meta.box_width, meta.box_height = self.box_size
        meta.record["particles"] = self.species
        frame.extend(self.particles)
        return frame

    @staticmethod
    def from_frame(name: str, frame: Frame) -> "Preset":
        meta = frame.metadata
        return Preset(
            name=name,
            box_size=(meta.box_width, meta.box_height),
            species=meta.record["particles"].copy(),
            particles=frame.particles.copy(),
        )


class Presets:
    """A CRUD list of presets (reference: particle_io/src/presets.rs:122-154),
    with on-disk persistence — the reference keeps presets in the editor's GUI
    storage; here each preset serializes as a wire-format frame file (the same
    codec as the transport), so presets double as replayable scene files."""

    def __init__(self):
        self._presets: list[Preset] = []

    def __len__(self) -> int:
        return len(self._presets)

    def __getitem__(self, i: int) -> Preset:
        return self._presets[i]

    def __iter__(self):
        return iter(self._presets)

    def add(self, preset: Preset) -> None:
        self._presets.append(preset)

    def delete(self, i: int) -> None:
        del self._presets[i]

    def replace(self, preset: Preset, i: int) -> None:
        if i < len(self._presets):
            self._presets[i] = preset

    # -- persistence -----------------------------------------------------------
    def serialize_dir(self) -> list:
        """``[(filename, wire bytes)]`` for every preset — the in-memory half
        of ``save_dir``, separable so a caller can snapshot under its lock and
        do the (slow) disk write outside it."""
        import re

        out = []
        for i, preset in enumerate(self._presets):
            safe = re.sub(r"[^A-Za-z0-9_.-]", "_", preset.name) or "preset"
            out.append((f"{i:03d}__{safe}.frame", preset.to_frame().bytes))
        return out

    @staticmethod
    def write_dir(directory, payloads) -> None:
        """Write serialized presets as ``<index>__<name>.frame`` files.

        Each file lands via write-to-temp + ``os.replace`` and stale files are
        unlinked only AFTER the new set is on disk, so a crash mid-save leaves
        a loadable mix of old and new presets instead of an empty directory."""
        import os

        os.makedirs(directory, exist_ok=True)
        keep = set()
        for fname, data in payloads:
            path = os.path.join(directory, fname)
            tmp = path + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(data)
            os.replace(tmp, path)
            keep.add(fname)
        for f in os.listdir(directory):
            # also sweep .frame.tmp orphans from a crash between open(tmp)
            # and os.replace — they would otherwise accumulate forever
            if (f.endswith(".frame") and f not in keep) or f.endswith(".frame.tmp"):
                os.unlink(os.path.join(directory, f))

    def save_dir(self, directory) -> None:
        """Write every preset as ``<index>__<name>.frame`` wire packets."""
        self.write_dir(directory, self.serialize_dir())

    @staticmethod
    def load_dir(directory) -> "Presets":
        import os

        presets = Presets()
        if not os.path.isdir(directory):
            return presets
        for fname in sorted(os.listdir(directory)):
            if not fname.endswith(".frame"):
                continue
            name = fname[:-6].split("__", 1)[-1]
            with open(os.path.join(directory, fname), "rb") as fh:
                frame = Frame.from_bytes(fh.read())
            presets.add(Preset.from_frame(name, frame))
        return presets
