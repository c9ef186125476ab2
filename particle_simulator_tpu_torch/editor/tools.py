"""Scene-editing tools: brush, eraser, speed, clear.

Functional equivalent of the reference editor's drawing logic
(particle_editor/src/editor.rs:481-738): a freehand stroke is rasterized onto
a boolean grid at **lattice resolution** (cell size = equilibrium distance *
distance_factor, so drawn particles land on the same lattice the presets use;
editor.rs:468-479), then the active tool consumes the cells:

- **Brush**: spawn one particle per covered cell (hex row offset optional),
  with optional random velocity direction (editor.rs brush arm);
- **Eraser**: remove particles inside the stroke's covered cells
  (swap-remove within the stroke AABB in the reference; order-preserving
  here — order is not observable through the wire protocol);
- **Speed**: set the velocity of particles inside the stroke, either at a
  fixed angle or a random angle per particle (the editing toolbar's angle
  knob / random toggle, editor.rs:1443-1607);
- **Clear**: wipe all particles (the C shortcut / clear tool).

All functions edit a Frame in place. Coordinates are meters in box space.
The port's own copy of ``particle_simulator_tpu/editor/tools.py``: the same
frame, stroke, options and generator state give the same bytes.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import numpy as np

from particle_simulator_tpu_torch.io.frame import Frame, PARTICLE_DTYPE, U32_MAX


class Tool(enum.Enum):
    BRUSH = "brush"
    ERASER = "eraser"
    SPEED = "speed"
    CLEAR = "clear"


class LatticeKind(enum.Enum):
    SQUARE = "square"
    HEX = "hex"  # the toolbar's "Lettuce" grid toggle


@dataclasses.dataclass
class Stroke:
    """A freehand stroke: polyline of (x, y) points in meters, with a
    width/height footprint (the toolbar's stroke w x h, editor.rs:1443)."""

    points: list[tuple[float, float]]
    width: float  # meters
    height: float  # meters


@dataclasses.dataclass
class ToolOptions:
    tool: Tool = Tool.BRUSH
    distance_factor: float = 1.0
    lattice: LatticeKind = LatticeKind.HEX
    velocity: float = 0.0  # magnitude for brush random vel / speed tool
    angle: Optional[float] = None  # None = random angle; radians otherwise
    species: int = 0
    ty: int = 0


def lattice_resolution(frame: Frame, options: ToolOptions) -> tuple[float, float]:
    """Cell size of the drawing grid: the lattice spacing (editor.rs:468-479
    ties stroke resolution to max_particles_in_box = box / (force0_r * df))."""
    meta = frame.metadata
    rx = meta.species(options.species).force0_r() * options.distance_factor
    ry = math.sin(math.pi / 3.0) * rx if options.lattice == LatticeKind.HEX else rx
    return rx, ry


def rasterize_stroke(frame: Frame, stroke: Stroke, options: ToolOptions) -> np.ndarray:
    """Boolean grid of lattice cells covered by the stroke.

    Returns a structured bool array over the full box at lattice resolution
    (shape (ny, nx), cell (iy, ix) covers [ix*rx, (ix+1)*rx) etc.). The stroke
    covers every cell whose center lies within width/2 (height/2) of any
    stroke segment (rectangle-capsule rasterization).
    """
    meta = frame.metadata
    rx, ry = lattice_resolution(frame, options)
    nx = max(1, int(meta.box_width / rx))
    ny = max(1, int(meta.box_height / ry))
    grid = np.zeros((ny, nx), dtype=bool)
    if not stroke.points:
        return grid

    half_w = stroke.width / 2.0
    half_h = stroke.height / 2.0
    cx = (np.arange(nx) + 0.5) * rx
    cy = (np.arange(ny) + 0.5) * ry

    pts = stroke.points if len(stroke.points) > 1 else stroke.points * 2
    for (x0, y0), (x1, y1) in zip(pts[:-1], pts[1:]):
        # cells whose center is within the elliptical brush of any point on
        # the segment: sample the segment at sub-cell resolution
        seg_len = math.hypot(x1 - x0, y1 - y0)
        steps = max(1, int(seg_len / (min(rx, ry) * 0.5)) + 1)
        for s in range(steps + 1):
            t = s / steps
            px = x0 + (x1 - x0) * t
            py = y0 + (y1 - y0) * t
            ix_lo = max(0, int((px - half_w) / rx))
            ix_hi = min(nx - 1, int((px + half_w) / rx))
            iy_lo = max(0, int((py - half_h) / ry))
            iy_hi = min(ny - 1, int((py + half_h) / ry))
            if ix_hi < ix_lo or iy_hi < iy_lo:
                continue
            sub_x = cx[ix_lo : ix_hi + 1]
            sub_y = cy[iy_lo : iy_hi + 1]
            mask = (np.abs(sub_x[None, :] - px) <= half_w) & (
                np.abs(sub_y[:, None] - py) <= half_h
            )
            grid[iy_lo : iy_hi + 1, ix_lo : ix_hi + 1] |= mask
    return grid


def _cells_to_positions(grid: np.ndarray, frame: Frame, options: ToolOptions):
    """Lattice positions (meters) of the covered cells, hex offset applied."""
    rx, ry = lattice_resolution(frame, options)
    iy, ix = np.nonzero(grid)
    xs = (ix + 0.5) * rx
    if options.lattice == LatticeKind.HEX:
        xs = xs + np.where(iy % 2 == 1, rx / 2.0, 0.0)
    ys = (iy + 0.5) * ry
    return xs, ys


def _velocities(n: int, options: ToolOptions, rng: np.random.Generator) -> np.ndarray:
    v = float(options.velocity)
    if options.angle is None:
        angle = rng.uniform(0.0, 2.0 * math.pi, size=n)
    else:
        angle = np.full(n, float(options.angle))
    return np.stack([np.sin(angle) * v, np.cos(angle) * v], axis=-1).astype(np.float32)


def _particle_cells(frame: Frame, shape: tuple[int, int], options: ToolOptions):
    """(ix, iy) lattice cell of each particle — the inverse of
    ``_cells_to_positions``, including the hex odd-row x offset so spawned
    particles map back to their own cell."""
    meta = frame.metadata
    rx, ry = lattice_resolution(frame, options)
    ny, nx = shape
    parts = frame.particles
    px = parts["x"].astype(np.float64) / U32_MAX * meta.box_width
    py = parts["y"].astype(np.float64) / U32_MAX * meta.box_height
    iy = np.clip((py / ry).astype(int), 0, ny - 1)
    if options.lattice == LatticeKind.HEX:
        px = px - np.where(iy % 2 == 1, rx / 2.0, 0.0)
    ix = np.clip((px / rx).astype(int), 0, nx - 1)
    return ix, iy


def _particles_in_cells(frame: Frame, grid: np.ndarray, options: ToolOptions) -> np.ndarray:
    """Boolean mask over frame.particles: inside a covered cell."""
    ix, iy = _particle_cells(frame, grid.shape, options)
    return grid[iy, ix] & (frame.particles["ty"] >= 0)


def apply_stroke(
    frame: Frame,
    stroke: Stroke,
    options: ToolOptions,
    rng: Optional[np.random.Generator] = None,
) -> int:
    """Apply the active tool along the stroke; returns particles affected."""
    rng = rng or np.random.default_rng()
    if options.tool == Tool.CLEAR:
        n = frame.particle_count
        frame.clear()
        return n

    grid = rasterize_stroke(frame, stroke, options)

    if options.tool == Tool.BRUSH:
        # only spawn in cells not already occupied (the reference rasterizes
        # existing particles into the same grid before spawning)
        occupied = np.zeros_like(grid)
        live = frame.particles["ty"] >= 0
        if live.any():
            ix, iy = _particle_cells(frame, grid.shape, options)
            occupied[iy[live], ix[live]] = True
        spawn = grid & ~occupied
        xs, ys = _cells_to_positions(spawn, frame, options)
        vels = _velocities(len(xs), options, rng)
        meta = frame.metadata
        new = np.zeros(len(xs), dtype=PARTICLE_DTYPE)
        new["x"] = np.round(U32_MAX * xs / meta.box_width).astype(np.int64).astype(np.uint32)
        new["y"] = np.round(U32_MAX * ys / meta.box_height).astype(np.int64).astype(np.uint32)
        new["vx"] = vels[:, 0]
        new["vy"] = vels[:, 1]
        new["ty"] = options.ty
        frame.extend(new)
        return len(new)

    mask = _particles_in_cells(frame, grid, options)
    n = int(np.count_nonzero(mask))
    if options.tool == Tool.ERASER:
        kept = frame.particles[~mask].copy()
        frame.clear()
        frame.extend(kept)
    elif options.tool == Tool.SPEED:
        vels = _velocities(n, options, rng)
        parts = frame.particles
        parts["vx"][mask] = vels[:, 0]
        parts["vy"][mask] = vels[:, 1]
    return n
