"""Scenes, frozen: the editor's hex lattice, the dense crystal, the grid pick
and the bucketize.

Copies made for the benchmark, so that a later change to the port cannot
move what the benchmark sends or checks against:

- ``hex_lattice``: the editor's "Hexagonal Square" preset (upstream
  ``particle_io/src/presets.rs`` ``hex_square``; the port's
  ``io/presets.py``), centred in the box, velocity directions from the seed;
- ``dense_grid_config`` and ``dense_crystal``: the port bench's dense scene
  (``bench.py:dense_grid_config``, ``dense_grid_scene``), drawn from the
  seed on the device in a few large calls;
- ``grid_for`` and ``bucketize``: the engine's density-aware grid pick and
  the host bucketize (``engine/simulator.py:_grid_for``,
  ``physics/bucket.py:bucketize_numpy``), which the reference uses to lay
  out a scene it was sent.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from psbench import wire

U32_MAX = 0xFFFFFFFF


class Grid(NamedTuple):
    """A bucket grid: 2^by_log2 rows x 2^bx_log2 columns of ``cap`` slots,
    rebucketed every ``move_every`` steps."""

    bx_log2: int
    by_log2: int
    cap: int
    move_every: int = 16

    @property
    def bx(self) -> int:
        return 1 << self.bx_log2

    @property
    def by(self) -> int:
        return 1 << self.by_log2

    @property
    def buckets(self) -> int:
        return self.bx * self.by

    @property
    def capacity(self) -> int:
        return self.buckets * self.cap


BASE_GRID = Grid(6, 6, 16)  # the engine's starting grid


def lattice_metadata(cfg: dict) -> np.ndarray:
    """The metadata the editor sends for configuration ``cfg``: the
    default species, the box of ``box_sides_r0`` equilibrium distances of
    species 0, ``step_dt`` and ``steps_per_frame``, the cursor off."""
    meta = wire.default_metadata()
    r0 = wire.force0_r(wire.NITROGEN)
    box = cfg["box_sides_r0"] * r0
    meta["box_width"] = box
    meta["box_height"] = box
    meta["step_dt"] = cfg["step_dt"]
    meta["steps_per_frame"] = cfg["steps_per_frame"]
    return meta


def hex_lattice(cfg: dict, seed: int, drop: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(particles, metadata) of the editor's hex lattice of configuration
    ``cfg``: ``n_side`` x ``n_side`` at ``distance_factor`` equilibrium
    distances of species 0, centred in the box, speeds uniform in
    ``velocity`` with directions from ``seed``; the last ``drop`` particles
    left out."""
    meta = lattice_metadata(cfg)
    nx = ny = int(cfg["n_side"])
    rng = np.random.default_rng(seed)
    species = tuple(float(v) for v in meta["particles"][0].tolist())
    rx = wire.force0_r(species) * float(cfg["distance_factor"])
    ry = math.sin(math.pi / 3.0) * rx
    box_w, box_h = float(meta["box_width"]), float(meta["box_height"])
    x0 = box_w / 2 - rx * (nx - 1) / 2.0
    y0 = box_h / 2 - ry * (ny - 1) / 2.0
    ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    ix, iy = ix.ravel(), iy.ravel()
    xs = x0 + rx * ix + np.where(iy % 2 == 0, 0.0, rx / 2.0)
    ys = y0 + ry * iy
    lo, hi = cfg["velocity"]
    n = nx * ny
    speed = rng.uniform(lo, hi, size=n) if hi > lo else np.full(n, lo)
    angle = rng.uniform(0.0, 2.0 * math.pi, size=n)
    parts = np.zeros(n, dtype=wire.PARTICLE_DTYPE)
    parts["x"] = np.round(U32_MAX * xs / box_w).astype(np.int64).astype(np.uint32)
    parts["y"] = np.round(U32_MAX * ys / box_h).astype(np.int64).astype(np.uint32)
    parts["vx"] = np.sin(angle) * speed
    parts["vy"] = np.cos(angle) * speed
    parts["ty"] = 0
    return (parts[:n - drop] if drop else parts), meta


def grid_for(live: np.ndarray, box_w: float, box_h: float, r0: float,
             base: Grid = BASE_GRID) -> Grid:
    """The engine's grid pick: grow the grid until the fullest bucket fits,
    never below buckets of ~2 r0 (past that floor grow the capacity, up to
    256); then halve the capacity while splitting the wider side as long as
    the scene fits and buckets stay >= 2 r0; then halve it in place while
    the occupancy leaves 2x headroom."""
    def max_occupancy(c: Grid) -> int:
        bx = (live["x"] >> np.uint32(32 - c.bx_log2)).astype(np.int64)
        by = (live["y"] >> np.uint32(32 - c.by_log2)).astype(np.int64)
        return int(np.bincount(by * c.bx + bx, minlength=c.buckets).max())

    def grown(c: Grid) -> Grid:
        return Grid(c.bx_log2 + 1, c.by_log2 + 1, c.cap, c.move_every)

    cfg = base
    while cfg.capacity < len(live):
        cfg = grown(cfg)
    if len(live) == 0:
        return cfg
    while max_occupancy(cfg) > cfg.cap:
        if min(box_w / cfg.bx, box_h / cfg.by) / 2.0 >= 2.0 * r0:
            cfg = grown(cfg)
        elif cfg.cap < 256:
            cfg = Grid(cfg.bx_log2, cfg.by_log2, cfg.cap * 2, cfg.move_every)
        else:
            break
    while cfg.cap > 8:
        if box_w / cfg.bx >= box_h / cfg.by:
            finer = Grid(cfg.bx_log2 + 1, cfg.by_log2, cfg.cap // 2, cfg.move_every)
            side = box_w / finer.bx
        else:
            finer = Grid(cfg.bx_log2, cfg.by_log2 + 1, cfg.cap // 2, cfg.move_every)
            side = box_h / finer.by
        if side < 2.0 * r0 or max_occupancy(finer) > finer.cap:
            break
        cfg = finer
    while cfg.cap > 8 and 2 * max_occupancy(cfg) <= cfg.cap // 2:
        cfg = Grid(cfg.bx_log2, cfg.by_log2, cfg.cap // 2, cfg.move_every)
    return cfg


def scene_grid(parts: np.ndarray, meta: np.ndarray) -> Grid:
    """The grid the engine picks for a scene it is sent."""
    live = parts[parts["ty"] >= 0]
    species = tuple(float(v) for v in meta["particles"][0].tolist())
    return grid_for(live, float(meta["box_width"]), float(meta["box_height"]),
                    wire.force0_r(species))


def bucketize(parts: np.ndarray, g: Grid) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(live particles kept, bucket id, slot) of a scene laid out on ``g``:
    bucket ids row-major from the coordinates' top bits, slots in the order
    sent, overflow past ``cap`` dropped."""
    live = parts[parts["ty"] >= 0]
    bucket = ((live["x"] >> np.uint32(32 - g.bx_log2)).astype(np.int64)
              + (live["y"] >> np.uint32(32 - g.by_log2)).astype(np.int64) * g.bx)
    order = np.argsort(bucket, kind="stable")
    sorted_b = bucket[order]
    rank = np.arange(len(sorted_b)) - np.searchsorted(sorted_b, sorted_b)
    keep = rank < g.cap
    return live[order][keep], sorted_b[keep], rank[keep]


def dense_grid_config(particles: int, fill: int = 8) -> Grid:
    """The smallest power-of-two grid holding ``particles`` at ``fill`` a
    bucket, rows and columns grown in turns from 4 x 4, rows first."""
    kx = ky = 2
    while (1 << (kx + ky)) * fill < particles:
        if kx == ky:
            ky += 1
        else:
            kx += 1
    return Grid(kx, ky, fill)


def _u32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 tensor of their u32 bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def dense_metadata(g: Grid, step_dt: float, fill: int | None = None) -> np.ndarray:
    """The dense scene's metadata: the defaults, a box of ``fill/2`` hex
    columns (2 hex rows; 4 rows past a fill of 8) of r0 a bucket,
    ``step_dt``."""
    fill = g.cap if fill is None else fill
    rows = 2 if fill <= 8 else 4
    d = wire.force0_r(wire.NITROGEN)
    meta = wire.default_metadata()
    meta["box_width"] = float(g.bx * (fill // rows) * d)
    meta["box_height"] = float(g.by * rows * (math.sqrt(3.0) / 2.0) * d)
    meta["step_dt"] = step_dt
    return meta


def dense_crystal(g: Grid, seed: int, step_dt: float, device,
                  fill: int | None = None) -> tuple[tuple, np.ndarray, int]:
    """The dense bench scene on grid ``g``: every interior bucket holds
    ``fill`` (default ``cap``) particles in its first slots, on a
    bucket-aligned hex lattice at r0 of species 0 (2 hex rows of fill/2 a
    bucket), jittered by 1% of r0, speeds N(0, 1 m/s) a component, the
    outer bucket ring empty; drawn from ``seed`` on ``device``. Returns
    ((x, y, vx, vy, ty) tensors of shape (BY, BX, CAP), x/y the int32 bits
    of the u32 positions; metadata; live count)."""
    fill = g.cap if fill is None else fill
    rows = 2 if fill <= 8 else 4
    if fill % rows or fill > g.cap:
        raise ValueError(f"fill {fill} does not split into {rows} hex rows of a cap-{g.cap} grid")
    cols = fill // rows
    d = wire.force0_r(wire.NITROGEN)
    meta = dense_metadata(g, step_dt, fill)
    box_w, box_h = float(meta["box_width"]), float(meta["box_height"])
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    f64 = dict(dtype=torch.float64, device=device)
    gy = torch.arange(g.by, **f64)[:, None, None]
    gx = torch.arange(g.bx, **f64)[None, :, None]
    gs = torch.arange(fill, **f64)[None, None, :]
    ixg = gx * cols + torch.remainder(gs, cols)
    iyg = gy * rows + torch.div(gs, cols, rounding_mode="floor")
    shape = (g.by, g.bx, fill)
    jitter = torch.rand((2, *shape), generator=gen, **f64) * 0.02 - 0.01
    vel = torch.randn((2, *shape), generator=gen, **f64).to(torch.float32)
    px = (ixg + 0.5 * torch.remainder(iyg, 2) + 0.25) * d + jitter[0] * d
    py = (iyg + 0.5) * (math.sqrt(3.0) / 2.0) * d + jitter[1] * d
    x = _u32_bits(torch.clamp(px / box_w * 2**32, 0, 2**32 - 1).to(torch.int64))
    y = _u32_bits(torch.clamp(py / box_h * 2**32, 0, 2**32 - 1).to(torch.int64))
    interior = torch.zeros((g.by, g.bx, 1), dtype=torch.bool, device=device)
    interior[1:-1, 1:-1] = True
    interior = interior.expand(shape)
    zero_i = torch.zeros((), dtype=torch.int32, device=device)
    zero_f = torch.zeros((), dtype=torch.float32, device=device)
    state = (torch.where(interior, x, zero_i), torch.where(interior, y, zero_i),
             torch.where(interior, vel[0], zero_f), torch.where(interior, vel[1], zero_f),
             torch.where(interior, 0, -1).to(torch.int32))
    pad = (0, g.cap - fill)
    state = tuple(torch.nn.functional.pad(a, pad, value=-1 if k == 4 else 0)
                  for k, a in enumerate(state))
    return tuple(a.contiguous() for a in state), meta, (g.by - 2) * (g.bx - 2) * fill
